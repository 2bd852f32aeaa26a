"""The small host pieces of training on the port against the JAX
package's, on the CPU: the gamma-decayed flow loss, the bidirectional
occlusion mask, the flip-augmented pair loader and the centre crop, the
``.flo`` files and the pair + flow loader, the padding and overlay helpers,
and the alternate conv blocks of ``models/common.py``.

Host helpers are held bit-equal; tensor ops at the tolerance of
tests/test_torch_layers.py (rtol 1e-4, atol 1e-4).
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests import torch_helpers as th

TOL = dict(rtol=1e-4, atol=1e-4)


def test_unsup_flow_loss_decay_matches_jax():
    """Three pyramid levels, so the decayed weights gamma^2, gamma, 1 all
    count; value and the mean |flow| of level 0."""
    from emip_tpu.losses.flow import unsup_flow_loss_decay as jax_decay

    from emip_tpu_torch.losses import unsup_flow_loss_decay

    rng = np.random.default_rng(4)
    im1 = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    im2 = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    flows = [tuple((rng.standard_normal((2, h, h, 2)) * 2).astype(np.float32)
                   for _ in range(2)) for h in (16, 8, 4)]
    for gamma in (0.8, 0.5):
        want = jax.jit(lambda f, g=gamma: jax_decay(f, im1, im2, g))(
            [tuple(map(jnp.asarray, p)) for p in flows])
        got = unsup_flow_loss_decay(
            [tuple(map(torch.from_numpy, p)) for p in flows],
            torch.from_numpy(im1), torch.from_numpy(im2), gamma)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_occlusion_mask_bidirection_matches_jax():
    """Equal bits wherever the consistency test is not within rounding of
    its threshold; a fraction of the pixels is occluded."""
    from emip_tpu.ops.warp import flow_warp_loss as jax_warp
    from emip_tpu.ops.warp import occlusion_mask_bidirection as jax_occ

    from emip_tpu_torch.ops.warp import occlusion_mask_bidirection

    rng = np.random.default_rng(5)
    f12 = (rng.standard_normal((2, 12, 14, 2)) * 2).astype(np.float32)
    f21 = (-f12 + rng.standard_normal(f12.shape) * 0.8).astype(np.float32)
    got = occlusion_mask_bidirection(torch.from_numpy(f12),
                                     torch.from_numpy(f21)).numpy()
    want = np.asarray(jax_occ(f12, f21))
    w21 = np.asarray(jax_warp(f21, f12, pad="zeros"))
    margin = (((f12 + w21) ** 2).sum(-1, keepdims=True)
              - 0.01 * ((f12 ** 2).sum(-1, keepdims=True)
                        + (w21 ** 2).sum(-1, keepdims=True)) - 0.5)
    away = np.abs(margin) > 1e-4
    assert got.shape == want.shape == (2, 12, 14, 1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[away], want[away])
    assert 0.05 < want.mean() < 0.95


def test_pair_loader_with_flips_matches_jax(tmp_path):
    """``PairTrainLoader(flip_augment=True)``: two epochs of batches equal
    bit for bit to the JAX loader's."""
    from emip_tpu.data.pipeline import PairTrainLoader as JaxLoader

    from emip_tpu_torch.data import PairTrainLoader, make_synthetic_video_root

    root = make_synthetic_video_root(str(tmp_path / "d"), num_videos=2,
                                     frames_per_video=4, size=(56, 64))
    kw = dict(batch_size=2, size=40, seed=3, augment=True, flip_augment=True)
    port, ref = PairTrainLoader(root, root, **kw), JaxLoader(root, root, **kw)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("name", ["hflip", "vflip", "random_crop"])
def test_joint_augmentations_match_jax(name):
    import emip_tpu.data.augment as aug

    import emip_tpu_torch.data as data

    rng = np.random.default_rng(8)
    for w, h in ((64, 48), (20, 31)):
        ims = [Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)),
               Image.fromarray(rng.integers(0, 255, (h, w), np.uint8))]
        for seed in range(6):
            got = getattr(data, f"_joint_{name}")(random.Random(seed), ims)
            want = getattr(aug, f"joint_{name}")(random.Random(seed), ims)
            for g, wi in zip(got, want):
                assert g.size == wi.size and g.mode == wi.mode
                np.testing.assert_array_equal(np.asarray(g), np.asarray(wi))


def test_flo_files_and_pair_flow_loader_match_jax(tmp_path):
    """``.flo`` written by either package reads back equal in both; the
    pair + flow loader yields the JAX loader's records (a ``.flo``, a
    colour-wheel JPG, a pair without flow)."""
    from emip_tpu.data.flow_files import PairFlowLoader as JaxLoader
    from emip_tpu.data.flow_files import read_flo as jax_read
    from emip_tpu.data.flow_files import write_flo as jax_write

    from emip_tpu_torch.data import (
        PairFlowLoader,
        make_synthetic_video_root,
        read_flo,
        write_flo,
    )

    rng = np.random.default_rng(9)
    flow = rng.standard_normal((7, 5, 2)).astype(np.float32)
    write_flo(str(tmp_path / "a.flo"), flow)
    jax_write(str(tmp_path / "b.flo"), flow)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo"
                                                 ).read_bytes()
    np.testing.assert_array_equal(read_flo(str(tmp_path / "b.flo")), flow)
    np.testing.assert_array_equal(jax_read(str(tmp_path / "a.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        read_flo(str(tmp_path / "bad.flo"))

    root = make_synthetic_video_root(str(tmp_path / "d"), num_videos=1,
                                     frames_per_video=4, size=(56, 64))
    fdir = os.path.join(root, "video_00", "Flow")
    os.makedirs(fdir)
    write_flo(os.path.join(fdir, "00000.flo"),
              rng.standard_normal((56, 64, 2)).astype(np.float32))
    Image.fromarray(rng.integers(0, 255, (56, 64, 3), np.uint8)).save(
        os.path.join(fdir, "00001.jpg"))
    got = list(PairFlowLoader(root, root, size=32))
    want = list(JaxLoader(root, root, size=32))
    assert len(got) == len(want) == 3
    assert ["flow" in r for r in got] == [True, False, False]
    assert ["flow_rgb" in r for r in got] == [False, True, False]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_pad_divide_by_and_overlay_match_jax():
    from emip_tpu.utils.overlay import overlay_davis as jax_overlay
    from emip_tpu.utils.overlay import pad_divide_by as jax_pad

    from emip_tpu_torch.utils.overlay import overlay_davis, pad_divide_by

    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3, 13, 22)).astype(np.float32)
    for d in (4, 16):
        (got,), pad = pad_divide_by([torch.from_numpy(x)], d, (13, 22))
        (want,), jpad = jax_pad([x.transpose(0, 2, 3, 1)], d, (13, 22))
        assert pad == jpad
        np.testing.assert_array_equal(th.nhwc(got), want)
    image = rng.integers(0, 255, (20, 24, 3), np.uint8)
    mask = np.zeros((20, 24), np.int64)
    mask[3:9, 4:12] = 1
    mask[12:18, 14:20] = 2
    for colors in ((255, 0, 0), [(0, 200, 0), (10, 20, 30), (5, 5, 90)]):
        np.testing.assert_array_equal(
            overlay_davis(image, mask, colors=colors),
            jax_overlay(image, mask, colors=colors))


def _flax_conv(k):
    from emip_tpu_torch.convert import _conv

    return torch.from_numpy(_conv(k))


@pytest.mark.parametrize("relu,train,stride", [(False, False, 1),
                                               (True, False, 2),
                                               (True, True, 1)])
def test_basic_conv2d_matches_flax(relu, train, stride):
    from emip_tpu.models.common import BasicConv2d as JaxBlock

    from emip_tpu_torch.models.common import BasicConv2d

    x = np.random.default_rng(11).standard_normal((2, 12, 12, 6)).astype(
        np.float32)
    jm = JaxBlock(10, 3, stride=stride, padding=2, dilation=2,
                  with_relu=relu)
    v = th.random_variables(jm, x, seed=3)
    want, _ = jm.apply(v, x, train=train, mutable=["batch_stats"])
    m = BasicConv2d(6, 10, 3, stride=stride, padding=2, dilation=2,
                    with_relu=relu)
    p, st = v["params"], v["batch_stats"]
    m.load_state_dict(dict(
        **{"conv.weight": _flax_conv(p["conv"]["kernel"])},
        **{f"bn.{k}": torch.from_numpy(np.array(a)) for k, a in (
            ("weight", p["bn"]["scale"]), ("bias", p["bn"]["bias"]),
            ("running_mean", st["bn"]["mean"]),
            ("running_var", st["bn"]["var"]))},
        **{"bn.num_batches_tracked": torch.tensor(0)}))
    with torch.no_grad():
        got = m.train(train)(th.nchw(x))
    np.testing.assert_allclose(th.nhwc(got), np.asarray(want), **TOL)


def test_pixel_shuffles_match_jax():
    from emip_tpu.models.common import PixelShuffleDownsample as JaxDown
    from emip_tpu.models.common import PixelShuffleUpsample as JaxUp
    from emip_tpu.models.common import pixel_shuffle as jax_ps
    from emip_tpu.models.common import pixel_unshuffle as jax_pu

    from emip_tpu_torch.models.common import (
        PixelShuffleDownsample,
        PixelShuffleUpsample,
        pixel_shuffle,
        pixel_unshuffle,
    )

    x = np.random.default_rng(12).standard_normal((2, 8, 10, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(
        th.nhwc(pixel_shuffle(th.nchw(x), 2)), np.asarray(jax_ps(x, 2)))
    np.testing.assert_array_equal(
        th.nhwc(pixel_unshuffle(th.nchw(x), 2)), np.asarray(jax_pu(x, 2)))
    for jcls, tcls, shape in ((JaxDown, PixelShuffleDownsample, (2, 4, 5, 24)),
                              (JaxUp, PixelShuffleUpsample, (2, 16, 20, 6))):
        jm = jcls(12)
        v = th.random_variables(jm, x, seed=4)
        m = tcls(12)
        m.load_state_dict({"conv.weight": _flax_conv(
            v["params"]["conv"]["kernel"])})
        with torch.no_grad():
            got = th.nhwc(m(th.nchw(x)))
        want = np.asarray(jm.apply(v, x))
        assert got.shape == want.shape == shape
        np.testing.assert_allclose(got, want, **TOL)
