"""The port's alternate encoders against the JAX package's, fp32, on the
CPU: the backbone registry (names and stage channels), the linear PVTv2
(kernel A's plain version on 49 pooled keys), PVT-v1, Res2Net-50 v1b and
EfficientNet-B1 at test depth, alone and inside ``SegNetwork`` (eval
logits at 64^2, and at 96^2 for the PVTs' position tables and pooling),
each on weights carried by ``emip_tpu_torch.convert``; that ``train_static``
builds each from a YAML in either dtype. The train steps, the two-stream
model on the alternates and DGNet are in
tests/test_torch_backbones_train.py.

BatchNorm's running variance follows flax's rule (the biased batch
variance): one train-mode call of ``BasicConv2d`` and of a Res2Net
``SegNetwork`` leaves every ``batch_stats`` leaf within 1e-5 of max|ref|.

Tolerances: stage features and logits rtol 1e-3 / atol 1e-2
(tests/test_torch_static.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests import torch_helpers as th

TOL = dict(rtol=1e-3, atol=1e-2)
STATS_REL = 1e-5


# ------------------------------------------------------------ registry


def test_registry_matches_jax():
    """Every name the JAX package registers, with its stage channels, and
    nothing else; every name builds. The JAX registry is read in a process
    of its own: the tests of other files add reduced variants to it in
    theirs."""
    import json
    import os
    import subprocess
    import sys

    from emip_tpu_torch.models.backbones import (
        available_backbones,
        create_backbone,
    )

    code = ("import json; from emip_tpu.models.backbones import "
            "available_backbones as a, create_backbone as c; "
            "print(json.dumps({n: list(c(n)[1]) for n in a()}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    want = json.loads(out.stdout.strip().splitlines()[-1])
    names = available_backbones()
    assert names == sorted(want)
    for name in names:
        module, ch = create_backbone(name)
        assert list(ch) == want[name], name
        with torch.no_grad():
            stages = module.eval()(torch.zeros(1, 3, 64, 64))
        assert tuple(s.shape[1] for s in stages) == ch, name


def test_registry_refuses_unknown_names_and_stray_switches():
    from emip_tpu_torch.models import backbones

    assert not hasattr(backbones, "_NOT_PORTED")
    with pytest.raises(ValueError, match="unknown backbone"):
        backbones.create_backbone("pvt_v1_small")
    with pytest.raises(ValueError, match="MixFFN"):
        backbones.create_backbone("res2net50_26w_4s", fused_ffn="always")
    m, _ = backbones.create_backbone("pvt_v2_b2_li", fused_ffn="always")
    assert m.config.fused_ffn == "always" and m.config.linear


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("relu", [False, True])
def test_batchnorm_statistics_match_flax(relu):
    """One train-mode call: the running mean and the biased running
    variance of flax's BatchNorm (torch's own update takes the unbiased
    variance, n / (n - 1) larger)."""
    from emip_tpu.models.common import BasicConv2d as JaxBlock

    from emip_tpu_torch.convert import _conv
    from emip_tpu_torch.models.common import BasicConv2d

    x = np.random.default_rng(12).standard_normal((2, 6, 6, 5)).astype(
        np.float32)
    jm = JaxBlock(7, 3, padding=1, with_relu=relu)
    v = th.random_variables(jm, x, seed=4)
    want, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    m = BasicConv2d(5, 7, 3, padding=1, with_relu=relu)
    p, st = v["params"], v["batch_stats"]
    m.load_state_dict({
        "conv.weight": torch.from_numpy(_conv(p["conv"]["kernel"])),
        "bn.weight": torch.from_numpy(np.array(p["bn"]["scale"])),
        "bn.bias": torch.from_numpy(np.array(p["bn"]["bias"])),
        "bn.running_mean": torch.from_numpy(np.array(st["bn"]["mean"])),
        "bn.running_var": torch.from_numpy(np.array(st["bn"]["var"])),
        "bn.num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = m.train()(th.nchw(x))
    np.testing.assert_allclose(th.nhwc(got), np.asarray(want), **TOL)
    for mine, theirs in (("running_mean", "mean"), ("running_var", "var")):
        ref = np.asarray(upd["batch_stats"]["bn"][theirs])
        err = np.abs(getattr(m.bn, mine).numpy() - ref).max()
        assert err <= STATS_REL * np.abs(ref).max(), (mine, err)


# ------------------------------------------------------------ SegNetwork


@pytest.fixture(scope="module", params=th.ALTERNATES)
def seg_pair(request):
    return (request.param, *th.alternate_seg_pair(request.param))


def test_backbone_stages_match_jax(seg_pair):
    """The encoder alone: its four stage features in eval mode."""
    import jax

    from emip_tpu.models.backbones import create_backbone

    name, _, variables, port = seg_pair
    x, _ = th.seg_images()
    (key,) = [k for k in variables["params"]
              if k not in ("dr1", "dr2", "dr3", "decoder")]
    sub = {k: v[key] for k, v in variables.items() if key in v}
    encoder, _ = create_backbone(th.jax_alternate(name))
    want = jax.jit(lambda v, x: encoder.apply(v, x, train=False))(sub, x)
    with torch.no_grad():
        got = port.backbone.eval()(th.nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(th.nhwc(g), np.asarray(w), **TOL)


def test_seg_network_logits_match_jax(seg_pair):
    import jax

    _, jm, variables, port = seg_pair
    x, _ = th.seg_images()
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port.eval()(th.nchw(x))
    assert got.shape == (2, 1, th.SIZE, th.SIZE)
    np.testing.assert_allclose(th.nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["pvt_v2_b2_li", "pvt_small"])
def test_seg_network_at_96_matches_jax(name):
    """96^2: PVT-v1's position tables resized from the 224 grid to 24^2 ..
    3^2, the linear PVTv2's 7 x 7 pooling from 24, 12, 6 and 3."""
    import jax

    jm, variables, port = th.alternate_seg_pair(name, 96)
    x, _ = th.seg_images(size=96)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port.eval()(th.nchw(x))
    np.testing.assert_allclose(th.nhwc(got), np.asarray(want), **TOL)


def test_seg_network_batch_stats_match_flax():
    """One train-mode call of a whole Res2Net SegNetwork (101 BatchNorms,
    down to 8 elements a channel at /32): every running mean and variance
    within 1e-5 of max|ref| (torch's own update would be 1/7 off there)."""
    import jax

    from emip_tpu_torch.convert import state_dict_from_flax_seg

    jm, variables, port = th.alternate_seg_pair("res2net50_26w_4s")
    x, _ = th.seg_images(seed=9)
    _, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        port.train()(th.nchw(x))
    want = state_dict_from_flax_seg(th.with_batch_stats(variables,
                                                        upd["batch_stats"]))
    rel = th.stats_relmax(port, want)
    assert rel[0] <= STATS_REL, rel


def test_emip_short_refuses_backbones_narrower_than_gmflow():
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig

    with pytest.raises(ValueError, match="injectors"):
        EMIPShort(EMIPShortConfig(backbone_name="res2net50_26w_4s"))


# ------------------------------------------------------------ entry point


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_trainer_builds_each_alternate(tmp_path, dtype):
    """A YAML naming an alternate reaches ``train_static``'s SegNetwork in
    either compute dtype."""
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.models.efficientnet import EfficientNetBackbone
    from emip_tpu_torch.models.pvt_v1 import PVTv1
    from emip_tpu_torch.models.pvt_v2 import PVTv2
    from emip_tpu_torch.models.res2net import Res2Net50V1b
    from emip_tpu_torch.train.static import build_seg_model

    for name, kind in (("pvt_v2_b2_li", PVTv2), ("pvt_tiny", PVTv1),
                       ("res2net50_26w_4s", Res2Net50V1b),
                       ("efficientnet_b4", EfficientNetBackbone)):
        path = th.tiny_yaml(tmp_path / f"{name}.yaml", str(tmp_path),
                            str(tmp_path / "run"), compute_dtype=dtype)
        cfg = load_config(path)
        cfg.model = dataclasses.replace(cfg.model, backbone_name=name)
        model = build_seg_model(cfg, "cpu")
        encoder = getattr(model.backbone.feat_net, kind.feat_net_key)
        assert isinstance(encoder, kind), name
        assert encoder.compute_dtype == getattr(torch, dtype)
