"""The ported slice as a whole: EMIPShort, weights, imports, ops, inference.

The reduced two-stream model (b0 widths, PVT depths (1, 1, 1, 1), 64^2
frames, 8-channel decoder, 64-d flow features, 2 transformer blocks) runs
in both frameworks with identical weights; the tolerances are those of
tests/test_full_model_parity.py (rtol 1e-3; atol 2e-2 on flows, 1e-2 on
mask logits: fp32 through many conv / norm layers).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests import torch_helpers as th

from emip_tpu_torch.convert import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair_models():
    jm, _ = th.jax_tiny_short()
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm, img, img, seed=21)
    port = th.torch_tiny_short()
    port.load_state_dict(
        state_dict_from_flax(variables, th.DEPTHS, th.NUM_LAYERS),
        strict=True)
    return jm, variables, port


def test_short_model_matches_jax(pair_models):
    jm, variables, port = pair_models
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32)
    b = rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32)
    mask, fw, bw = jax.jit(jm.apply)(variables, a, b)
    with torch.no_grad():
        pmask, pfw, pbw = port(th.nchw(a), th.nchw(b))
    assert pmask.shape == (2, 1, th.SIZE, th.SIZE)
    assert pfw[-1].shape == pbw[-1].shape == (2, 2, th.SIZE, th.SIZE)
    np.testing.assert_allclose(th.nhwc(pfw[-1]), np.asarray(fw[-1]),
                               rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(th.nhwc(pbw[-1]), np.asarray(bw[-1]),
                               rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(th.nhwc(pmask), np.asarray(mask), rtol=1e-3,
                               atol=1e-2)


def test_weights_round_trip(pair_models):
    """JAX variables -> port state_dict -> load(strict) -> the JAX
    package's own torch converter -> the same variables, leaf for leaf."""
    from emip_tpu.convert.torch_import import convert_emip_short_state

    _, variables, port = pair_models
    back = convert_emip_short_state(port.state_dict(), depths=th.DEPTHS,
                                    num_layers=th.NUM_LAYERS)
    for coll in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(variables[coll])
        got = traverse_util.flatten_dict(back[coll])
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=str(k))


def test_port_imports_no_jax():
    """Every module of emip_tpu_torch imports without jax or flax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import emip_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "emip_tpu_torch.__path__, 'emip_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'emip_tpu'))\n"
        "assert len(mods) >= 20, mods\n"
        "new = {'device', 'kernels.memory_attention', 'models.ltm', "
        "'models.emip_long', 'train.long', 'test_long', 'train_long'}\n"
        "assert {'emip_tpu_torch.' + m for m in new} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -------------------------------------------------------------- ops


def _op_cases():
    import emip_tpu.ops.geometry as jg
    import emip_tpu.ops.image as ji
    import emip_tpu.ops.position as jp
    import emip_tpu.ops.window as jw
    from emip_tpu_torch.ops import geometry, image, position, window

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    xt = torch.from_numpy(x)
    w = np.asarray(jw.window_split(x, 2))
    tok = np.asarray(jw.window_split_tokens(x, 2))
    img = rng.uniform(0, 1, (2, 6, 7, 3)).astype(np.float32)
    return {
        "window_split": (window.window_split(xt, 2), w),
        "window_merge": (window.window_merge(torch.from_numpy(w), 2),
                         np.asarray(jw.window_merge(w, 2))),
        "window_split_tokens": (window.window_split_tokens(xt, 2), tok),
        "window_merge_tokens": (
            window.window_merge_tokens(torch.from_numpy(tok), 2, 8, 12), x),
        "shifted_window_mask": (window.shifted_window_mask(8, 12, 2),
                                np.asarray(jw.shifted_window_mask(8, 12, 2))),
        "sine_position_embedding": (
            position.sine_position_embedding(6, 10, 16),
            np.asarray(jp.sine_position_embedding(6, 10, 16))),
        "coords_grid": (geometry.coords_grid(5, 7),
                        np.asarray(jg.coords_grid(5, 7))),
        "resize_bilinear_align": (
            image.resize_bilinear(th.nchw(img), (12, 14), True),
            np.asarray(ji.resize_bilinear(img, (12, 14), True))),
        "resize_bilinear_x8": (
            image.resize_bilinear(th.nchw(img), (48, 56), False),
            np.asarray(ji.resize_bilinear(img, (48, 56), False))),
        "normalize_imagenet": (image.normalize_imagenet(th.nchw(img)),
                               np.asarray(ji.normalize_imagenet(img))),
    }


@pytest.mark.parametrize("name", [
    "window_split", "window_merge", "window_split_tokens",
    "window_merge_tokens", "shifted_window_mask", "sine_position_embedding",
    "coords_grid", "resize_bilinear_align", "resize_bilinear_x8",
    "normalize_imagenet"])
def test_ops_match_jax(name):
    got, want = _op_cases()[name]
    if got.dim() == 4 and name.startswith(("resize", "normalize")):
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------- inference


def test_postprocess_to_png_matches_jax(tmp_path):
    from PIL import Image

    from emip_tpu.infer import postprocess_to_png as jax_png
    from emip_tpu_torch.infer import postprocess_to_png

    logits = np.random.default_rng(1).standard_normal((16, 16)) * 3
    jax_png(logits.astype(np.float32), (37, 45), str(tmp_path / "a" / "j.png"))
    postprocess_to_png(logits.astype(np.float32), (37, 45),
                       str(tmp_path / "a" / "t.png"))
    a = np.asarray(Image.open(tmp_path / "a" / "j.png"))
    b = np.asarray(Image.open(tmp_path / "a" / "t.png"))
    assert a.shape == (37, 45)
    np.testing.assert_array_equal(a, b)


def test_predict_pairs_writes_native_size_pngs(tmp_path, pair_models):
    from PIL import Image

    from emip_tpu_torch.infer import predict_pairs

    _, _, port = pair_models
    rng = np.random.default_rng(3)
    for video, n in (("v1", 4), ("v2", 2)):
        d = tmp_path / "data" / video / "Imgs"
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (30, 40, 3), np.uint8)).save(
                d / f"{i:05d}.jpg")
    flows = predict_pairs(port, str(tmp_path / "data"), str(tmp_path / "out"),
                          size=th.SIZE, batch_size=2, return_flow=True,
                          device="cpu")
    pngs = sorted(p.relative_to(tmp_path / "out").as_posix()
                  for p in (tmp_path / "out").rglob("*.png"))
    assert pngs == ["v1/00000.png", "v1/00001.png", "v1/00002.png",
                    "v2/00000.png"]
    for p in pngs:
        im = Image.open(tmp_path / "out" / p)
        assert im.mode == "L" and im.size == (40, 30)
    assert len(flows) == 4 and flows[0][2].shape == (th.SIZE, th.SIZE, 2)
    assert all(np.isfinite(f[2]).all() for f in flows)


def test_cli_parses_test_py_flags():
    from emip_tpu_torch.test import parse_args

    args = parse_args(["--data", "MoCA_test=/d/MoCA", "CAD=/d/CAD",
                       "--save_path", "/tmp/p", "--batch_size", "4"])
    assert args.data == ["MoCA_test=/d/MoCA", "CAD=/d/CAD"]
    assert (args.save_path, args.batch_size) == ("/tmp/p", 4)
    # the one flag the port adds: the device, whose default is the card
    assert args.device == "cuda"
    assert parse_args(["--data", "a=b", "--device", "cpu"]).device == "cpu"


def test_backbone_factory():
    """b5 and Res2Net-50 v1b build with their stage channels; an unknown
    name raises."""
    from emip_tpu_torch.models.backbones import create_backbone
    from emip_tpu_torch.models.res2net import Res2Net50V1b

    _, ch = create_backbone("pvt_v2_b5")
    assert ch == (64, 128, 320, 512)
    module, ch = create_backbone("res2net50_26w_4s")
    assert isinstance(module, Res2Net50V1b)
    assert ch == (256, 512, 1024, 2048)
    with pytest.raises(ValueError):
        create_backbone("no_such_backbone")


def test_seeded_init_is_deterministic():
    from emip_tpu_torch.models.init import seeded_init_

    a = seeded_init_(th.torch_tiny_short(False), 3).state_dict()
    b = seeded_init_(th.torch_tiny_short(False), 3).state_dict()
    c = seeded_init_(th.torch_tiny_short(False), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
