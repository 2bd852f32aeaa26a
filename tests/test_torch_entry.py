"""The port's configuration and entry points against the JAX package's, on
the CPU: the YAML's ``load`` block of torch checkpoints, ``python -m
emip_tpu_torch.test --config --ckpt``, empty dataset blocks, the keys that
only steer the JAX package, and the widths the kernels take at pvt_v2_b0's
configuration (the tiny one of tests/torch_helpers.py).
"""

import logging
import os
import re

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests import torch_helpers as th

from emip_tpu_torch import kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_yaml(path, root, save, **extra):
    """The tiny configuration of tests/test_torch_train.py as a YAML."""
    ds = dict(image_path=root, gt_path=root, inp_size=th.SIZE, batch_size=2)
    cfg = dict(
        train_dataset=ds, val_dataset=dict(ds, batch_size=1),
        model=dict(args=dict(
            inp_size=th.SIZE, channel=th.CHANNEL, backbone_name="pvt_v2_b0",
            include_dead_modules=False,
            GMFlow=dict(feature_channels=th.FDIM,
                        num_transformer_layers=th.NUM_LAYERS))),
        optimizer=dict(lr=1e-4, weight_decay=1e-7), compute_dtype="float32",
        seed=5, epoch=2, epoch_val=1, epoch_save=1, save_path=save)
    cfg.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    from emip_tpu_torch.data import make_synthetic_video_root

    return make_synthetic_video_root(
        str(tmp_path_factory.mktemp("entry") / "data"), num_videos=2,
        frames_per_video=4, size=(56, 64))


def _pngs(root):
    return {os.path.relpath(os.path.join(d, f), root):
            np.asarray(Image.open(os.path.join(d, f)))
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")}


# ------------------------------------------------------- F1: test entry


def test_test_entry_point_predicts_from_a_trained_checkpoint(
        tmp_path, synthetic_root):
    """``python -m emip_tpu_torch.train`` (2 steps), then ``python -m
    emip_tpu_torch.test --config --ckpt`` (in process): the PNGs are those
    of ``predict_pairs`` on the trained weights, and differ from those of
    the seeded model the config alone gives."""
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.infer import predict_pairs
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.test import main as test_main
    from emip_tpu_torch.train.__main__ import main as train_main

    save = str(tmp_path / "run")
    cfg = _tiny_yaml(tmp_path / "tiny.yaml", synthetic_root, save)
    train_main(["--config", cfg, "--max_steps_per_epoch", "2",
                "--device", "cpu"])
    ckpt = os.path.join(save, "ckpt")
    for out, extra in (("pred", ["--ckpt", ckpt]), ("seeded", [])):
        test_main(["--config", cfg, "--save_path", str(tmp_path / out),
                   "--data", f"MoCA_test={synthetic_root}", "--device",
                   "cpu", *extra])
    model = EMIPShort(load_config(cfg).model)
    model.load_state_dict(torch.load(os.path.join(ckpt, "ckpt.pt"))["model"])
    predict_pairs(model.eval(), synthetic_root,
                  str(tmp_path / "direct" / "MoCA_test"), size=th.SIZE,
                  batch_size=8, device="cpu")
    got, direct = _pngs(tmp_path / "pred"), _pngs(tmp_path / "direct")
    seeded = _pngs(tmp_path / "seeded")
    assert len(got) == 6 and got.keys() == direct.keys() == seeded.keys()
    assert all(np.array_equal(got[k], direct[k]) for k in got)
    assert any(not np.array_equal(got[k], seeded[k]) for k in got)


def test_test_cli_flags_mirror_root_test_py():
    """The root script's flags plus --device (default: the card)."""
    from emip_tpu_torch.test import parse_args

    with open(os.path.join(REPO, "test.py")) as f:
        root_flags = set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))
    args = parse_args([])
    assert {f"--{k}" for k in vars(args)} == root_flags | {"--device"}
    assert (args.config, args.ckpt, args.data, args.device) == (
        "configs/emip.yaml", None, None, "cuda")


# ---------------------------------------------------- F2: the load block


def _layouts(model, tmp_path):
    """The seeded model's weights in the reference's three layouts: a full
    snapshot under "state_dict" (with keys the port does not build), an
    upstream GMFlow checkpoint under "model" (no "GMFlow." prefix), and a
    long snapshot with the reference's dead LTM modules."""
    sd = model.state_dict()
    extra = {"LTM.fusion.conv1_m.weight": torch.zeros(2, 2),
             "LTM.Decoder.conv.weight": torch.zeros(3),
             "LTM.dr1.weight": torch.zeros(1)}
    paths = {}
    for name, ckpt in (
            ("path", dict(state_dict=dict(sd, **extra), epoch=3)),
            ("flow_path", dict(model={k[len("GMFlow."):]: v
                                      for k, v in sd.items()
                                      if k.startswith("GMFlow.")}))):
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save(ckpt, paths[name])
    return paths, extra


def test_load_block_loads_the_reference_layouts(tmp_path, caplog):
    """``load.path`` (a full snapshot) and ``load.flow_path`` (GMFlow under
    "model") load into a model seeded otherwise, the keys it lacks logged
    and left out; ``load.long_path`` does the same for EMIPLong; a null
    path or one that is not a file leaves the seeded weights."""
    from emip_tpu_torch.config import LoadConfig
    from emip_tpu_torch.convert import (LONG_LOAD, SHORT_LOAD,
                                        load_configured_weights)
    from emip_tpu_torch.models.init import seeded_init_

    src = seeded_init_(th.torch_tiny_short(False), 1)
    paths, extra = _layouts(src, tmp_path)
    want = src.state_dict()

    def fresh():
        return seeded_init_(th.torch_tiny_short(False), 2)

    with caplog.at_level(logging.INFO, logger="emip_tpu_torch"):
        model = fresh()
        load_configured_weights(model, LoadConfig(path=paths["path"]),
                                SHORT_LOAD)
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    line = [r.getMessage() for r in caplog.records
            if paths["path"] in r.getMessage()]
    assert len(line) == 1 and f"loaded {len(want)} tensors" in line[0]
    assert "3 unexpected" in line[0] and "LTM.Decoder.conv.weight" in line[0]

    model = fresh()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_configured_weights(model, LoadConfig(flow_path=paths["flow_path"]),
                            SHORT_LOAD)
    got = model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k] if k.startswith("GMFlow.")
                           else before[k]), k

    for absent in (None, str(tmp_path / "missing.pth"), str(tmp_path)):
        model = fresh()
        load_configured_weights(model, LoadConfig(path=absent,
                                                  flow_path=absent),
                                SHORT_LOAD)
        assert all(torch.equal(v, before[k])
                   for k, v in model.state_dict().items())

    long_src = seeded_init_(th.torch_tiny_long(), 3)
    long_path = str(tmp_path / "long.pth")
    torch.save(dict(state_dict=dict(long_src.state_dict(), **extra)),
               long_path)
    long_model = seeded_init_(th.torch_tiny_long(), 4)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="emip_tpu_torch"):
        load_configured_weights(long_model, LoadConfig(long_path=long_path),
                                LONG_LOAD)
    for k, v in long_src.state_dict().items():
        assert torch.equal(long_model.state_dict()[k], v), k
    assert any("LTM.fusion.conv1_m.weight" in r.getMessage()
               for r in caplog.records)


def test_load_block_reads_a_snapshot_as_the_jax_package_does(tmp_path,
                                                            monkeypatch):
    """A reference snapshot in its other key forms (``module.`` keys of a
    DataParallel run, the legacy ``backbone.pvtv2_en``) loads through the
    port's loader as through the JAX package's
    ``maybe_load_reference_weights``: from the same start, the two models'
    weights are equal tensor for tensor, and are the snapshot's. A tensor
    of another shape raises in both."""
    import functools
    import types

    from emip_tpu.convert import torch_import
    from emip_tpu.models import pvt_v2
    from emip_tpu_torch.config import LoadConfig
    from emip_tpu_torch.convert import (SHORT_LOAD, load_configured_weights,
                                        state_dict_from_flax)
    from emip_tpu_torch.models.init import seeded_init_

    # the JAX loader reads the PVT depths from the backbone's name and
    # converts 6 flow transformer blocks: give it the tiny model's
    monkeypatch.setitem(pvt_v2.PVT_V2_VARIANTS, "tiny",
                        types.SimpleNamespace(depths=th.DEPTHS))
    monkeypatch.setattr(torch_import, "convert_emip_short_state",
                        functools.partial(
                            torch_import.convert_emip_short_state,
                            num_layers=th.NUM_LAYERS))
    to_torch = functools.partial(state_dict_from_flax, depths=th.DEPTHS,
                                 num_layers=th.NUM_LAYERS)
    jm, _ = th.jax_tiny_short()
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    start = th.random_variables(jm, img, img, seed=31)
    snap = seeded_init_(th.torch_tiny_short(), 32).state_dict()
    legacy = {"module." + k.replace("backbone.feat_net.pvtv2_en",
                                    "backbone.pvtv2_en"): v
              for k, v in snap.items()}
    assert sum("module.backbone.pvtv2_en." in k for k in legacy) > 10

    def both(ckpt):
        path = str(tmp_path / "snapshot.pth")
        torch.save(dict(state_dict=ckpt), path)
        cfg = types.SimpleNamespace(
            load=types.SimpleNamespace(path=path, flow_path=None),
            model=types.SimpleNamespace(backbone_name="tiny"))
        port = th.torch_tiny_short()
        port.load_state_dict(to_torch(start), strict=True)
        return (lambda: torch_import.maybe_load_reference_weights(start, cfg),
                lambda: load_configured_weights(port, LoadConfig(path=path),
                                                SHORT_LOAD) or port)

    jax_load, port_load = both(legacy)
    want, got = to_torch(jax_load()), port_load().state_dict()
    assert got.keys() == want.keys() == snap.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], snap[k]), k

    wide = dict(legacy)
    o, i, kh, kw = wide["module.conv_corr.0.weight"].shape
    wide["module.conv_corr.0.weight"] = torch.zeros(o, i, kh + 2, kw + 2)
    for load in both(wide):
        with pytest.raises(ValueError, match="shape mismatch"):
            load()


def test_entry_points_read_the_load_block(tmp_path, synthetic_root,
                                          monkeypatch):
    """The YAML's ``load`` block reaches the model that ``train_short``,
    ``test``, ``build_long_model`` and ``test_long`` build."""
    from emip_tpu_torch import convert
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.test import main as test_main
    from emip_tpu_torch.test_long import main as test_long_main
    from emip_tpu_torch.train.long import build_long_model
    from emip_tpu_torch.train.loops import train_short

    seen = []
    real = convert.load_torch_weights
    monkeypatch.setattr(convert, "load_torch_weights",
                        lambda model, path, *a: seen.append(
                            (type(model).__name__, path))
                        or real(model, path, *a))
    load = dict(path=str(tmp_path / "s.pth"), flow_path=str(tmp_path / "f"),
                long_path=str(tmp_path / "l.pth"))
    cfg = _tiny_yaml(tmp_path / "tiny.yaml", synthetic_root,
                     str(tmp_path / "run"), load=load, epoch=1)
    train_short(load_config(cfg), device="cpu")
    test_main(["--config", cfg, "--data", f"a={synthetic_root}",
               "--save_path", str(tmp_path / "p"), "--device", "cpu"])
    build_long_model(load_config(cfg), device="cpu")
    test_long_main(["--config", cfg, "--data", f"a={synthetic_root}",
                    "--save_path", str(tmp_path / "q"), "--device", "cpu"])
    short = [("EMIPShort", load["path"]), ("EMIPShort", load["flow_path"])]
    long = [("EMIPLong", load["long_path"])]
    assert seen == short + short + long + long


# ------------------------------------------- F3, F4: the YAML's other keys


def test_empty_dataset_block_is_none_as_in_jax(tmp_path):
    """``val_dataset_cad: {}`` (or null) means no CAD validation, as in the
    JAX package's load_config; an empty train or val block takes the
    defaults."""
    from emip_tpu.utils.config import load_config as jax_load_config
    from emip_tpu_torch.config import DatasetConfig, load_config

    for empty in ({}, None):
        cfg = _tiny_yaml(tmp_path / "c.yaml", "/d", "/s",
                         val_dataset_cad=empty)
        assert load_config(cfg).val_dataset_cad is None
        assert jax_load_config(cfg).val_dataset_cad is None
    with open(tmp_path / "e.yaml", "w") as f:
        yaml.safe_dump(dict(train_dataset={}, val_dataset=None), f)
    cfg = load_config(str(tmp_path / "e.yaml"))
    assert cfg.train_dataset == cfg.val_dataset == DatasetConfig()


@pytest.mark.parametrize("keys,warned", [
    ({}, set()),
    (dict(compute_dtype=None), {"compute_dtype"}),
    (dict(compute_dtype="float32", optimizer=dict(name="AdamW"),
          parallel=dict(model_parallel=1, fsdp=False),
          long_frames_per_dispatch=1), set()),
    (dict(compute_dtype="bfloat16"), {"compute_dtype"}),
    (dict(compute_dtype="bfloat16", optimizer=dict(name="sgd"),
          parallel=dict(model_parallel=2, sequence_parallel=True),
          long_frames_per_dispatch=4),
     {"compute_dtype", "optimizer.name", "parallel",
      "long_frames_per_dispatch"})],
    ids=["tiny", "unset", "trivial", "bf16", "all"])
def test_ignored_keys_warn_once_each(tmp_path, caplog, keys, warned):
    """Each key that steers only the JAX package and asks for other than
    what the port does is named in one warning line, a missing
    ``compute_dtype`` too (the JAX package's default is bfloat16); the tiny
    YAML (which states float32) and trivial values warn nothing. Nothing
    else changes."""
    from emip_tpu_torch.config import load_config

    opt = dict(lr=1e-4, weight_decay=1e-7, **keys.pop("optimizer", {}))
    path = tmp_path / "c.yaml"
    _tiny_yaml(path, "/d", "/s", **keys)
    raw = yaml.safe_load(open(path))
    raw["optimizer"] = opt
    raw = {k: v for k, v in raw.items() if v is not None}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    with caplog.at_level(logging.WARNING, logger="emip_tpu_torch"):
        cfg = load_config(str(path))
    lines = [r.getMessage() for r in caplog.records
             if r.levelno == logging.WARNING]
    assert {m.split("=")[0].split()[-1] for m in lines} == warned
    assert len(lines) == len(warned)
    assert (cfg.lr, cfg.weight_decay) == (1e-4, 1e-7)


def test_repository_yaml_warns_of_bfloat16_only(caplog):
    """configs/emip.yaml asks for bfloat16 (the port runs fp32) and for
    nothing else the port ignores."""
    from emip_tpu_torch.config import load_config

    with caplog.at_level(logging.WARNING, logger="emip_tpu_torch"):
        cfg = load_config(os.path.join(REPO, "configs", "emip.yaml"))
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1 and "compute_dtype='bfloat16'" in lines[0]
    assert cfg.load.type == "COD10K" and cfg.load.path is None


# --------------------------------------- F5: the tiny configuration's widths


def _tiny_kernel_args():
    """Each kernel wrapper's arguments at the widths of pvt_v2_b0 with
    64-d flow features: A at head width 32, B at 64, C at 64, F at 64."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    c = 32
    sr = (r(2, 256, c), r(2, 4, c), r(c, c), r(c), r(2 * c, c), r(2 * c),
          r(c, c), r(c), 1)
    c = th.FDIM
    sp = dict(wq=r(c, c), wk=r(c, c), wv=r(c, c), wm=r(c, c), s1=r(c),
              b1=r(c))
    cp = dict(sp, w0=r(4 * c, 2 * c), w2=r(c, 4 * c), s2=r(c), b2=r(c))
    bias = torch.zeros(2, 3 * 64)
    bias[:, :64] = -1e9
    return {
        "sr_attention": (K.fused_sr_attention, sr),
        "window_attention_block": (K.fused_window_attention_block,
                                   (r(2, 4, 16, c), r(2, 4, 16, c), sp, cp)),
        "flow_attention": (K.fused_flow_attention,
                           (r(2, 64, c), r(2, 64, c), r(2, 64, 2))),
        "memory_attention": (K.masked_memory_attention,
                             (r(2, 64, c), r(2, 192, c), r(2, 192, c), bias)),
    }


@pytest.mark.parametrize("name", ["sr_attention", "window_attention_block",
                                  "flow_attention", "memory_attention"])
def test_kernels_take_the_tiny_configuration_widths(name):
    """The checks a CUDA tensor meets take the tiny configuration's widths
    (they refused all but pvt_v2_b5's), and a width no kernel is built for
    still raises; on the CPU the wrappers run their plain versions as
    before, launching nothing."""
    from emip_tpu_torch.kernels import (flow_attention, memory_attention,
                                        sr_attention, window_attention)

    fn, args = _tiny_kernel_args()[name]
    if name == "sr_attention":
        check = lambda a: sr_attention._check(dict(zip(  # noqa: E731
            ("x", "kv_in", "wq", "bq", "wkv", "bkv", "wp", "bp"), a[:8])),
            a[8])
        wide = list(args)
        wide[8] = 2  # head width 16
    elif name == "window_attention_block":
        check = lambda a: window_attention._check(  # noqa: E731
            a[0], a[1], [a[2][k] for k in window_attention._SELF_KEYS]
            + [a[3][k] for k in window_attention._CROSS_KEYS], None)
        wide = [torch.zeros(2, 4, 16, 96), torch.zeros(2, 4, 16, 96),
                *args[2:]]
    else:
        module = (flow_attention if name == "flow_attention"
                  else memory_attention)
        check = lambda a: module._check(*a)  # noqa: E731
        wide = [torch.zeros(*t.shape[:-1], 96) if t.shape[-1] == th.FDIM
                else t for t in args]
    check(args)
    with pytest.raises(ValueError, match="width"):
        check(wide)
    before = dict(K.LAUNCHES)
    out = fn(*args)
    assert torch.isfinite(out).all() and K.LAUNCHES == before
