"""Static-image pretraining on the port against the JAX package's, on the
CPU: the synthetic COD10K-style root and :class:`StaticImageLoader`'s
batches (bit-equal), :class:`SegNetwork` on weights carried by
``state_dict_from_flax_seg`` (logits, one train step's hybrid-E loss and
every leaf's grad), ``python -m emip_tpu_torch.train_static --device
cpu``, and the JAX package's log file and scalar tags in the trainers.

Tolerances: logits rtol 1e-3 / atol 1e-2 (tests/test_full_model_parity.py);
loss rel 1e-4; grads by the scale-floored relative max of
tests/test_grad_parity.py at the 5e-3 of tests/test_torch_train.py's seg
grads (fp32 through the backbone in both frameworks, the Pallas kernel in
interpret mode against plain torch).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests import torch_helpers as th

SEG_DEPTHS = (1, 1, 2, 1)
SEG_GRAD_REL = 5e-3


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_synthetic_static_root_matches_jax(tmp_path):
    from emip_tpu.data.synthetic import make_synthetic_static_root as jax_make

    from emip_tpu_torch.data import make_synthetic_static_root

    got = make_synthetic_static_root(str(tmp_path / "port"), num_images=5,
                                     size=(40, 52), seed=3)
    want = jax_make(str(tmp_path / "jax"), num_images=5, size=(40, 52),
                    seed=3)
    assert got == str(tmp_path / "port")
    a, b = _files(got), _files(want)
    assert len(a) == 10 and a == b


@pytest.fixture(scope="module")
def static_root(tmp_path_factory):
    from emip_tpu_torch.data import make_synthetic_static_root

    root = str(tmp_path_factory.mktemp("static") / "data")
    make_synthetic_static_root(root, num_images=7, size=(56, 64), seed=1)
    # an image without its GT is left out by both loaders
    os.rename(os.path.join(root, "GT", "im_0006.png"),
              os.path.join(root, "im_0006_gt.png"))
    return root


@pytest.mark.parametrize("augment,drop", [(True, True), (False, True),
                                          (True, False)])
def test_static_loader_batches_match_jax(static_root, augment, drop):
    """Two epochs of batches, equal bit for bit: the per-epoch shuffle,
    the per-item augmentation (rotation, hflip, jitter, salt-and-pepper)
    and the resize."""
    from emip_tpu.data.pipeline import StaticImageLoader as JaxLoader

    from emip_tpu_torch.data import StaticImageLoader

    kw = dict(batch_size=4, size=48, seed=9, augment=augment,
              drop_remainder=drop)
    port, ref = StaticImageLoader(static_root, **kw), JaxLoader(static_root,
                                                                **kw)
    assert len(port.items) == 6 and len(port) == len(ref) == (1 if drop
                                                              else 2)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"image", "gt"}
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_static_loader_takes_no_shard(static_root):
    """Without ``drop_remainder`` the loader takes no shard: it raises (the
    JAX loader's rule: equal batches on every process); with it, the two
    shards split
    the 6 images 3 and 3, as the JAX loader's do (the batches themselves
    are held bit for bit in tests/test_torch_ddp.py)."""
    from emip_tpu.data.pipeline import StaticImageLoader as JaxLoader

    from emip_tpu_torch.data import StaticImageLoader

    with pytest.raises(ValueError, match="drop_remainder"):
        StaticImageLoader(static_root, 2, shard=(0, 2), drop_remainder=False)
    for rank in (0, 1):
        port = StaticImageLoader(static_root, 2, shard=(rank, 2))
        assert len(port) == len(JaxLoader(static_root, 2,
                                          shard=(rank, 2))) == 1


# ----------------------------------------------------------- the model


def _jax_seg():
    from emip_tpu.models.backbones import register_backbone
    from emip_tpu.models.emip_short import SegNetwork
    from emip_tpu.models.pvt_v2 import PVTv2, PVTv2Config

    b0 = PVTv2Config((32, 64, 160, 256), (1, 2, 5, 8), (8, 8, 4, 4),
                     SEG_DEPTHS, (8, 4, 2, 1), drop_path_rate=0.0,
                     remat=False, fused_attn="always")
    name = "pvt_v2_b0_port_static_parity"
    register_backbone(name, lambda dtype: PVTv2(config=b0, dtype=dtype),
                      b0.embed_dims)
    return SegNetwork(backbone_name=name, channel=th.CHANNEL)


def _torch_seg():
    from emip_tpu_torch.models.emip_short import SegNetwork
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS

    b0 = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b0"], depths=SEG_DEPTHS,
                             drop_path_rate=0.0)
    return SegNetwork(b0, th.CHANNEL)


@pytest.fixture(scope="module")
def seg_pair():
    """(flax SegNetwork, its seeded variables, the port's SegNetwork with
    the same weights)."""
    from emip_tpu_torch.convert import state_dict_from_flax_seg

    jm = _jax_seg()
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm, img, seed=21, train=False)
    port = _torch_seg()
    port.load_state_dict(state_dict_from_flax_seg(variables, SEG_DEPTHS),
                         strict=True)
    return jm, variables, port


def _batch(seed=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32),
            (rng.uniform(size=(2, th.SIZE, th.SIZE, 1)) > 0.6
             ).astype(np.float32))


def test_seg_network_logits_match_flax(seg_pair):
    import jax

    jm, variables, port = seg_pair
    x, _ = _batch()
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, x))
    with torch.no_grad():
        got = port.eval()(th.nchw(x))
    assert got.shape == (2, 1, th.SIZE, th.SIZE)
    np.testing.assert_allclose(th.nhwc(got), want, rtol=1e-3, atol=1e-2)


def test_seg_network_train_loss_and_grads_match_jax(seg_pair):
    """Train mode (batch statistics), drop path off: the hybrid-E loss and
    d(loss)/d(every leaf)."""
    import jax

    from emip_tpu.losses.seg import hybrid_e_loss as jax_loss

    from emip_tpu_torch.convert import state_dict_from_flax_seg
    from emip_tpu_torch.losses.seg import hybrid_e_loss

    jm, variables, port = seg_pair
    x, gt = _batch(8)

    def loss_fn(params):
        logits, _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, rngs={"droppath": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jax_loss(logits, gt)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    want = state_dict_from_flax_seg(
        {"params": jax.tree_util.tree_map(np.asarray, grads_j),
         "batch_stats": variables["batch_stats"]}, SEG_DEPTHS)

    model = port.train()
    loss = hybrid_e_loss(model(th.nchw(x)), th.nchw(gt))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-4)
    scale = max(float(want[n].abs().max()) for n in names)
    worst = []
    for n, g in zip(names, grads):
        rel = float((g - want[n]).abs().max()) / max(
            float(want[n].abs().max()), 1e-6 * scale)
        worst.append((rel, n))
    stats = ("running_mean", "running_var", "num_batches_tracked")
    assert set(names) == {k for k in want if not k.endswith(stats)}
    assert max(worst)[0] <= SEG_GRAD_REL, sorted(worst)[-5:]
    port.eval()


def test_adp_lr_matches_jax():
    from emip_tpu.train.state import adp_lr as jax_adp_lr

    from emip_tpu_torch.train.state import adp_lr

    for bs in (1, 8, 36, 72):
        assert adp_lr(bs) == jax_adp_lr(bs)
        assert adp_lr(bs, 16, 3e-5) == jax_adp_lr(bs, 16, 3e-5)


# ------------------------------------------------------ entry points


def _records(path):
    with open(os.path.join(path, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_static_entry_point(tmp_path, static_root):
    """``python -m emip_tpu_torch.train_static --device cpu`` (in process)
    on the tiny configuration: 2 steps, a checkpoint under
    ``<save_path>/static/ckpt`` that loads into SegNetwork and, by its
    keys, into the two-stream model; the log file and the JAX package's
    scalar tags."""
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.train.static import build_seg_model
    from emip_tpu_torch.train_static import main

    save = str(tmp_path / "run")
    cfg = th.tiny_yaml(tmp_path / "tiny.yaml", static_root, save)
    summary = main(["--config", cfg, "--data_root", static_root,
                    "--max_steps_per_epoch", "2", "--device", "cpu"])
    assert summary["steps"] == 2 and np.isfinite(summary["last_loss"])
    out = os.path.join(save, "static")
    state = torch.load(os.path.join(out, "ckpt", "ckpt.pt"))
    assert state["epoch"] == 1 and "optimizer" in state
    conf = load_config(cfg)
    seeded = build_seg_model(conf, "cpu").state_dict()
    model = build_seg_model(conf, "cpu")
    model.load_state_dict(state["model"])
    assert any(not torch.equal(seeded[k], v)
               for k, v in model.state_dict().items())
    _, unexpected = EMIPShort(conf.model).load_state_dict(state["model"],
                                                          strict=False)
    assert unexpected == []
    with open(os.path.join(out, "train_static_log.log")) as f:
        assert "[Static] epoch 1 step 1 loss" in f.read()
    tags = {r["tag"] for r in _records(out)}
    assert tags == {"loss/static", "time/epoch_s"}


def test_short_trainer_logs_with_the_jax_tags(tmp_path):
    """``python -m emip_tpu_torch.train`` writes ``train_log.log`` and the
    JAX package's scalar tags (``emip_tpu/train/loops.py``)."""
    from emip_tpu_torch.data import make_synthetic_video_root
    from emip_tpu_torch.train.__main__ import main as train_main

    root = make_synthetic_video_root(str(tmp_path / "data"), num_videos=1,
                                     frames_per_video=3, size=(56, 64))
    save = str(tmp_path / "run")
    cfg = th.tiny_yaml(tmp_path / "tiny.yaml", root, save)
    train_main(["--config", cfg, "--max_steps_per_epoch", "1", "--device",
                "cpu"])
    tags = {r["tag"] for r in _records(save)}
    assert tags == {"learning_rate", "loss/loss", "loss/loss_pred",
                    "loss/loss_flow", "loss/mean_abs_flow", "time/epoch_s",
                    "time/steps_per_s", "loss/epoch_mean", "val/wFm",
                    "val/Sm", "val/MAE", "val/val_loss"}
    with open(os.path.join(save, "train_log.log")) as f:
        text = f.read()
    assert "[Train] epoch 1 step 1" in text and "[Val] epoch 1" in text


def test_logging_writes_the_jax_records(tmp_path):
    """The same log line format and JSON record keys as
    :mod:`emip_tpu.utils.logging`; a second ``setup_logging`` moves the
    file handler instead of adding one."""
    import logging

    from emip_tpu.utils.logging import ScalarLogger as JaxScalars

    from emip_tpu_torch.utils.logging import ScalarLogger, setup_logging

    ours = JaxScalars(str(tmp_path / "jax"))
    ours.scalar("loss/long", np.float32(0.25), 3)
    ours.close()
    with ScalarLogger(str(tmp_path / "port")) as s:
        s.scalars({"loss/long": np.float32(0.25)}, 3)
    (j,), (p,) = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert j.keys() == p.keys() and j["tag"] == p["tag"]
    assert (j["value"], j["step"]) == (p["value"], p["step"])

    logger = setup_logging(str(tmp_path / "a"), "x.log")
    setup_logging(str(tmp_path / "b"), "x.log")
    logger.info("[Static] one line")
    files = [h for h in logger.handlers
             if isinstance(h, logging.FileHandler)]
    assert len(files) == 1
    files[0].flush()
    assert not (tmp_path / "a" / "x.log").read_text()
    line = (tmp_path / "b" / "x.log").read_text()
    assert line.startswith("[") and line.endswith(
        "-INFO:[Static] one line]\n")
