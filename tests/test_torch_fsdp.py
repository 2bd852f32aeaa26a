"""FSDP of the port's short trainer (``parallel.fsdp``,
``emip_tpu_torch/parallel.py:fully_sharded``) on the CPU.

Two ranks of a gloo group are spawned once for the module (a ``file://``
rendezvous, a 60 s timeout on the group, joined with a timeout); each runs
the cases of ``tests/torch_shard_helpers.py:fsdp_worker`` on its rows,
with the model sharded by ``fully_shard`` (every PVT block, GMFlow
transformer block, the decoder and the injectors, then the root). While
they run, this process computes the one-process step and JAX's own FSDP
step (``sharded_state_and_batch(fsdp=True, min_size=512)`` on a 2 x 1
mesh, the one JAX compilation of the module). A 2-rank FSDP step must be

- the one-process step on the concatenated batch, to
  ``tests/test_torch_ddp.py``'s tolerances: the loss to 1e-5, each grad to
  1e-4 of the larger of its max|grad| and 1e-3 of the largest, each
  parameter after AdamW to 1e-6 where |grad| >= 1e-6 (elsewhere within
  one step, 2 lr);
- JAX's FSDP step at JAX's own bounds (``tests/test_tensor_parallel.py``):
  the loss to rtol 1e-5, each parameter within 2.5x the learning rate, on
  the weights, batch and learning rate of ``tests/test_torch_train.py``'s
  A/B;

with parameters and AdamW moments sharded (at least 10 of each, as JAX
asserts), the dead modules without grads, a checkpoint that one process
loads and whose moments are the one-process step's, a bf16 validation
that reads the stepped weights, and ``train_short`` at world 2 with its
validation and a resume that the same resume under DDP holds.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from tests import torch_helpers as th
from tests import torch_shard_helpers as sh

JOIN_S = 240
LOSS_REL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-3
PARAM_ATOL = 1e-6
ADAM_SATURATED = 1e-6
JAX_LR = 1e-3  # tests/test_torch_train.py's STEP_LR
JAX_PARAM_ATOL = 2.5 * JAX_LR


def _jax_ab_inputs():
    """The JAX A/B's model, variables and batch of
    tests/test_torch_train.py (seeds 31 and 4, drop path 0)."""
    jm, _ = th.jax_tiny_short(drop_path_rate=0.0)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm, img, img, seed=31)
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32)
    b = rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(2, th.SIZE, th.SIZE, 1)) > 0.5).astype(
        np.float32)
    return jm, variables, (a, b, gt)


def _jax_fsdp_step(jm, variables, batch):
    """JAX's own FSDP step: the state sharded on 'data' of a 2 x 1 mesh
    (``min_size`` 512, as its test), the batch split over 'data'."""
    import jax
    from jax.sharding import Mesh

    from emip_tpu.parallel.sharding import sharded_state_and_batch
    from emip_tpu.train.short import make_short_train_step
    from emip_tpu.train.state import (
        GMFLOW_FREEZE,
        TrainState,
        build_optimizer,
        merge_params,
    )

    from emip_tpu_torch.convert import state_dict_from_flax

    tx = build_optimizer(learning_rate=JAX_LR, weight_decay=1e-7,
                         clip_value=0.5)
    state = TrainState.create(variables, tx, GMFLOW_FREEZE)
    mesh = Mesh(np.asarray(jax.devices()[:sh.WORLD]).reshape(sh.WORLD, 1),
                ("data", "model"))
    a, b, gt = batch
    fs_state, fs_batch = sharded_state_and_batch(
        state, dict(image1=a, image2=b, gt=gt), mesh, tp=False, fsdp=True,
        min_size=512)
    step = make_short_train_step(jm, tx, donate=False)
    new, metrics = step(fs_state, fs_batch, jax.random.PRNGKey(1))
    params = state_dict_from_flax(
        {"params": jax.tree_util.tree_map(
            np.asarray, merge_params(new.params, new.frozen)),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)},
        th.DEPTHS, th.NUM_LAYERS)
    return float(metrics["loss"]), params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' readings, the one-process step's, JAX's FSDP step's and
    the trainer's save path."""
    from emip_tpu_torch.convert import state_dict_from_flax
    from emip_tpu_torch.data import make_synthetic_video_root

    tmp = tmp_path_factory.mktemp("fsdp")
    jm, variables, batch = _jax_ab_inputs()
    a, b, gt = batch
    torch.save(dict(model=state_dict_from_flax(variables, th.DEPTHS,
                                               th.NUM_LAYERS),
                    batch=dict(image1=th.nchw(a), image2=th.nchw(b),
                               gt=th.nchw(gt)), lr=JAX_LR),
               tmp / "jax_state.pt")
    root = make_synthetic_video_root(str(tmp / "videos"), num_videos=2,
                                     frames_per_video=6, size=(56, 64))
    config = th.tiny_yaml(tmp / "fsdp.yaml", root, str(tmp / "run"),
                          parallel=dict(fsdp=True))
    raw = yaml.safe_load(open(config))
    raw["model"]["args"]["include_dead_modules"] = True
    with open(config, "w") as f:
        yaml.safe_dump(raw, f)
    procs = sh.spawn_ranks(sh.fsdp_worker, str(tmp / "rendezvous"),
                           str(tmp), str(tmp / "jax_state.pt"), config)
    try:  # the ranks run while this process computes its references
        one = th.ddp_case("short_fp32", slice(0, th.DDP_BATCH))
        jax_loss, jax_params = _jax_fsdp_step(jm, variables, batch)
    finally:
        got = sh.join_ranks(procs, JOIN_S, tmp)
    return dict(ranks=got, one=one, jax_loss=jax_loss, jax_params=jax_params,
                tmp=tmp)


def _rel(got, want, floor=0.0):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                floor, 1e-30)


def test_fsdp_step_matches_one_process(ranks):
    """The 2-rank FSDP step of the short model (dead modules kept, GMFlow
    frozen and sharded) against the one-process step on all 4 rows."""
    got = [r["step"] for r in ranks["ranks"]]
    want = ranks["one"]
    for key in ("grads", "params"):
        assert all(torch.equal(got[0][key][k], got[1][key][k])
                   for k in got[0][key]), key
    np.testing.assert_allclose(got[0]["loss"], want["loss"][0],
                               rtol=LOSS_REL)
    assert got[0]["grads"].keys() == want["grads"].keys()
    top = max(float(v.abs().max()) for v in want["grads"].values())
    worst = max((_rel(got[0]["grads"][k], v, GRAD_FLOOR * top), k)
                for k, v in want["grads"].items())
    assert worst[0] <= GRAD_REL, worst
    for k, v in want["params"].items():
        diff = (got[0]["params"][k] - v).abs()
        grad = want["grads"].get(k)
        if grad is None:
            assert float(diff.max()) == 0.0, k
            continue
        sat = grad.abs() >= ADAM_SATURATED
        if sat.any():
            assert float(diff[sat].max()) <= PARAM_ATOL, k
        assert float(diff.max()) <= 2 * th.DDP_LR, k


def test_fsdp_shards_parameters_and_moments(ranks):
    """ZeRO-3: parameters and both AdamW moments are held as shards (at
    least 10 leaves of each, JAX's own assertion)."""
    for r in ranks["ranks"]:
        for case in ("step", "jax_ab"):
            assert r[case]["sharded_params"] >= 10, case
            assert r[case]["sharded_moments"] >= 10, case


def test_fsdp_dead_modules_keep_no_grad(ranks):
    """The dead-but-checkpointed modules (``dr2_new``, ...) take no grad
    under FSDP, as in one process (a zero grad would have AdamW decay them
    and fill their moments), and keep their values."""
    got, want = ranks["ranks"][0]["step"], ranks["one"]
    dead = sorted(k for k in want["params"] if k not in want["grads"])
    assert dead and any(k.startswith("dr2_new") for k in dead)
    assert got["no_grad"] == dead
    for k in dead:
        assert torch.equal(got["params"][k], want["params"][k]), k


def test_fsdp_step_matches_jax_fsdp_step(ranks):
    """Against JAX's FSDP step on the A/B's weights and batch: the loss to
    rtol 1e-5 and every trainable parameter within 2.5 lr."""
    got = [r["jax_ab"] for r in ranks["ranks"]]
    np.testing.assert_allclose(got[0]["loss"], ranks["jax_loss"],
                               rtol=LOSS_REL)
    assert got[0]["params"]
    for k, v in got[0]["params"].items():
        assert torch.equal(v, got[1]["params"][k]), k
        np.testing.assert_allclose(v.numpy(), ranks["jax_params"][k].numpy(),
                                   rtol=0, atol=JAX_PARAM_ATOL, err_msg=k)


def test_fsdp_checkpoint_loads_in_one_process(ranks):
    """``save_checkpoint`` of the sharded model at world 2: the first rank
    wrote the full state, which a one-process model and optimizer load
    (strict): the gathered parameters, buffers and AdamW moments, bit for
    bit."""
    from emip_tpu_torch.train.state import build_optimizer

    model = th.ddp_model("short", torch.float32, 0.0)
    opt = build_optimizer(model, th.DDP_LR)
    saved = torch.load(ranks["tmp"] / "ckpt" / "ckpt.pt")
    model.load_state_dict(saved["model"])
    opt.load_state_dict(saved["optimizer"])
    assert saved["epoch"] == 1
    sd, osd = ranks["ranks"][0]["state"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    own = opt.state_dict()["state"]
    assert own.keys() == osd["state"].keys() and len(own) > 10
    for i, st in own.items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], osd["state"][i][k]), (i, k)


def _one_process_names():
    """The trainable parameters' names in the order of a one-process
    optimizer's integer state keys."""
    from emip_tpu_torch.train.state import build_optimizer

    model = th.ddp_model("short", torch.float32, 0.0)
    build_optimizer(model, th.DDP_LR)
    return [k for k, p in model.named_parameters() if p.requires_grad]


def test_fsdp_checkpoint_moments_match_one_process(ranks):
    """The AdamW moments of the checkpoint written at world 2, each under
    the integer key a one-process optimizer gives its parameter, against
    the one-process step's moments on all 4 rows, to the grads'
    tolerance (the first step's ``exp_avg`` and ``sqrt(exp_avg_sq)`` are
    the clamped grad scaled)."""
    names = _one_process_names()
    saved = torch.load(ranks["tmp"] / "ckpt" / "ckpt.pt")["optimizer"]
    want = ranks["one"]["moments"]
    got = {names[i]: st for i, st in saved["state"].items()}
    assert len(got) == len(saved["state"]) and got.keys() == want.keys()
    for key, view in (("exp_avg", lambda t: t),
                      ("exp_avg_sq", torch.sqrt)):
        top = max(float(view(v[key]).abs().max()) for v in want.values())
        worst = max((_rel(view(got[n][key]), view(v[key]), GRAD_FLOOR * top),
                     n) for n, v in want.items())
        assert worst[0] <= GRAD_REL, (key, worst)


def test_fsdp_optimizer_checkpoint_loads_back_into_the_shards(ranks):
    """``load_sharded_optimizer`` cuts each moment of the trainer's
    checkpoint to its parameter's shard: gathered again, every rank holds
    the checkpoint's optimizer state bit for bit."""
    for r in ranks["ranks"]:
        saved, gathered = r["reloaded"]
        assert gathered["state"].keys() == saved["state"].keys()
        assert len(saved["state"]) > 10
        for i, st in saved["state"].items():
            assert gathered["state"][i].keys() == st.keys(), i
            for k, v in st.items():
                assert torch.equal(gathered["state"][i][k], v), (i, k)


def test_fsdp_resume_matches_ddp_resume(ranks):
    """A resumed ``train_short`` epoch of one step at world 2 with FSDP
    against the same resume under DDP, from a copy of the same checkpoint:
    the checkpoints they write hold the same parameters, buffers and
    AdamW moments, bit for bit."""
    run = ranks["tmp"] / "run"
    fsdp = torch.load(run / "ckpt" / "ckpt.pt")
    ddp = torch.load(str(run) + "_ddp/ckpt/ckpt.pt")
    assert fsdp["epoch"] == ddp["epoch"] == 2
    assert fsdp["model"].keys() == ddp["model"].keys()
    for k, v in ddp["model"].items():
        assert torch.equal(fsdp["model"][k], v), k
    assert fsdp["optimizer"]["state"].keys() == ddp["optimizer"][
        "state"].keys()
    for i, st in ddp["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(fsdp["optimizer"]["state"][i][k], v), (i, k)
    for r in ranks["ranks"]:
        assert r["resumed_ddp"]["steps"] == r["resumed"]["steps"] == 1


def test_fsdp_bf16_validation_reads_the_stepped_weights(ranks):
    """The bf16 band's weight copies (``dtypes.cast``, kept without
    autograd) under FSDP, whose all-gathers may put a parameter back at an
    address it had before: a bf16 validation after a step differs from
    the one before it and equals, bit for bit, the one-process model's on
    the gathered weights."""
    for r in ranks["ranks"]:
        got = r["bf16"]
        assert not torch.equal(got["after"], got["before"])
        assert torch.equal(got["after"], got["plain"])


def test_train_short_runs_fsdp_with_validation(ranks):
    """``train_short`` with ``parallel.fsdp`` at world 2: one epoch of two
    steps with validation on every rank (the first logs), checkpoints by
    the first rank, then a resumed epoch of one step from that
    checkpoint; the ranks end equal."""
    got = ranks["ranks"]
    assert torch.equal(got[0]["trainer_params"], got[1]["trainer_params"])
    for r in got:
        assert r["trainer"]["steps"] == 2 and r["resumed"]["steps"] == 1
        assert np.isfinite(r["trainer"]["best_mae"])
    run = ranks["tmp"] / "run"
    for ckpt in ("ckpt", "ckpt_best"):
        assert os.path.isfile(run / ckpt / "ckpt.pt"), ckpt
    assert torch.load(run / "ckpt" / "ckpt.pt")["epoch"] == 2
    with open(run / "scalars.jsonl") as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("learning_rate") == 2 and tags.count("val/MAE") == 2


def test_world_one_keeps_the_model():
    """With no process group ``fully_sharded`` returns the model itself,
    its parameters plain tensors, and a step of it has the bits of the
    step of its unsharded twin."""
    from emip_tpu_torch.parallel import fully_sharded, is_sharded

    model = th.ddp_model("short", torch.float32, 0.0)
    params = list(model.parameters())
    assert fully_sharded(model) is model and not is_sharded(model)
    assert all(type(p) is torch.nn.Parameter and p is q
               for p, q in zip(model.parameters(), params))
    batch = th.ddp_batch(slice(0, 2))
    got, _, _ = sh.fsdp_step(model, th.DDP_LR, batch)
    want, _, _ = sh.fsdp_step(th.ddp_model("short", torch.float32, 0.0),
                              th.DDP_LR, batch)
    assert got["loss"] == want["loss"]
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
