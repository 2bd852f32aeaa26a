"""Data parallelism of the port (``emip_tpu_torch/parallel.py``) on the CPU.

Two ranks of a gloo group are spawned once for the module (a ``file://``
rendezvous under ``tmp_path``, a 60 s timeout on the process group, joined
with a timeout so that a hang fails here and not the whole run). Each rank
runs the cases of ``tests/torch_helpers.py`` (``ddp_worker``) on its rows
of a seeded global batch through the trainers' own step functions, in
``DistributedDataParallel``; this process runs the same cases on the whole
batch with no group. A 2-rank step must equal the one-process step on the
concatenated batch (``tests/test_torch_train.py`` holds that step against
JAX), in fp32:

- the loss (the mean of the ranks' losses) to 1e-5 relative;
- each leaf's grad, as AdamW reads it before its clamp, to 1e-4 of the
  larger of its max|grad| and 1e-3 of the largest max|grad| of any leaf
  (the scale floor of tests/test_torch_train.py: a bias before a
  BatchNorm has a grad that is rounding noise);
- the BatchNorm buffers, equal bits on both ranks: each running mean to
  1e-6 of its max|value|, each running variance to 1e-5: the ranks' variance
  is flax's E[x^2] - E[x]^2 in fp32, the one process's torch's one-pass
  variance, and where a channel's mean is large against its spread the
  fp32 rounding of E[x^2] shows (``conv_corr``'s BatchNorm, mean ~74 and
  variance ~800 over 4 x 8 x 8 values, reads 1.8e-6);
- the parameters after AdamW to 1e-6 where |grad| >= 1e-6; below that
  AdamW's first step, lr * g / (|g| + 1e-8), turns on the rounding of g, so
  there only the bound of one step (2 lr) holds.

The BatchNorm statistics of the whole batch (all-reduced sums of x and
x^2 over the element counts), the photometric loss's normaliser over every rank's masks and the
drop-path draw of ``world x B`` rows are what makes this hold; the first
two are also held against flax's ``nn.BatchNorm`` and JAX's
``_photometric`` on the whole batch, un-jitted. The bf16 step is held
within twice its bf16-vs-fp32 gap (the losses; all leaves' grads and all
BatchNorm buffers taken together, by max and by mean). The sharded loaders
equal the JAX loaders bit for bit. Finally the three trainers run on two
ranks end to end (DDP over their steps, a shard of the data each, the
first rank alone writing), and the rendezvous rules and their failures are
checked without a group.
"""

import functools
import json
import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch
import yaml

from tests import torch_helpers as th

WORLD = 2
JOIN_S = 240  # the spawn, two model builds a case and the trainers
LOSS_REL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-3
BUFFER_REL = {"running_mean": 1e-6, "running_var": 1e-5}
PARAM_ATOL = 1e-6
ADAM_SATURATED = 1e-6  # |grad| above which AdamW's first step is +-lr
EXTRA = ("bn", "bn_uneven", "photometric")


def _video_root(path):
    """Three synthetic videos of 6, 4 and 5 frames: the long trainer's
    clips differ in length across the ranks."""
    from emip_tpu_torch.data import make_synthetic_video_root

    root = make_synthetic_video_root(str(path), num_videos=3,
                                     frames_per_video=6, size=(56, 64))
    for video, keep in (("video_01", 4), ("video_02", 5)):
        for sub in ("Imgs", "GT"):
            d = os.path.join(root, video, sub)
            for f in sorted(os.listdir(d))[keep:]:
                os.remove(os.path.join(d, f))
    return root


def _yaml(path, root, save, **extra):
    """The tiny YAML with the dead modules kept (DDP must step with
    parameters that take no grad)."""
    th.tiny_yaml(path, root, save, **extra)
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["model"]["args"]["include_dead_modules"] = True
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: [rank 0's record, rank 1's]} of every case and of the
    trainers, from one spawn of two ranks."""
    from emip_tpu_torch.data import make_synthetic_static_root

    tmp = tmp_path_factory.mktemp("ddp")
    root = _video_root(tmp / "videos")
    static_root = make_synthetic_static_root(str(tmp / "static"),
                                             num_images=8, size=(56, 64))
    trainers = dict(
        short_yaml=_yaml(tmp / "short.yaml", root, str(tmp / "short")),
        long_yaml=_yaml(tmp / "long.yaml", root, str(tmp / "long"),
                        epoch_val=0),
        static_yaml=_yaml(tmp / "static.yaml", root, str(tmp / "static_run")),
        static_root=static_root)
    cases = list(th.DDP_CASES) + list(EXTRA)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=th.ddp_worker,
                         args=(r, WORLD, str(tmp / "rendezvous"), str(tmp),
                               cases, trainers)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} rank(s) hung past {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = {c: [torch.load(tmp / f"{c}_{r}.pt") for r in range(WORLD)]
           for c in cases + ["trainers"]}
    out["tmp"] = tmp
    return out


@functools.lru_cache(maxsize=None)
def _one_process(case: str) -> dict:
    """The case on the whole batch, no process group."""
    return th.ddp_case(case, slice(0, th.DDP_BATCH))


def _rel(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                floor, 1e-30)


def _assert_step_matches(case: str, ranks) -> None:
    got, want = ranks[case], _one_process(case)
    for r in range(1, WORLD):  # DDP leaves every rank the same state
        for key in ("grads", "buffers", "params"):
            assert all(torch.equal(got[0][key][k], got[r][key][k])
                       for k in got[0][key]), (case, key)
    loss = np.mean([g["loss"] for g in got], axis=0)
    np.testing.assert_allclose(loss, want["loss"], rtol=LOSS_REL)
    assert got[0]["grads"].keys() == want["grads"].keys()
    top = max(float(v.abs().max()) for v in want["grads"].values())
    worst = max((_rel(got[0]["grads"][k], v, GRAD_FLOOR * top), k)
                for k, v in want["grads"].items())
    assert worst[0] <= GRAD_REL, worst
    for k, v in want["buffers"].items():
        rel = _rel(got[0]["buffers"][k], v)
        assert rel <= BUFFER_REL[k.rsplit(".", 1)[1]], (k, rel)
    for k, v in want["params"].items():
        diff = (got[0]["params"][k] - v).abs()
        grad = want["grads"].get(k)
        if grad is None:  # no grad: AdamW leaves it alone
            assert float(diff.max()) == 0.0, k
            continue
        sat = grad.abs() >= ADAM_SATURATED
        if sat.any():
            assert float(diff[sat].max()) <= PARAM_ATOL, k
        assert float(diff.max()) <= 2 * th.DDP_LR, k


# ---------------------------------------------------------- the steps


@pytest.mark.parametrize("case", ["short_fp32", "short_fp32_dp"])
def test_two_rank_short_step_matches_one_process(ranks, case):
    """The short train step (hybrid-E + photometric loss, GMFlow frozen,
    dead modules without grads, clamp + AdamW) at drop path 0 and 0.1."""
    _assert_step_matches(case, ranks)


def test_two_rank_static_step_matches_one_process(ranks):
    """``static_train_step`` of SegNetwork, drop path 0.1."""
    _assert_step_matches("static", ranks)


def test_two_rank_long_step_matches_one_process(ranks):
    """``long_train_step`` through ``CachedStep`` in DDP: one clip a rank
    against two clips side by side (the LTM's BatchNorm synced)."""
    _assert_step_matches("long", ranks)


def test_two_rank_bf16_step_within_its_gap(ranks):
    """The bf16 short step: each side rounds to bf16 at other points once
    the BatchNorm statistics differ in their last fp32 bits, so it is held
    to the bf16 band: the mean loss, all leaves' grads and all BatchNorm
    buffers within twice the one-process bf16-vs-fp32 gap (> 0)."""
    got, want, fp32 = ranks["short_bf16"], _one_process("short_bf16"), \
        _one_process("short_fp32")
    loss = float(np.mean([g["loss"][0] for g in got]))
    gap = abs(want["loss"][0] - fp32["loss"][0])
    assert 0 < gap and abs(loss - want["loss"][0]) <= 2 * gap

    for key in ("grads", "buffers"):
        names = sorted(want[key])

        def cat(d):
            return torch.cat([d[k].flatten().double() for k in names])

        err = (cat(got[0][key]) - cat(want[key])).abs()
        gap = (cat(want[key]) - cat(fp32[key])).abs()
        assert float(gap.max()) > 0, key
        assert float(err.max()) <= 2 * float(gap.max()), key
        assert float(err.mean()) <= 2 * float(gap.mean()), key


# ------------------------------------------- whole-batch semantics vs JAX


def _assert_batchnorm_matches_flax(got) -> None:
    """The ranks' ``BatchNorm2d`` records (``th.ddp_bn_case``) against an
    un-jitted flax ``nn.BatchNorm`` on the 8 rows: output, input grad,
    scale and bias grads (summed over the ranks), updated statistics."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((8, 6, 5, 7)) * 2 + 1.5).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5)
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}

    def f(xh, s, b):
        return bn.apply({"params": {"scale": s, "bias": b},
                         "batch_stats": stats}, xh,
                        mutable=["batch_stats"])

    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    y, new = f(xh, scale, bias)
    _, vjp = jax.vjp(lambda *a: f(*a)[0], xh, scale, bias)
    dx, ds, db = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))

    y_port = torch.cat([g["y"] for g in got]).numpy()
    dx_port = torch.cat([g["dx"] for g in got]).numpy()
    np.testing.assert_allclose(y_port, np.asarray(y).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx_port, np.asarray(dx).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(g["dw"] for g in got).numpy(),
                               np.asarray(ds), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(g["db"] for g in got).numpy(),
                               np.asarray(db), rtol=1e-4, atol=1e-5)
    for key in ("mean", "var"):
        assert torch.equal(got[0][key], got[1][key])
        np.testing.assert_allclose(got[0][key].numpy(),
                                   np.asarray(new["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7)


def test_synced_batchnorm_matches_flax(ranks):
    """Two ranks' ``BatchNorm2d`` in train mode, 4 rows each, against flax
    on the 8 rows."""
    _assert_batchnorm_matches_flax(ranks["bn"])


def test_synced_batchnorm_uneven_rows_matches_flax(ranks):
    """The same with 3 rows on one rank and 5 on the other: the statistics
    are sums over element counts, so the ranks need not hold equal
    rows."""
    _assert_batchnorm_matches_flax(ranks["bn_uneven"])


def test_photometric_normaliser_matches_jax(ranks):
    """Two ranks' photometric term, each over its 2 rows but normalised by
    the mask's mean over all 4, against JAX's ``_photometric`` on the 4:
    the mean of the ranks' terms, and the grads to the reconstruction and
    the mask (each rank's grad is that of the sum over the ranks, so 1/W of
    it is the whole batch's)."""
    import jax
    import jax.numpy as jnp
    from emip_tpu.losses.flow import UnsupFlowLossConfig, _photometric

    ins = {k: jnp.asarray(v) for k, v in th.ddp_photometric_inputs().items()}
    loss, vjp = jax.vjp(
        lambda r, o: _photometric(UnsupFlowLossConfig(), ins["target"], r, o),
        ins["recons"], ins["occ"])
    d_recons, d_occ = vjp(jnp.ones_like(loss))
    got = ranks["photometric"]
    np.testing.assert_allclose(np.mean([float(g["loss"]) for g in got]),
                               float(loss), rtol=1e-6)
    for key, want in (("d_recons", d_recons), ("d_occ", d_occ)):
        port = torch.cat([g[key] for g in got]).numpy() / WORLD
        np.testing.assert_allclose(port, np.asarray(want), rtol=1e-4,
                                   atol=1e-7)


# --------------------------------------------------- the trainers, 2 ranks


def test_trainers_run_data_parallel(ranks):
    """``train_short`` (2 steps, validation), ``train_long`` (clips of 6,
    4 and 5 frames, so the ranks' groups differ in length until the MIN
    all-reduce cuts them) and ``train_static`` (2 steps) on two ranks: the
    ranks end with the same parameters and step counts, the first rank
    alone writes the scalars (each record once) and the checkpoints."""
    got = ranks["trainers"]
    for key in ("short_params", "long_params", "static_params"):
        assert torch.equal(got[0][key], got[1][key]), key
    for key in ("short", "long", "static"):
        assert got[0][key]["steps"] == got[1][key]["steps"] > 0, key
    # 3 clips over 2 ranks: 2 a rank (one padded); each group stepped to
    # the shorter of the two ranks' clips (at most 4 frames: 3 steps)
    assert got[0]["long"]["steps"] <= 2 * 3
    tmp = ranks["tmp"]
    for run, ckpt in (("short", "ckpt"), ("long", "ckpt_long"),
                      ("static_run", "ckpt")):
        assert os.path.isfile(tmp / run / ckpt / "ckpt.pt"), run
    with open(tmp / "short" / "scalars.jsonl") as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("learning_rate") == 1 and "val/MAE" in tags


# ------------------------------------------------------ the sharded loaders


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_shard_order_matches_jax(count):
    from emip_tpu.data.pipeline import shard_order as jax_shard_order

    from emip_tpu_torch.data import shard_order

    for n in range(0, 13):
        order = list(np.random.default_rng(n).permutation(n))
        shards = [shard_order(order, i, count) for i in range(count)]
        assert shards == [jax_shard_order(order, i, count)
                          for i in range(count)]
        assert len({len(s) for s in shards}) <= 1
        assert set(sum(shards, [])) == set(order)
    with pytest.raises(ValueError):
        shard_order([1, 2], count, count)


@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    return _video_root(tmp_path_factory.mktemp("shard_videos") / "d")


def _same_batches(got, want, keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_pair_loader_matches_jax(video_root, rank):
    """``PairTrainLoader(shard=(r, 2))``: two epochs of augmented batches
    equal the JAX loader's bit for bit."""
    from emip_tpu.data.pipeline import PairTrainLoader as JaxLoader

    from emip_tpu_torch.data import PairTrainLoader

    kw = dict(batch_size=2, size=32, seed=3, shard=(rank, WORLD))
    port = PairTrainLoader(video_root, video_root, **kw)
    ref = JaxLoader(video_root, video_root, num_workers=2, **kw)
    assert len(port) == len(ref) == 3  # 12 pairs, 6 a rank
    for _ in range(2):
        _same_batches(list(port), list(ref), ("image1", "image2", "gt"))


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_static_loader_matches_jax(tmp_path, rank):
    from emip_tpu.data.pipeline import StaticImageLoader as JaxLoader

    from emip_tpu_torch.data import (
        StaticImageLoader,
        make_synthetic_static_root,
    )

    root = make_synthetic_static_root(str(tmp_path / "s"), num_images=7,
                                      size=(40, 48), seed=2)
    kw = dict(batch_size=2, size=32, seed=4, shard=(rank, WORLD))
    port, ref = StaticImageLoader(root, **kw), JaxLoader(root, **kw)
    assert len(port) == len(ref) == 2  # 7 images padded to 8, 4 a rank
    for _ in range(2):
        _same_batches(list(port), list(ref), ("image", "gt"))


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_clip_loader_matches_jax(video_root, rank):
    """Shuffled clips, 3 over 2 ranks (the shard padded by wrapping)."""
    from emip_tpu.data.pipeline import ClipLoader as JaxLoader

    from emip_tpu_torch.data import ClipLoader

    kw = dict(size=32, shuffle=True, seed=5, shard=(rank, WORLD))
    port = ClipLoader(video_root, video_root, **kw)
    ref = JaxLoader(video_root, video_root, num_workers=2, use_native=False,
                    **kw)
    assert len(port) == len(ref) == 2
    for _ in range(2):
        got, want = list(port), list(ref)
        assert [g["video"] for g in got] == [w["video"] for w in want]
        _same_batches(got, want, ("frames", "masks"))


# ------------------------------------------------ rendezvous and failures


def test_distributed_env_detection():
    """The rules of the JAX package's ``_distributed_env``."""
    from emip_tpu_torch.parallel import distributed_env

    assert not distributed_env({})
    assert not distributed_env({"SLURM_NTASKS": "1", "WORLD_SIZE": "1"})
    assert distributed_env({"SLURM_NTASKS": "4"})
    assert distributed_env({"WORLD_SIZE": "2"})
    assert distributed_env({"JAX_COORDINATOR_ADDRESS": "h:1234"})
    assert distributed_env({"COORDINATOR_ADDRESS": "h:1234"})


def test_rendezvous_from_torchrun_and_slurm():
    from emip_tpu_torch.parallel import Rendezvous, rendezvous

    assert rendezvous({"MASTER_ADDR": "h", "MASTER_PORT": "29500",
                       "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"}
                      ) == Rendezvous("tcp://h:29500", 8, 5, 1)
    assert rendezvous({"SLURM_NTASKS": "4", "SLURM_PROCID": "2",
                       "SLURM_LOCALID": "0", "COORDINATOR_ADDRESS": "n0:77"}
                      ) == Rendezvous("tcp://n0:77", 4, 2, 0)
    for env in ({"WORLD_SIZE": "2", "RANK": "0"},
                {"MASTER_ADDR": "h", "MASTER_PORT": "1", "RANK": "0"},
                {"SLURM_NTASKS": "2", "COORDINATOR_ADDRESS": "h:1"}):
        with pytest.raises(RuntimeError, match="no rendezvous"):
            rendezvous(env)


_RENDEZVOUS_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                    "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID",
                    "SLURM_LOCALID", "COORDINATOR_ADDRESS",
                    "JAX_COORDINATOR_ADDRESS")


@pytest.fixture
def bare_env(monkeypatch):
    for var in _RENDEZVOUS_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_joins_or_raises(bare_env):
    """One process: a no-op (the device back, no group); a torchrun-style
    rendezvous of one rank with ``multi_host``: a gloo group of one; a
    multi-process environment without its rendezvous, or a backend that
    cannot start: raises, and no group is left behind."""
    import torch.distributed as dist

    from emip_tpu_torch.parallel import (
        init_distributed,
        shutdown_distributed,
        world,
    )

    assert init_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized() and world() == (0, 1)
    with pytest.raises(RuntimeError, match="no rendezvous"):
        init_distributed("cpu", multi_host=True)
    bare_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no rendezvous"):
        init_distributed("cpu")
    assert not dist.is_initialized()

    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                     WORLD_SIZE="1", RANK="0", LOCAL_RANK="0").items():
        bare_env.setenv(k, v)
    assert init_distributed("cpu", multi_host=True) == torch.device("cpu")
    try:
        assert world() == (0, 1) and dist.get_backend() == "gloo"
    finally:
        shutdown_distributed()
    assert not dist.is_initialized()
    bare_env.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(Exception):
        init_distributed("cpu", backend="nccl", multi_host=True)
    assert not dist.is_initialized()


def test_multi_host_without_rendezvous_raises(tmp_path, bare_env):
    """``python -m emip_tpu_torch.train --multi_host`` with no rendezvous
    raises before it reads the config or writes anything."""
    from emip_tpu_torch.train.__main__ import main

    save = tmp_path / "run"
    cfg = th.tiny_yaml(tmp_path / "c.yaml", str(tmp_path / "none"),
                       str(save))
    with pytest.raises(RuntimeError, match="no rendezvous"):
        main(["--config", cfg, "--multi_host", "--device", "cpu"])
    assert not save.exists()


def test_one_process_draws_as_before():
    """With no group the drop-path draw is the batch's own rows, as before
    data parallelism: the same bits as ``torch.rand`` of [B, 1, 1]."""
    from emip_tpu_torch.models.pvt_v2 import drop_path

    x = torch.ones(3, 4, 5)
    got = drop_path(x, 0.3, torch.Generator().manual_seed(7))
    u = torch.rand((3, 1, 1), generator=torch.Generator().manual_seed(7))
    assert torch.equal(got, x * (torch.floor(0.7 + u) / 0.7))
