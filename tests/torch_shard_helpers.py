"""Ranks of the sharded regimes' CPU tests: sharded inference
(tests/test_torch_sharded_infer.py), FSDP (tests/test_torch_fsdp.py) and
the GPipe pipeline (tests/test_torch_pipeline.py).

Each test module spawns its gloo ranks once (:func:`spawn_ranks`), does
its one-process and JAX work while they run, then joins them with a
timeout (:func:`join_ranks`), so that a hang fails the module and not the
whole run. Every rank writes its readings to ``<out_dir>/rank<r>.pt``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket

import numpy as np
import torch

from emip_tpu_torch.parallel import gather_whole

WORLD = 2
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(target, *args, world: int = WORLD) -> list:
    """Start ``target(rank, world, *args)`` in ``world`` spawned
    processes."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, join_s: float, out_dir) -> list:
    """Join the ranks (killing those alive after ``join_s`` s) and return
    their readings; fails on a hang or a non-zero exit."""
    for p in procs:
        p.join(join_s)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} rank(s) hung past {join_s} s"
    assert [p.exitcode for p in procs] == [0] * len(procs), \
        [p.exitcode for p in procs]
    return [torch.load(os.path.join(str(out_dir), f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _join_group(rank: int, world: int, init_file: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)


def _torchrun_env(rank: int, world: int, out_dir: str, name: str) -> None:
    """The variables torchrun gives a rank, for the entry points'
    ``--multi_host``. The first rank picks a free port just before the
    group forms (a port picked earlier may meanwhile be taken by another
    group's connections) and hands it to the others through a file."""
    import time

    path = os.path.join(out_dir, f"port_{name}")
    if rank == 0:
        with open(path + ".tmp", "w") as f:
            f.write(str(free_port()))
        os.replace(path + ".tmp", path)
    deadline = time.monotonic() + GROUP_TIMEOUT.total_seconds()
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no port for {name}")
        time.sleep(0.05)
    with open(path) as f:
        port = f.read()
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK="0")


# ----------------------------------------------------- sharded inference


def infer_worker(rank: int, world: int, out_dir: str, root: str,
                 config: str, ckpt: str) -> None:
    """``python -m emip_tpu_torch.test`` and ``... test_of`` with
    ``--multi_host`` (in process, each joining and leaving a group of its
    own on torchrun's variables, each rank with its own ``--save_path``),
    then ``predict_pairs(return_flow=True)`` in a third group."""
    import torch.distributed as dist

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.infer import predict_pairs
    from emip_tpu_torch.parallel import init_distributed
    from emip_tpu_torch.test import load_short_model
    from emip_tpu_torch.test import main as test_main
    from emip_tpu_torch.test_of import main as test_of_main

    # the one-process run's threads (tests/torch_helpers.py), so that each
    # product sums in the same order
    torch.set_num_threads(2)
    common = ["--config", config, "--ckpt", ckpt, "--multi_host",
              "--device", "cpu"]
    _torchrun_env(rank, world, out_dir, "test")
    test_main(common + ["--save_path", os.path.join(out_dir, f"test{rank}"),
                        "--data", f"MoCA_test={root}", "--batch_size", "2"])
    _torchrun_env(rank, world, out_dir, "test_of")
    n_jpg = test_of_main(common + ["--save_path",
                                   os.path.join(out_dir, f"of{rank}"),
                                   "--data_root", root])
    _torchrun_env(rank, world, out_dir, "flows")
    init_distributed("cpu")
    try:
        cfg = load_config(config)
        model = load_short_model(cfg, ckpt, "cpu")
        flows = predict_pairs(model, root,
                              os.path.join(out_dir, f"flows{rank}"),
                              size=cfg.val_dataset.inp_size, batch_size=2,
                              device="cpu", return_flow=True)
    finally:
        dist.destroy_process_group()
    torch.save(dict(flows=flows, jpgs=n_jpg),
               os.path.join(out_dir, f"rank{rank}.pt"))


# ----------------------------------------------------------------- FSDP


def fsdp_step(model, lr: float, batch: dict) -> tuple[dict, object, object]:
    """One short train step of ``model`` (sharded over the group when it
    has more than one rank; GMFlow frozen first) on ``batch``: the loss
    (the mean over the ranks), the grads as AdamW reads them before its
    clamp and the trainable parameters after the step, whole; the
    trainable parameters that took no grad; the number of parameters and
    of AdamW moments held as shards. Returns (readings, model, opt)."""
    import torch.distributed as dist

    from emip_tpu_torch.parallel import fully_sharded, is_sharded
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer, freeze_gmflow

    if not is_sharded(model):
        model = fully_sharded(freeze_gmflow(model))
    opt = build_optimizer(model, lr)
    names = {id(p): k for k, p in model.named_parameters()}
    grads = {}
    opt.register_step_pre_hook(lambda o, a, kw: grads.update(
        {names[id(p)]: gather_whole(p.grad).clone() for g in o.param_groups
         for p in g["params"] if p.grad is not None}))
    loss = short_train_step(model, opt, batch,
                            torch.Generator().manual_seed(1))["loss"]
    if dist.is_initialized():
        dist.all_reduce(loss)
        loss = loss / dist.get_world_size()

    def shards(tensors):
        return sum(1 for t in tensors if hasattr(t, "to_local")
                   and t.to_local().numel() < t.numel())

    out = dict(
        loss=float(loss), grads=grads,
        params={k: gather_whole(p).detach().clone()
                for k, p in model.named_parameters() if p.requires_grad},
        no_grad=sorted(k for k, p in model.named_parameters()
                       if p.requires_grad and p.grad is None),
        sharded_params=shards(model.parameters()),
        sharded_moments=shards(v for st in opt.state.values()
                               for k, v in st.items() if k != "step"))
    return out, model, opt


def fsdp_worker(rank: int, world: int, init_file: str, out_dir: str,
                jax_state: str, config: str) -> None:
    """The FSDP cases on this rank's rows: the short step of
    ``tests/test_torch_ddp.py``'s model (with the dead modules) and its
    checkpoint; the step of ``tests/test_torch_train.py``'s JAX A/B; a
    bf16 validation before and after a step, and the one-process model's
    on the gathered weights; then ``train_short`` on ``config``
    (``parallel.fsdp``), one epoch of two steps with validation, its
    optimizer checkpoint loaded back into the sharded optimizer, and a
    resumed epoch of one step, with FSDP and (from a copy of the
    checkpoint, under ``<save_path>_ddp``) without."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from tests import torch_helpers as th

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.parallel import (
        full_state,
        fully_sharded,
        load_sharded_optimizer,
    )
    from emip_tpu_torch.train.loops import save_checkpoint, train_short
    from emip_tpu_torch.train.short import short_eval_step
    from emip_tpu_torch.train.state import build_optimizer, freeze_gmflow

    _join_group(rank, world, init_file)
    try:
        out = {}
        per = th.DDP_BATCH // world
        rows = slice(rank * per, (rank + 1) * per)
        out["step"], model, opt = fsdp_step(
            th.ddp_model("short", torch.float32, 0.0), th.DDP_LR,
            th.ddp_batch(rows))
        save_checkpoint(os.path.join(out_dir, "ckpt"), model, opt, 1)
        out["state"] = full_state(model, opt)
        del model, opt

        state = torch.load(jax_state)
        port = th.torch_tiny_short(drop_path_rate=0.0)
        port.load_state_dict(state["model"], strict=True)
        batch = {k: v[rank:rank + 1] for k, v in state["batch"].items()}
        out["jax_ab"], _, _ = fsdp_step(port, state["lr"], batch)

        model16 = fully_sharded(freeze_gmflow(
            th.ddp_model("short", torch.bfloat16, 0.0)))
        plain16 = th.ddp_model("short", torch.bfloat16, 0.0)
        b = th.ddp_batch(rows)
        before = short_eval_step(model16, b["image1"], b["image2"]).clone()
        _, model16, opt16 = fsdp_step(model16, 1e-2, b)
        after = short_eval_step(model16, b["image1"], b["image2"]).clone()
        plain16.load_state_dict(full_state(model16, opt16)[0])
        out["bf16"] = dict(before=before, after=after,
                           plain=short_eval_step(plain16, b["image1"],
                                                 b["image2"]))
        del model16, opt16

        cfg = load_config(config)
        model, out["trainer"] = train_short(cfg, max_steps_per_epoch=2,
                                            device="cpu")
        # the checkpoint loads back into the sharded model and optimizer
        ckpt = torch.load(os.path.join(cfg.save_path, "ckpt", "ckpt.pt"))
        opt = build_optimizer(model, cfg.lr, cfg.weight_decay, cfg.clip)
        load_sharded_optimizer(opt, ckpt["optimizer"])
        out["reloaded"] = (ckpt["optimizer"], full_state(model, opt)[1])
        # the same resume without FSDP (DDP), from a copy of the checkpoint
        plain = dataclasses.replace(cfg, fsdp=False, epoch=cfg.epoch + 1,
                                    save_path=cfg.save_path + "_ddp")
        if rank == 0:
            shutil.copytree(os.path.join(cfg.save_path, "ckpt"),
                            os.path.join(plain.save_path, "ckpt"))
        dist.barrier()
        cfg.epoch += 1
        model, out["resumed"] = train_short(cfg, resume=True,
                                            max_steps_per_epoch=1,
                                            device="cpu")
        out["trainer_params"] = torch.cat(
            [gather_whole(p).detach().flatten() for p in model.parameters()])
        _, out["resumed_ddp"] = train_short(plain, resume=True,
                                            max_steps_per_epoch=1,
                                            device="cpu")
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# -------------------------------------------------------------- pipeline

PP_H = PP_W = 8


class MLPBlock(torch.nn.Module):
    """The JAX package's toy pipeline block, x + tanh(x w1 + b1) w2, with
    the PVT blocks' call signature."""

    def __init__(self, w1, b1, w2):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.as_tensor(np.asarray(w1)))
        self.b1 = torch.nn.Parameter(torch.as_tensor(np.asarray(b1)))
        self.w2 = torch.nn.Parameter(torch.as_tensor(np.asarray(w2)))

    def forward(self, x, h, w):
        return x + torch.tanh(x @ self.w1 + self.b1) @ self.w2


def pvt_stack(states: list, dim: int = 32, heads: int = 2,
              dtype=torch.float32) -> list:
    """PVT blocks (mlp ratio 2, sr 1) holding ``states``, in ``dtype``,
    in eval mode."""
    from emip_tpu_torch.dtypes import set_compute_dtype
    from emip_tpu_torch.models.pvt_v2 import PVTBlock

    blocks = []
    for sd in states:
        blk = PVTBlock(dim, heads, 2, 1)
        blk.load_state_dict(sd)
        set_compute_dtype(blk, dtype)
        blocks.append(blk.eval())
    return blocks


def mlp_stack(params: dict) -> list:
    return [MLPBlock(params["w1"][i], params["b1"][i], params["w2"][i])
            for i in range(len(params["w1"]))]


def run_pipeline(blocks, x, num_microbatches: int, mode: str):
    """sum(y^2) of the stack on ``x`` and its grads, run as ``mode`` says:
    ``pipe`` pipelined over the group; ``micro`` the plain loop on the
    same microbatches, each one's backward in the pipeline's order (last
    microbatch first); ``loop`` the plain loop on the whole batch. Returns
    y, the input's grad, each block's parameter grads (None for a block
    that took none)."""
    from emip_tpu_torch.pipeline import pipeline_blocks

    x = x.clone().requires_grad_(True)

    def loop(t):
        for blk in blocks:
            t = blk(t, PP_H, PP_W)
        return t

    if mode == "micro":
        parts = [p.detach().requires_grad_(True)
                 for p in x.chunk(num_microbatches)]
        outs = [loop(p) for p in parts]
        for m in reversed(range(num_microbatches)):
            outs[m].float().square().sum().backward()
        y = torch.cat(outs)
        x.grad = torch.cat([p.grad for p in parts])
    else:
        y = (pipeline_blocks(blocks, x, PP_H, PP_W, num_microbatches)
             if mode == "pipe" else loop(x))
        y.float().square().sum().backward()
    grads = [None if all(p.grad is None for p in blk.parameters()) else
             {n: p.grad.clone() for n, p in blk.named_parameters()}
             for blk in blocks]
    return dict(y=y.detach(), gx=x.grad, grads=grads)


def pipeline_worker(rank: int, world: int, init_file: str, out_dir: str,
                    cases_path: str) -> None:
    """Each case of ``cases_path`` pipelined over the group (M
    microbatches), the blocks this rank holds, and the refusals' words."""
    import torch.distributed as dist

    from emip_tpu_torch.pipeline import pipeline_blocks, stage_blocks

    _join_group(rank, world, init_file)
    # the one-process run's threads (tests/torch_helpers.py), so that each
    # reduction sums in the same order
    torch.set_num_threads(2)
    cases = torch.load(cases_path, weights_only=False)
    try:
        out = {}
        for name, case in cases.items():
            blocks = (mlp_stack(case["mlp"]) if "mlp" in case else
                      pvt_stack(case["states"], dtype=case["dtype"]))
            out[name] = run_pipeline(blocks, case["x"], case["micro"],
                                     "pipe")
            out[name]["held"] = len(stage_blocks(blocks))
        blocks = pvt_stack(cases["pvt"]["states"])
        x = cases["pvt"]["x"]
        refusals = []
        for args in ((blocks[:3], x, 2), (blocks, x[:3], 2)):
            try:
                pipeline_blocks(args[0], args[1], PP_H, PP_W, args[2])
            except ValueError as e:
                refusals.append(str(e))
        out["refusals"] = refusals
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
