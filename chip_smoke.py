#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and ``nvcc``. It
needs one card and no arguments, and it imports nothing of JAX. In order:

1. requires ``torch.cuda.is_available()`` and prints the card's
   ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``emip_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and prints the build time;
3. turns TF32 off for matmuls and cuDNN convolutions (fp32 comparisons);
4. kernel phase: each forward kernel A-D against its plain PyTorch version
   on the same seeded CUDA tensors, at the production shapes of the 352^2
   path at batch 8 (A at all four PVT stages, B with and without the shift
   mask), with the tolerance stated, and CUDA-event times of both;
5. backward phase: each backward kernel A-D against torch.autograd.grad of
   the plain version on the same seeded cotangent, at the train step's
   shapes (B also with its weight grads, C also with dv), with the
   tolerance stated and CUDA-event times of the backward alone; kernel E
   against its plain scatter_add_ version (density atol and the fraction
   of occlusion-mask bits that flip);
6. slice phase: the full pvt_v2_b5 EMIPShort at 352^2 on seeded random
   weights runs ``predict_arrays`` on batches of 8 seeded frame pairs; the
   kernel launch counts of that run must equal what the model structure
   implies; one pair's mask logits and forward flow are compared with the
   same weights run on the CPU through the plain versions; frames/s
   (median of CUDA-event timed batches) and peak memory are printed;
7. train phase: first one pair, the seeded weights on the card and on the
   CPU: loss values and the seg-loss grads of every trainable leaf. Then
   the same model takes 1 + 5 train steps at batch 8 (drop path 0.1 from a
   seeded generator, GMFlow frozen, clamp + AdamW); the launch counts per
   step must match the structure (forward as above; backward A 61, B 6,
   C 3, D 1; E 2); GMFlow must stay bit-identical, every trainable leaf
   with a grad must move, the losses must be finite; median ms/step,
   pairs/s and peak memory are printed;
8. entry-point phase: ``python -m emip_tpu_torch.train`` (in process) on a
   synthetic dataset the port writes, b5 at 352^2, batch 8, one epoch of 2
   steps, validation and a checkpoint.

It prints one JSON line with the nine kernels' numbers (per kernel:
launches in the train phase, the largest max_abs_err of its cases, and
``ms`` / ``plain_ms`` summed over its cases, one call each), and as its
last line ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is non-zero, with no result line. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 8            # frame pairs per batch
SIZE = 352
TIMED_BATCHES = 5
TIMED_STEPS = 5
KERNEL_REPS = 10
SEED = 0

# per-kernel tolerances (kernel vs. plain PyTorch, both fp32 on the card):
# sums run in another order, through softmax, LayerNorm and FFN chains
KERNEL_TOL = {
    "sr_attention": dict(rtol=1e-3, atol=1e-3),
    "window_attention_block": dict(rtol=1e-3, atol=2e-3),
    "flow_attention": dict(rtol=1e-3, atol=2e-3),
    "convex_upsample": dict(rtol=1e-4, atol=1e-3),
}
# card (CUDA kernels) vs. CPU (plain versions), same weights, one pair:
# the tolerances of tests/test_full_model_parity.py, and besides
# max|err| <= SLICE_REL_MAX * max|ref|, because with zero biases the seeded
# mask logits are small (|ref| ~ 0.06) and atol alone would not see a fault
SLICE_TOL = {"mask": dict(rtol=1e-3, atol=1e-2),
             "flow_fw": dict(rtol=1e-3, atol=2e-2)}
SLICE_REL_MAX = 1e-3
# train step, card vs CPU on one pair: loss values (fp32 through the whole
# model and both losses) and seg-loss grads per trainable leaf by
# max|err| / max(max|ref|, 1e-6 * largest leaf), the tolerance of
# tests/test_grad_parity.py. At b5 this is close to what fp32 allows: a
# BatchNorm output within rounding of 0 takes the other side of the next
# ReLU, which moves that BatchNorm's bias grad (a sum that nearly cancels)
# by several percent (for the seeded pair, conv_corr.1.bias differs by
# 8.2e-2 between the CPU's fp32 and fp64 grads, by 5.2e-2 between card and
# CPU). The comparison runs on the seeded weights, before any step: the
# card's grads then repeat to 1e-4 from run to run, whereas after the steps
# the weights depend on the order of atomic adds and the reading varied
# from 2.8e-2 to 7.0e-2
TRAIN_LOSS_RTOL = 1e-3
SEG_GRAD_RTOL = 8e-2

# backward kernels vs. torch.autograd.grad of the plain version: the
# largest max|err| / max|plain| over a case's grads (fp32 sums in another
# order; weight grads sum over ~10^5 rows)
BWD_REL_TOL = 1e-3
# kernel E: atomics add in a varying order (last-bit differences of a
# density of order 1), and the 0.2 occlusion threshold may flip a few bits
SPLAT_ATOL = 1e-5
SPLAT_FLIP_MAX = 1e-4

# kernel A at the four PVT stages of pvt_v2_b5 at 352^2: N, M, C, heads
SR_STAGES = ((7744, 121, 64, 1), (1936, 121, 128, 2), (484, 121, 320, 5),
             (121, 121, 512, 8))
FWD_KERNELS = ("sr_attention", "window_attention_block", "flow_attention",
               "convex_upsample")
WIN_SELF = ("wq", "wk", "wv", "wm", "s1", "b1")
WIN_CROSS = WIN_SELF + ("w0", "w2", "s2", "b2")

KERNEL_INFO = {
    "sr_attention": ("emip_tpu_torch/csrc/sr_attention.cu",
                     "emip_tpu/ops/pallas/sr_attention.py:201"),
    "window_attention_block": ("emip_tpu_torch/csrc/window_attention.cu",
                               "emip_tpu/ops/pallas/window_attention.py:1251"),
    "flow_attention": ("emip_tpu_torch/csrc/flow_attention.cu",
                       "emip_tpu/ops/pallas/corr_softmax.py:204"),
    "convex_upsample": ("emip_tpu_torch/csrc/convex_upsample.cu",
                        "emip_tpu/ops/pallas/convex_upsample.py:85"),
    "sr_attention_bwd": ("emip_tpu_torch/csrc/sr_attention.cu",
                         "emip_tpu/ops/pallas/sr_attention.py:236"),
    "window_attention_block_bwd": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:1269"),
    "flow_attention_bwd": ("emip_tpu_torch/csrc/flow_attention.cu",
                           "emip_tpu/ops/pallas/corr_softmax.py:279"),
    "convex_upsample_bwd": ("emip_tpu_torch/csrc/convex_upsample.cu",
                            "emip_tpu/ops/pallas/convex_upsample.py:178"),
    "splat_density": ("emip_tpu_torch/csrc/splat.cu",
                      "emip_tpu/ops/pallas/splat.py:89"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate_ms(kernel, plain, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain,
    each the mean of its two turns."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def record(results: dict, name: str, label: str, err: float, ms: float,
           plain_ms: float, **extra) -> None:
    """Add one case to its kernel's entry: the largest max_abs_err, and
    ms / plain_ms summed over the cases."""
    entry = results.setdefault(name, dict(max_abs_err=0.0, ms=0.0,
                                          plain_ms=0.0, cases=[]))
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms"] += ms
    entry["plain_ms"] += plain_ms
    entry["cases"].append(dict(case=label, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, **extra))


# ------------------------------------------------------------ kernels


def seeded_randn(seed: int, device):
    """r(*shape, scale=1.0): fp32 normal tensors on ``device`` from one
    numpy generator."""
    import torch

    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(device)

    return r


def sr_args(r, batch: int, n: int, m: int, c: int, heads: int) -> tuple:
    s = c**-0.5
    return (r(batch, n, c), r(batch, m, c), r(c, c, scale=s),
            r(c, scale=0.1), r(2 * c, c, scale=s), r(2 * c, scale=0.1),
            r(c, c, scale=s), r(c, scale=0.1), heads)


def window_params(r, c: int = 128, f: int = 1024) -> tuple[dict, dict]:
    """Self-layer and cross-layer (with FFN) parameters of one block."""
    s = c**-0.5

    def layer():
        return dict(wq=r(c, c, scale=s), wk=r(c, c, scale=s),
                    wv=r(c, c, scale=s), wm=r(c, c, scale=s),
                    s1=1.0 + r(c, scale=0.1), b1=r(c, scale=0.1))

    sp, cp = layer(), layer()
    cp.update(w0=r(f, 2 * c, scale=(2 * c)**-0.5), w2=r(c, f, scale=f**-0.5),
              s2=1.0 + r(c, scale=0.1), b2=r(c, scale=0.1))
    return sp, cp


def kernel_cases(batch: int, device):
    """(kernel, case label, kernel fn, plain fn, args) at the 352^2 shapes."""
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED, device)
    cases = []
    for n, m, c, heads in SR_STAGES:
        cases.append(("sr_attention", f"N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      sr_args(r, batch, n, m, c, heads)))

    c, tok, k2 = 128, 484, 4
    x, t = r(2 * batch, k2, tok, c), r(2 * batch, k2, tok, c)
    sp, cp = window_params(r, c)
    mask = shifted_window_mask(44, 44, 2, device=device)
    for label, msk in (("unshifted", None), ("shifted mask", mask)):
        cases.append(("window_attention_block",
                      f"[{2 * batch},{k2},{tok},{c}] {label}",
                      K.fused_window_attention_block,
                      K.fused_window_attention_block_reference,
                      (x, t, sp, cp, msk)))

    L = 1936
    cases.append(("flow_attention", f"[{2 * batch},{L},128] v=[...,2]",
                  K.fused_flow_attention, K.fused_flow_attention_reference,
                  (r(2 * batch, L, 128), r(2 * batch, L, 128),
                   r(2 * batch, L, 2, scale=10.0))))
    cases.append(("convex_upsample", f"flow [{2 * batch},44,44,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * batch, 44, 44, 2, scale=3.0),
                   r(2 * batch, 44, 44, 576), 8)))
    return cases


def kernel_phase(batch: int, device, reps: int) -> dict:
    import torch

    results = {}
    for name, label, fn, ref, args in kernel_cases(batch, device):
        got = fn(*args)
        torch.cuda.synchronize()
        want = ref(*args)
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL[name]
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, **tol)
        ms, plain_ms = alternate_ms(lambda: fn(*args), lambda: ref(*args),
                                    reps)
        log(f"kernel {name:24s} {label:32s} max_abs_err={err:.3e} "
            f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} ({label}) disagrees with its plain "
                                 f"version: max_abs_err={err}, tol={tol}")
        record(results, name, label, err, ms, plain_ms)
        del got, want
    return results


# ---------------------------------------------------- backward kernels


def backward_cases(batch: int, device):
    """(kernel, label, kernel fn, plain fn, args, indices of the args that
    take a gradient) at the shapes of the 352^2 train step."""
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + 2, device)
    cases = []
    for n, m, c, heads in SR_STAGES:
        cases.append(("sr_attention_bwd", f"N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      sr_args(r, batch, n, m, c, heads), tuple(range(8))))

    c, tok, k2 = 128, 484, 4
    x, t = r(2 * batch, k2, tok, c), r(2 * batch, k2, tok, c)
    sp, cp = window_params(r, c)
    mask = shifted_window_mask(44, 44, 2, device=device)

    def block(x, t, *p, mask=None):
        return K.fused_window_attention_block(
            x, t, dict(zip(WIN_SELF, p[:6])), dict(zip(WIN_CROSS, p[6:])),
            mask)

    def block_ref(x, t, *p, mask=None):
        return K.fused_window_attention_block_reference(
            x, t, dict(zip(WIN_SELF, p[:6])), dict(zip(WIN_CROSS, p[6:])),
            mask)

    params = [sp[k] for k in WIN_SELF] + [cp[k] for k in WIN_CROSS]
    for label, msk in (("unshifted", None), ("shifted mask", mask)):
        for wgrads in (False, True):
            fn = functools.partial(block, mask=msk)
            ref = functools.partial(block_ref, mask=msk)
            which = tuple(range(2 + len(params))) if wgrads else (0, 1)
            cases.append((
                "window_attention_block_bwd",
                f"[{2 * batch},{k2},{tok},{c}] {label}, "
                f"{'x t + weight' if wgrads else 'x t'} grads",
                fn, ref, (x, t, *params), which))

    L = 1936
    for b, label, which in ((batch, "matching", (0, 1)),
                            (2 * batch, "propagation", (0, 1)),
                            (2 * batch, "propagation with dv", (0, 1, 2))):
        cases.append(("flow_attention_bwd", f"[{b},{L},128] v=[...,2] {label}",
                      K.fused_flow_attention,
                      K.fused_flow_attention_reference,
                      (r(b, L, 128), r(b, L, 128), r(b, L, 2, scale=10.0)),
                      which))
    cases.append(("convex_upsample_bwd", f"flow [{2 * batch},44,44,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * batch, 44, 44, 2, scale=3.0),
                   r(2 * batch, 44, 44, 576), 8), (0, 1)))
    return cases


def _grads(fn, args, which, cot):
    """(forward output, fn's grads w.r.t. args[which] for cotangent cot,
    a callable that reruns the backward only)."""
    import torch

    leaves = [a.detach().requires_grad_(i in which) if torch.is_tensor(a)
              else a for i, a in enumerate(args)]
    wrt = [leaves[i] for i in which]
    out = fn(*leaves)
    gcot = cot(out)
    grads = torch.autograd.grad(out, wrt, gcot, retain_graph=True)

    def rerun():
        return torch.autograd.grad(out, wrt, gcot, retain_graph=True)

    return out, grads, rerun


def backward_phase(batch: int, device, reps: int) -> dict:
    """Each backward kernel against torch.autograd.grad of its plain
    version on the same seeded inputs and cotangent; CUDA-event times of
    the backward alone (the graph is built once and kept)."""
    import torch

    results = {}
    for name, label, fn, ref, args, which in backward_cases(batch, device):
        gen = torch.Generator(device=device).manual_seed(SEED + 3)

        def cot(out):
            return torch.randn(out.shape, generator=gen, device=device)

        out_k, got, rerun_k = _grads(fn, args, which, cot)
        gen.manual_seed(SEED + 3)
        out_p, want, rerun_p = _grads(ref, args, which, cot)
        if out_k.grad_fn is None:
            raise AssertionError(f"{name}: the CUDA output has no grad_fn")
        torch.cuda.synchronize()
        # largest over the grads of max|err| / max|plain|: weight grads sum
        # over ~10^5 rows, so an absolute tolerance has no fixed scale
        rel, err = 0.0, 0.0
        for g, w in zip(got, want):
            e = (g - w).abs().max().item()
            err = max(err, e)
            rel = max(rel, e / max(w.abs().max().item(), 1e-30))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ok = finite and rel <= BWD_REL_TOL
        ms, plain_ms = alternate_ms(rerun_k, rerun_p, reps)
        log(f"kernel {name:28s} {label:44s} max_abs_err={err:.3e} "
            f"max_rel={rel:.3e} (tol {BWD_REL_TOL}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} ({label}) disagrees with the plain "
                                 f"backward: max_rel={rel}")
        record(results, name, label, err, ms, plain_ms, max_rel=rel)
        del out_k, out_p, got, want, rerun_k, rerun_p
    splat_case(results, batch, device, reps)
    return results


def splat_case(results: dict, batch: int, device, reps: int) -> None:
    """Kernel E against its plain scatter_add_ version on one [B, 352,
    352, 2] coordinate field (pixel grid + seeded flow, as the occlusion
    mask builds it): density max_abs_err, and the fraction of occlusion
    bits (density clipped to [0, 1] < 0.2) that flip."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.geometry import coords_grid

    rng = np.random.default_rng(SEED + 4)
    flow = torch.from_numpy(
        (rng.standard_normal((batch, SIZE, SIZE, 2)) * 4).astype(np.float32))
    coords = (coords_grid(SIZE, SIZE)[None] + flow).to(device)
    got = K.splat_density(coords)
    want = K.splat_density_reference(coords)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    occ = lambda d: torch.clamp(d, 0.0, 1.0) < 0.2  # noqa: E731
    flips = (occ(got) != occ(want)).float().mean().item()
    ok = (bool(torch.isfinite(got).all()) and err <= SPLAT_ATOL
          and flips <= SPLAT_FLIP_MAX)
    ms, plain_ms = alternate_ms(lambda: K.splat_density(coords),
                                lambda: K.splat_density_reference(coords),
                                reps)
    label = f"coords [{batch},{SIZE},{SIZE},2]"
    log(f"kernel {'splat_density':28s} {label:44s} max_abs_err={err:.3e} "
        f"(atol {SPLAT_ATOL}) mask flips={flips:.3e} (limit "
        f"{SPLAT_FLIP_MAX}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"splat_density disagrees with its plain "
                             f"version: err={err}, flips={flips}")
    record(results, "splat_density", label, err, ms, plain_ms,
           mask_flips=flips)


# --------------------------------------------------------------- slice


def expected_launches(model, train: bool = False) -> dict:
    """Kernel launches per forward (``train``: per train step) implied by
    the model's structure."""
    from emip_tpu_torch import kernels as K

    pvt = model.backbone.feat_net.pvtv2_en
    depths = pvt.config.depths
    n = {k: 0 for k in K.LAUNCHES}
    n.update(sr_attention=2 * sum(depths),  # every PVT block, both frames
             window_attention_block=len(model.GMFlow.transformer.layers),
             flow_attention=3 if model.GMFlow.config.pred_bidir_flow else 2,
             convex_upsample=1)
    if train:
        # backward: every block of frame 1; of frame 2 only the stages up
        # to /8, whose output feeds the camouflage feeder (its /16 and /32
        # features do not reach the loss)
        n.update(sr_attention_bwd=sum(depths) + depths[0] + depths[1],
                 window_attention_block_bwd=n["window_attention_block"],
                 flow_attention_bwd=n["flow_attention"],
                 convex_upsample_bwd=1,
                 splat_density=2)  # occlusion masks of both directions
    return n


def seeded_frames(rng, n: int, size: int) -> np.ndarray:
    from emip_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

    img = rng.uniform(0.0, 1.0, (n, 3, size, size)).astype(np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)[:, None, None]
    std = np.asarray(IMAGENET_STD, np.float32)[:, None, None]
    return (img - mean) / std


def slice_phase(model, batch: int, size: int, device, timed: int) -> dict:
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.infer import predict_arrays

    rng = np.random.default_rng(SEED + 1)
    n_batches = 1 + timed  # one warm-up batch, then the timed ones
    frames = [(torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
               torch.from_numpy(seeded_frames(rng, batch, size)).to(device))
              for _ in range(n_batches)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    K.reset_launches()
    times, outputs = [], []
    for i, (a, b) in enumerate(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mask, flow = predict_arrays(model, a, b)
        end.record()
        torch.cuda.synchronize()
        if i > 0:
            times.append(start.elapsed_time(end))
        outputs.append((mask, flow))
    launches = dict(K.LAUNCHES)

    per_fwd = expected_launches(model)
    want = {k: v * n_batches for k, v in per_fwd.items()}
    log(f"slice launches {launches} (expected {want})")
    if launches != want or min(launches[k] for k in FWD_KERNELS) == 0:
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    for mask, flow in outputs:
        if tuple(mask.shape) != (batch, 1, size, size):
            raise AssertionError(f"mask shape {tuple(mask.shape)}")
        if tuple(flow.shape) != (batch, 2, size, size):
            raise AssertionError(f"flow shape {tuple(flow.shape)}")
        if not (torch.isfinite(mask).all() and torch.isfinite(flow).all()):
            raise AssertionError("non-finite outputs")
    median_ms = statistics.median(times)
    fps = batch / (median_ms / 1e3)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"slice b5 {size}^2 bs={batch} fp32: median {median_ms:.3f} ms/batch "
        f"over {len(times)} batches -> {fps:.3f} frames/s; peak memory "
        f"{peak / 2**30:.3f} GiB")

    # the same weights on the CPU, through the plain versions, one pair
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    a, b = frames[0]
    ref_mask, ref_flow = predict_arrays(cpu_model, a[:1].cpu(), b[:1].cpu())
    cmp = {}
    for name, got, ref in (("mask", outputs[0][0][:1], ref_mask),
                           ("flow_fw", outputs[0][1][:1], ref_flow)):
        got = got.cpu()
        diff = (got - ref).abs()
        tol = SLICE_TOL[name]
        # worst |err| / (atol + rtol |ref|): the comparison passes at <= 1
        worst = (diff / (tol["atol"] + tol["rtol"] * ref.abs())).max().item()
        err, ref_max = diff.max().item(), ref.abs().max().item()
        rel = err / ref_max if ref_max > 0 else float("inf")
        ok = torch.allclose(got, ref, **tol) and rel <= SLICE_REL_MAX
        cmp[name] = dict(max_abs_err=err, ref_max_abs=ref_max,
                         worst_tol_ratio=worst, rel_to_max=rel, tol=tol,
                         rel_max=SLICE_REL_MAX, ok=ok)
        log(f"slice {name} card vs CPU plain: max_abs_err={err:.3e} "
            f"(|ref| max {ref_max:.3e}) tol={tol} worst err/tol={worst:.3f}; "
            f"max|err|/max|ref|={rel:.3e} (limit {SLICE_REL_MAX}) "
            f"{'ok' if ok else 'MISMATCH'}")
    log(f"CPU reference pair took {time.perf_counter() - t0:.1f} s")
    bad = [k for k, v in cmp.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"card disagrees with the CPU reference: {bad}")
    return dict(launches=launches, expected=want, median_ms=median_ms,
                batch_ms=times, frames_per_s=fps, peak_bytes=peak,
                compare=cmp)


# --------------------------------------------------------------- train


def seeded_batch(rng, batch: int, size: int, device) -> dict:
    import torch

    gt = (rng.uniform(size=(batch, 1, size, size)) > 0.5).astype(np.float32)
    return dict(
        image1=torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
        image2=torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
        gt=torch.from_numpy(gt).to(device))


def train_phase(model, batch: int, size: int, device, timed: int) -> dict:
    """Train steps of the full model: 1 warm-up, then ``timed`` steps
    timed with CUDA events; kernel launch counts per step against the
    structure; GMFlow untouched; every trainable leaf with a grad moved."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    opt = build_optimizer(model)  # lr 1e-5, wd 1e-7, clamp 0.5; GMFlow frozen
    gmflow0 = {k: v.clone() for k, v in model.GMFlow.state_dict().items()}
    trainable0 = {n: p.detach().clone() for n, p in model.named_parameters()
                  if p.requires_grad}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    if not frozen or any(not n.startswith("GMFlow.") for n in frozen):
        raise AssertionError("the frozen set is not exactly GMFlow")
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 5)
    steps = 1 + timed
    batches = [seeded_batch(rng, batch, size, device) for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    K.reset_launches()
    times, losses = [], []
    for i, b in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = short_train_step(model, opt, b, gen)
        end.record()
        torch.cuda.synchronize()
        if i > 0:
            times.append(start.elapsed_time(end))
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(K.LAUNCHES)
    want = {k: v * steps for k, v in expected_launches(model, True).items()}
    log(f"train launches {launches} (expected {want})")
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"train launch counts {launches} != {want}")

    for i, m in enumerate(losses):
        log(f"train step {i}: " + " ".join(f"{k}={v:.6f}"
                                            for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite losses at step {i}: {m}")
    gm = model.GMFlow.state_dict()
    if any(not torch.equal(gm[k], v) for k, v in gmflow0.items()):
        raise AssertionError("a frozen GMFlow tensor changed")
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None
             and torch.equal(p.detach(), trainable0[n])]
    with_grad = sum(p.requires_grad and p.grad is not None
                    for p in model.parameters())
    if still or with_grad == 0:
        raise AssertionError(f"trainable leaves with a grad that did not "
                             f"move: {still[:8]}")
    median_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"train b5 {size}^2 bs={batch} fp32: median {median_ms:.3f} ms/step "
        f"over {len(times)} steps -> {batch / (median_ms / 1e3):.3f} pairs/s; "
        f"peak memory {peak / 2**30:.3f} GiB; {with_grad} trainable leaves "
        f"with grads all moved, {len(frozen)} GMFlow tensors bit-identical")
    del opt
    return dict(launches=launches, expected=want, median_ms=median_ms,
                step_ms=times, pairs_per_s=batch / (median_ms / 1e3),
                peak_bytes=peak, losses=losses,
                leaves_with_grad=with_grad)


def _seg_grads(model, batch) -> tuple[dict, dict]:
    """Loss values and d(seg loss)/d(trainable leaves) of one train-mode
    forward (no optimizer step)."""
    import torch

    from emip_tpu_torch.train.short import short_losses

    model.train()
    out = short_losses(model, batch)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(out["loss_pred"], params, allow_unused=True)
    return ({k: float(v.detach()) for k, v in out.items()},
            {n: g.detach().cpu() for n, g in zip(names, grads)
             if g is not None})


def train_compare_phase(model, size: int, device) -> dict:
    """One pair, the seeded weights, card kernels vs CPU plain versions:
    loss values, and the seg-loss grads of every trainable leaf (GMFlow
    frozen) by the scale-floored relative max of
    tests/test_grad_parity.py. Drop path is off (the two devices'
    generators differ)."""
    import dataclasses

    import torch

    from emip_tpu_torch.train.state import freeze_gmflow

    freeze_gmflow(model)
    pvt_cfg = model.backbone.feat_net.pvtv2_en.config
    model.backbone.feat_net.pvtv2_en.config = dataclasses.replace(
        pvt_cfg, drop_path_rate=0.0)
    rng = np.random.default_rng(SEED + 6)
    batch = seeded_batch(rng, 1, size, device)
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    loss_c, grads_c = _seg_grads(model, batch)
    loss_p, grads_p = _seg_grads(cpu_model, {k: v.cpu()
                                             for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    model.backbone.feat_net.pvtv2_en.config = pvt_cfg
    del cpu_model

    bad = []
    for k in ("loss_pred", "loss_flow"):
        rel = abs(loss_c[k] - loss_p[k]) / max(abs(loss_p[k]), 1e-30)
        log(f"train {k} card {loss_c[k]:.7f} vs CPU {loss_p[k]:.7f}: "
            f"rel {rel:.3e} (tol {TRAIN_LOSS_RTOL})")
        if not rel <= TRAIN_LOSS_RTOL:
            bad.append(k)
    if set(grads_c) != set(grads_p):
        raise AssertionError("card and CPU grads cover different leaves")
    scale = max(g.abs().max().item() for g in grads_p.values())
    floor = 1e-6 * scale
    rels = {n: (grads_c[n] - grads_p[n]).abs().max().item()
            / max(grads_p[n].abs().max().item(), floor) for n in grads_p}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    log(f"train seg-loss grads card vs CPU over {len(rels)} leaves: worst "
        f"relmax {worst[0][1]:.3e} (tol {SEG_GRAD_RTOL}); top: "
        + ", ".join(f"{n}={r:.2e}" for n, r in worst)
        + f"; CPU side took {cpu_s:.1f} s")
    bad += [n for n, r in rels.items() if not r <= SEG_GRAD_RTOL]
    if bad:
        raise AssertionError(f"card disagrees with the CPU reference: "
                             f"{bad[:8]}")
    return dict(losses_card=loss_c, losses_cpu=loss_p, leaves=len(rels),
                worst=worst, cpu_seconds=cpu_s)


def entry_phase(batch: int, size: int) -> dict:
    """``python -m emip_tpu_torch.train`` (in process) on a synthetic root
    that the port writes: b5 at 352^2, 1 epoch of 2 steps, validation
    over the root's pairs, a checkpoint written."""
    import yaml

    from emip_tpu_torch.data import make_synthetic_video_root
    from emip_tpu_torch.train.__main__ import main as train_main

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    root = make_synthetic_video_root(os.path.join(work, "data"),
                                     num_videos=2, frames_per_video=10,
                                     seed=SEED)
    cfg = dict(
        train_dataset=dict(image_path=root, gt_path=root, inp_size=size,
                           batch_size=batch, dataset_type="MoCA"),
        val_dataset=dict(image_path=root, gt_path=root, inp_size=size,
                         batch_size=1, dataset_type="MoCA"),
        model=dict(args=dict(inp_size=size, backbone_name="pvt_v2_b5",
                             channel=32)),
        optimizer=dict(lr=1.0e-5, weight_decay=1.0e-7),
        clip=0.5, seed=SEED, epoch=2, epoch_val=1, epoch_save=1,
        save_path=os.path.join(work, "run"))
    os.makedirs(work, exist_ok=True)
    cfg_path = os.path.join(work, "train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    summary = train_main(["--config", cfg_path, "--max_steps_per_epoch",
                          "2"])
    dt = time.perf_counter() - t0
    ckpt = os.path.join(work, "run", "ckpt", "ckpt.pt")
    ok = (summary["steps"] == 2 and os.path.exists(ckpt)
          and np.isfinite(summary["best_mae"]))
    log(f"entry python -m emip_tpu_torch.train: {summary['steps']} steps, "
        f"val MAE {summary['best_mae']:.5f}, checkpoint "
        f"{'written' if os.path.exists(ckpt) else 'MISSING'}, {dt:.1f} s "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"train entry point failed: {summary}")
    return dict(summary=summary, seconds=dt)


# ---------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.kernels._build import build_seconds
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_

    device = torch.device("cuda:0")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    K.library()
    log(f"kernel build + load: {build_seconds():.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels = kernel_phase(BATCH, device, KERNEL_REPS)
    kernels.update(backward_phase(BATCH, device, KERNEL_REPS))

    model = EMIPShort(EMIPShortConfig(backbone_name="pvt_v2_b5",
                                      inp_size=SIZE))
    seeded_init_(model, SEED)
    model = model.to(device).eval()
    slice_res = slice_phase(model, BATCH, SIZE, device, TIMED_BATCHES)
    compare_res = train_compare_phase(model, SIZE, device)
    train_res = train_phase(model, BATCH, SIZE, device, TIMED_STEPS)
    del model
    torch.cuda.empty_cache()
    entry_res = entry_phase(BATCH, SIZE)

    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNEL_INFO[name][0],
             replaces=KERNEL_INFO[name][1],
             launches=train_res["launches"][name],
             max_abs_err=kernels[name]["max_abs_err"],
             ms=kernels[name]["ms"], plain_ms=kernels[name]["plain_ms"])
        for name in KERNEL_INFO]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, slice=slice_res,
                       train=train_res, train_compare=compare_res,
                       entry=entry_res), f, indent=1, default=str)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
