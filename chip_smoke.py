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
4. kernel phase: each forward kernel A-D and F-J against its plain PyTorch
   version on the same seeded CUDA tensors, at the production shapes of
   the 352^2 path (A at all four PVT stages, B with and without the shift
   mask, at batch 8; F at 1 and 4 clips with 1, 3 and 5 written slots,
   with every slot empty at a small size, and at the 512^2 shape; J at the
   four MixFFN stages; I at [8, 1936, 1936]) and of the 512^2 path (A with
   256 reduced keys, C at L = 4096, D at 64 x 64, I at [4, 4096, 4096], G
   with and without the residual and H at windows of 1024 tokens, with and
   without the mask, at 1 and 4 clips, and once at 484 tokens; C also at a
   ragged token count at channel widths 128 and 64, from inputs of their
   own and kept out of C's summed row), with the tolerance stated, and
   CUDA-event times of the kernel, the plain version and, where one
   PyTorch call computes the same function
   (``scaled_dot_product_attention`` for C and F), that call. G and H have
   no such call; for I (``softmax`` then ``matmul``) and J (``conv2d``
   then ``gelu``) it would take two, so they have none either. C's and F's
   forward must give the same bits on a second call;
5. backward phase: each backward kernel A-D and F-J against
   torch.autograd.grad of the plain version on the same seeded cotangent,
   at the train steps' shapes (B, G and H with input grads alone and with
   their weight grads, C also with dv, F with all three grads and with dq
   alone, I with dcorr alone and with dvalues, J with gu, tap and bias
   grads), with the tolerance stated and CUDA-event times of the backward
   alone; C and F also at the 512^2 train steps' shapes ([4, 4096, 128];
   [1, 4096, 128] x [1, 20480, 128]) and at a small ragged one each (F's
   with every slot empty), and for both a second call on the same inputs
   must give the same bits; kernel E against its plain scatter_add_ version
   (density atol and the fraction of occlusion-mask bits that flip); the
   cost of the transpose that read-corr matching hands kernel I and of the
   row statistics kernel C's forward keeps for its backward;
6. tiny phase: the configuration of the CPU tests (pvt_v2_b0 at 64^2,
   64-d flow features: A at head width 32, B, C and F at width 64) on
   seeded weights: a short forward, one pair's seg-loss grads, one short
   train step and a 3-frame clip and one frame's head grads of the long
   model, each against the CPU's plain versions with the slice's
   tolerances, and launch counts that show A-D (and F) ran;
7. slice phase: the full pvt_v2_b5 EMIPShort at 352^2 on seeded random
   weights runs ``predict_arrays`` on batches of 8 seeded frame pairs; the
   kernel launch counts of that run must equal what the model structure
   implies; one pair's mask logits and forward flow are compared with the
   same weights run on the CPU through the plain versions; frames/s
   (median of CUDA-event timed batches) and peak memory are printed;
8. train phase: first one pair, the seeded weights on the card and on the
   CPU: loss values and the seg-loss grads of every trainable leaf. Then
   the same model takes 1 + 5 train steps at batch 8 (drop path 0.1 from a
   seeded generator, GMFlow frozen, clamp + AdamW); the launch counts per
   step must match the structure (forward as above; backward A 61, B 6,
   C 3, D 1; E 2); GMFlow must stay bit-identical, every trainable leaf
   with a grad must move, the losses must be finite; median ms/step,
   pairs/s and peak memory are printed;
9. kernel-switch phases, each beside the default configuration on the same
   weights and inputs, in turns: read-corr matching
   (``global_match_qk_fused=False``: I 2 per forward and C 1, I backward 2
   per train step) and the fused MixFFN (``fused_ffn="always"``: J 104 per
   forward; ``ffn_dwconv="bwd_fused"``: J backward 61 per train step);
   mask, flow and train losses must equal the default's within the slice
   and loss tolerances; frames/s and ms/step of both are printed;
10. entry-point phase: ``python -m emip_tpu_torch.train`` (in process) on
    a synthetic dataset the port writes, b5 at 352^2, batch 8, one epoch
    of 2 steps, validation and a checkpoint;
11. long inference phase: the full EMIPLong (b5, 352^2, 5 memory slots) on
    seeded weights streams seeded clips through ``step_cached``, one clip
    at a time and four side by side; launch counts against the structure
    (A 52 per encoded frame, B 6, C 3, D 1 per pair, F 1 per read);
    frames/s with the ring full and peak memory; one 3-frame clip's short
    mask, long masks and memory against the CPU plain versions;
12. long train phase: one frame's loss and head grads, card against CPU,
    on the seeded weights; then 1 + 5 per-frame train steps at 4 clips and
    at 1: F forward and backward once per step and no backward launch of
    A-D; every ``short_term`` tensor and buffer bit-identical afterwards,
    every trainable leaf moved, finite losses; ms/frame and peak memory;
13. long entry points: ``python -m emip_tpu_torch.train_long`` and
    ``python -m emip_tpu_torch.test_long`` (in process) on a synthetic
    root: 4 per-frame steps, validation, checkpoints, 12 PNGs;
14. 512^2 phases, where a swin window holds 1024 tokens and the flow
    transformer runs kernels G and H in place of B: 1 + 2 short train steps
    at batch 2 (G and H forward and backward 6 each per step, none of B;
    the checks of phase 8), then the long inference phase at 512^2 (G 6,
    H 6, B 0 per step; card against CPU as in phase 11).

It prints one JSON line with the nineteen kernels' numbers (per kernel:
launches in the phase that is its main path, the largest max_abs_err of
its cases, and ``ms`` / ``plain_ms`` / ``library_ms`` / ``bound_ms`` summed
over its cases, one call each; ``bound_ms`` is the larger of the case's
operations over the card's fp32 peak and its bytes over the memory rate,
``bound_by`` says which; C and F, forward and backward, run their products
on the tensor cores as 3xTF32, so their ``bound_ms`` takes the operations
over a third of the TF32 peak (``bound_rate: "tf32x3"``), below which no
time may lie, and the CUDA cores' figure stands beside it as
``fp32_bound_ms``),
and as its last line ``{"ok": true, "device":
{...}}``. Any failure raises and the exit code is non-zero, with no result
line. Details also go to ``chiprun_out/chip_smoke.json``. ``--kernels
NAMES`` is a development aid: the kernel phases alone, for the kernels
whose name contains one of the comma-separated NAMES.
"""

from __future__ import annotations

import copy
import dataclasses
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
SIZE_512 = 512       # the second published size: windows of 1024 tokens
TRAIN_BATCH_512 = 2
TIMED_STEPS_512 = 2
VARIANT_TIMED = 3    # timed batches / steps of a kernel-switch variant
TIMED_BATCHES = 5
TIMED_STEPS = 5
KERNEL_REPS = 10
SEED = 0

# per-kernel tolerances (kernel vs. plain PyTorch, both fp32 on the card):
# sums run in another order, through softmax, LayerNorm and FFN chains
KERNEL_TOL = {
    "sr_attention": dict(rtol=1e-3, atol=1e-3),
    "window_attention_block": dict(rtol=1e-3, atol=2e-3),
    "window_attention_layer": dict(rtol=1e-3, atol=2e-3),
    "window_attention_ffn_layer": dict(rtol=1e-3, atol=2e-3),
    "flow_attention": dict(rtol=1e-3, atol=2e-3),
    "convex_upsample": dict(rtol=1e-4, atol=1e-3),
    # outputs are pixel coordinates up to 63; the kernel's exp is the fast
    # intrinsic (relative error ~1e-6 of each weight)
    "softmax_expectation": dict(rtol=1e-4, atol=1e-3),
    # nine products per output against cuDNN's order of the same sum
    "dwconv_gelu": dict(rtol=1e-4, atol=1e-5),
    # outputs are softmax-weighted means of unit normals (|out| ~ 0.1-1)
    "memory_attention": dict(rtol=1e-3, atol=2e-5),
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
# the same at 512^2 (M = 256 reduced keys)
SR_STAGES_512 = ((16384, 256, 64, 1), (4096, 256, 128, 2),
                 (1024, 256, 320, 5), (256, 256, 512, 8))
BATCH_512 = 4        # clips streamed side by side at 512^2
# kernel J at the four MixFFN stages of pvt_v2_b5 at 352^2: side, hidden
FFN_STAGES = ((88, 256), (44, 512), (22, 1280), (11, 2048))
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
    "window_attention_layer": ("emip_tpu_torch/csrc/window_attention.cu",
                               "emip_tpu/ops/pallas/window_attention.py:231"),
    "window_attention_ffn_layer": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:812"),
    "softmax_expectation": ("emip_tpu_torch/csrc/softmax_expectation.cu",
                            "emip_tpu/ops/pallas/corr_softmax.py:86"),
    "dwconv_gelu": ("emip_tpu_torch/csrc/dwconv_gelu.cu",
                    "emip_tpu/ops/pallas/mixffn.py:167"),
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
    "memory_attention": ("emip_tpu_torch/csrc/memory_attention.cu",
                         "emip_tpu/ops/pallas/memory_attention.py:78"),
    "memory_attention_bwd": ("emip_tpu_torch/csrc/memory_attention.cu",
                             "emip_tpu/ops/pallas/memory_attention.py:159"),
    "window_attention_layer_bwd": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:389"),
    "window_attention_ffn_layer_bwd": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:835"),
    "softmax_expectation_bwd": ("emip_tpu_torch/csrc/softmax_expectation.cu",
                                "emip_tpu/ops/pallas/corr_softmax.py:142"),
    "dwconv_gelu_bwd": ("emip_tpu_torch/csrc/dwconv_gelu.cu",
                        "emip_tpu/ops/pallas/mixffn.py:181"),
}

# the card's published peaks (NVIDIA H100 SXM data sheet): fp32 outside the
# tensor cores, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# dense TF32 on the tensor cores; a 3xTF32 product spends three of them
PEAK_TF32_FLOPS = 495e12
# the kernels that run their products on the tensor cores as 3xTF32 (C and
# F, forward and backward): their bound counts the operations at a third of
# the TF32 peak, and no time may lie below it; the CUDA cores' fp32 figure,
# the bound of the other rows and of these before their redesign, stands
# beside it. Neither uses atomics: a second call must give the same bits
TENSOR_CORE_KERNELS = ("flow_attention", "flow_attention_bwd",
                       "memory_attention", "memory_attention_bwd")


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
           plain_ms: float, work: tuple[float, float],
           library_ms: float | None = None, summed: bool = True,
           **extra) -> None:
    """Add one case to its kernel's entry: the largest max_abs_err, and
    ms / plain_ms / library_ms / bound_ms summed over the cases (a case
    with ``summed`` false is listed in ``cases`` and counts in
    max_abs_err, but adds nothing to the sums). ``work`` is the case's
    (operations, bytes): the bound is the larger of operations over the
    peak rate (fp32, or 3xTF32 for the tensor-core kernels) and bytes over
    the memory rate."""
    entry = results.setdefault(name, dict(
        max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
        ops_ms=0.0, bytes_ms=0.0, cases=[]))
    ops_ms = work[0] / PEAK_FP32_FLOPS * 1e3
    bytes_ms = work[1] / PEAK_BYTES_PER_S * 1e3
    if name in TENSOR_CORE_KERNELS:
        fp32_ms = max(ops_ms, bytes_ms)
        ops_ms = work[0] / (PEAK_TF32_FLOPS / 3) * 1e3
        if ms < max(ops_ms, bytes_ms):
            raise AssertionError(f"{name} ({label}): {ms} ms is below the "
                                 f"bound {max(ops_ms, bytes_ms)} ms")
        entry.setdefault("fp32_bound_ms", 0.0)
        extra = dict(extra, fp32_bound_ms=fp32_ms, bound_rate="tf32x3")
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["cases"].append(dict(
        case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        **({} if summed else dict(summed=False)), **extra))
    if not summed:
        return
    if name in TENSOR_CORE_KERNELS:
        entry["fp32_bound_ms"] += fp32_ms
    entry["ms"] += ms
    entry["plain_ms"] += plain_ms
    entry["bound_ms"] += max(ops_ms, bytes_ms)
    entry["ops_ms"] += ops_ms
    entry["bytes_ms"] += bytes_ms
    entry["bound_by"] = ("operations" if entry["ops_ms"] >= entry["bytes_ms"]
                         else "bytes")
    if library_ms is not None:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + library_ms


def wanted(only: str, name: str) -> bool:
    """Whether kernel ``name`` is among the comma-separated substrings of
    ``only`` (every kernel when ``only`` is empty)."""
    return any(part in name for part in only.split(","))


def transpose_cost(batch: int, device, reps: int) -> dict:
    """ms of the contiguous transpose of the stored correlation that the
    read-corr matching hands kernel I for the backward flow (the kernel
    reads rows only), at the 352^2 and 512^2 shapes."""
    import torch

    out = {}
    for b, n in ((batch, 1936), (BATCH_512, 4096)):
        corr = torch.randn(b, n, n, device=device)
        out[f"[{b},{n},{n}]"] = cuda_ms(
            lambda: corr.transpose(1, 2).contiguous(), reps)
    log("read-corr matching: contiguous transpose of corr "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def stats_cost(batch: int, device, reps: int) -> dict:
    """ms of kernel C's forward without and with the row statistics it
    keeps for its backward (inputs that require a gradient), in turns, at
    the 352^2 and 512^2 shapes."""
    from emip_tpu_torch import kernels as K

    r = seeded_randn(SEED + 13, device)
    out = {}
    for b, n in ((2 * batch, 1936), (2 * BATCH_512, 4096)):
        q, k, v = r(b, n, 128), r(b, n, 128), r(b, n, 2, scale=10.0)
        qg = q.clone().requires_grad_(True)
        kept, bare = alternate_ms(lambda: K.fused_flow_attention(qg, k, v),
                                  lambda: K.fused_flow_attention(q, k, v),
                                  reps)
        out[f"[{b},{n},128]"] = dict(ms=bare, with_stats_ms=kept)
    log("flow_attention forward without / with kept row statistics: "
        + ", ".join(f"{k} {v['ms']:.4f} / {v['with_stats_ms']:.4f} ms"
                    for k, v in out.items()))
    return out


def fmt_ms(ms: float | None) -> str:
    return "none" if ms is None else f"{ms:.4f}"


def numel(*tensors) -> int:
    """Elements of the tensors among the arguments (dicts are searched)."""
    import torch

    n = 0
    for t in tensors:
        if isinstance(t, dict):
            n += numel(*t.values())
        elif torch.is_tensor(t):
            n += t.numel()
    return n


def forward_work(name: str, args, out) -> tuple[float, float]:
    """(operations, bytes) one forward call of a kernel must do: the
    products' multiply-adds counted as 2, every input read and the output
    written once in fp32."""
    nbytes = 4.0 * (numel(*args) + out.numel())
    if name == "sr_attention":
        x, kv = args[0], args[1]
        (b, n, c), m = x.shape, kv.shape[1]
        ops = 2 * b * n * c * c * 2 + 2 * b * m * c * 2 * c + 4 * b * n * m * c
    elif name == "window_attention_block":
        x = args[0]
        rows, tok, c = x.numel() // x.shape[-1], x.shape[-2], x.shape[-1]
        # the cross layer's dict, or (backward cases) the flat parameters
        w0 = (args[3]["w0"] if isinstance(args[3], dict)
              else args[2 + len(WIN_SELF) + WIN_CROSS.index("w0")])
        f = w0.shape[0]
        layer = 4 * 2 * rows * c * c + 4 * rows * tok * c
        ops = 2 * layer + 2 * rows * 2 * c * f + 2 * rows * f * c
    elif name in ("window_attention_layer", "window_attention_ffn_layer"):
        x, p = args[0], args[2]
        rows, tok, c = x.numel() // x.shape[-1], x.shape[-2], x.shape[-1]
        ops = 4 * 2 * rows * c * c + 4 * rows * tok * c
        if name == "window_attention_ffn_layer":
            w0 = p["w0"] if isinstance(p, dict) else args[2 + 6]
            ops += 2 * rows * w0.shape[0] * (2 * c + c)
    elif name == "softmax_expectation":
        # per corr element: max, exp, sum and two multiply-adds
        ops = args[0].numel() * 8
    elif name == "dwconv_gelu":
        # per element: nine multiply-adds, bias, erf and the GELU product
        ops = args[0].numel() * 28
    elif name == "flow_attention":
        b, l, c = args[0].shape
        ops = 2 * b * l * l * (c + args[2].shape[-1])
    elif name == "memory_attention":
        (b, m, c), n = args[0].shape, args[1].shape[1]
        ops = 4 * b * m * n * c
    elif name == "convex_upsample":
        # per fine pixel: softmax over 9 taps and two 9-term sums
        ops = out.numel() // 2 * (9 * 4 + 9 * 2 * 2)
    elif name == "splat_density":
        ops = args[0].numel() // 2 * 16  # four bilinear corners per pixel
    else:
        raise KeyError(name)
    return float(ops), nbytes


def backward_work(name: str, args, which, out) -> tuple[float, float]:
    """(operations, bytes) of a backward call. The attention kernels C and
    F are counted product by product: the scores and dO v^T, which every
    grad needs (the probabilities are no input, so they are recomputed),
    and one product per grad asked for. Elsewhere each forward product has
    two gradient products. Inputs and the cotangent are read once, the
    grads asked for written once."""
    base = name.removesuffix("_bwd")
    ops, _ = forward_work(base, args, out)
    if base == "memory_attention":
        ops = ops / 2 * (2 + len(which))
    elif base == "flow_attention":
        (b, l, c), dv = args[0].shape, args[2].shape[-1]
        big, small = 2.0 * b * l * l * c, 2.0 * b * l * l * dv
        ops = (big + small + big * sum(i in which for i in (0, 1))
               + small * (2 in which))
    else:
        ops = 2.0 * ops
    flat = list(args)
    nbytes = 4.0 * (numel(*args) + out.numel()
                    + numel(*(flat[i] for i in which)))
    return float(ops), nbytes


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
    cases += [("memory_attention", label, K.masked_memory_attention,
               K.masked_memory_attention_reference, args)
              for label, args in memory_cases(r, MEMORY_FWD_CASES)]

    # ---- the 512^2 shapes of A, C and D, and kernels G-J
    for n, m, c, heads in SR_STAGES_512:
        cases.append(("sr_attention",
                      f"512^2 N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      sr_args(r, BATCH_512, n, m, c, heads)))
    L = 4096
    cases.append(("flow_attention", f"[{2 * BATCH_512},{L},128] v=[...,2]",
                  K.fused_flow_attention, K.fused_flow_attention_reference,
                  (r(2 * BATCH_512, L, 128), r(2 * BATCH_512, L, 128),
                   r(2 * BATCH_512, L, 2, scale=10.0))))
    cases.append(("convex_upsample", f"flow [{2 * BATCH_512},64,64,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * BATCH_512, 64, 64, 2, scale=3.0),
                   r(2 * BATCH_512, 64, 64, 576), 8)))
    # G and H at the 512^2 window (T = 1024: 1 and 4 clips, both flow
    # directions on the batch axis) and once at the 352^2 window (T = 484)
    c, k2 = 128, 4
    for b2, side in ((2, 64), (2 * BATCH_512, 64), (2 * batch, 44)):
        tok = (side // 2) ** 2
        x, t = r(b2, k2, tok, c), r(b2, k2, tok, c)
        sp, cp = window_params(r, c)
        mask = shifted_window_mask(side, side, 2, device=device)
        for label, msk in (("unshifted", None), ("shifted mask", mask)):
            if tok == 484 and msk is None:
                continue
            shape = f"[{b2},{k2},{tok},{c}] {label}"
            cases.append(("window_attention_layer", shape + " + x",
                          K.fused_window_attention_layer,
                          K.fused_window_attention_layer_reference,
                          (x, t, sp, msk, True)))
            if b2 == 2:
                cases.append(("window_attention_layer", shape + " message",
                              K.fused_window_attention_layer,
                              K.fused_window_attention_layer_reference,
                              (x, t, sp, msk, False)))
            cases.append(("window_attention_ffn_layer", shape,
                          K.fused_window_attention_ffn_layer,
                          K.fused_window_attention_ffn_layer_reference,
                          (x, t, cp, msk)))
    for b, n in ((batch, 1936), (BATCH_512, 4096)):
        cases.append(("softmax_expectation", f"corr [{b},{n},{n}]",
                      K.softmax_expectation, K.softmax_expectation_reference,
                      (r(b, n, n, scale=3.0), r(n, 2, scale=20.0))))
    for side, f in FFN_STAGES:
        cases.append(("dwconv_gelu", f"u [{batch},{side * side},{f}]",
                      K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
                      (r(batch, side * side, f), r(3, 3, f, scale=0.3),
                       r(f, scale=0.1), side, side)))
    return cases


def check_cases(device):
    """Cases held and timed like kernel_cases' but kept out of their
    kernel's summed row (listed in its ``cases`` only), from a generator of
    their own so that kernel_cases' inputs stay as they were: C at a ragged
    token count (1000 = 31 key tiles of 32 + 8), at channel width 128 and
    at pvt_v2_b0's 64."""
    from emip_tpu_torch import kernels as K

    r = seeded_randn(SEED + 15, device)
    return [("flow_attention", f"[2,1000,{c}] v=[...,2] ragged",
             K.fused_flow_attention, K.fused_flow_attention_reference,
             (r(2, 1000, c), r(2, 1000, c), r(2, 1000, 2, scale=10.0)))
            for c in (128, 64)]


# kernel F: (clips, query pixels, slots, written slots)
MEMORY_FWD_CASES = ((1, 1936, 5, 1), (1, 1936, 5, 3), (1, 1936, 5, 5),
                    (4, 1936, 5, 1), (4, 1936, 5, 3), (4, 1936, 5, 5),
                    (2, 100, 3, 0),       # every slot empty: mean of values
                    (1, 4096, 5, 5))      # the 512^2 shape
MEMORY_BWD_CASES = ((1, 1936, 5, 2), (4, 1936, 5, 5), (4, 1936, 5, 1))
MEMORY_BWD_CASES_MORE = ((1, 4096, 5, 5), (2, 100, 3, 0))


def memory_cases(r, shapes):
    """(label, (q, k, v, bias)) of the memory read: the ring flattened
    slot-major, oldest slot first, the written slots last (as
    ``MemoryState.push`` fills it), bias -1e9 on the empty ones."""
    import torch

    for b, m, slots, valid in shapes:
        q = r(b, m, 128, scale=2.0)
        k, v = r(b, slots * m, 128), r(b, slots * m, 128)
        bias = torch.zeros(b, slots, m, device=q.device)
        bias[:, :slots - valid] = -1e9
        yield (f"[{b},{m},128] x [{b},{slots * m},128] {valid}/{slots} slots",
               (q, k, v, bias.reshape(b, slots * m)))


def kernel_phase(batch: int, device, reps: int, only: str = "") -> dict:
    import torch

    results = {}
    cases = [(True, *case) for case in kernel_cases(batch, device)]
    cases += [(False, *case) for case in check_cases(device)]
    for summed, name, label, fn, ref, args in cases:
        if not wanted(only, name):
            continue
        got = fn(*args)
        torch.cuda.synchronize()
        want = ref(*args)
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL[name]
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, **tol)
        if name in TENSOR_CORE_KERNELS and not torch.equal(fn(*args), got):
            raise AssertionError(f"{name} ({label}): two calls on the same "
                                 f"inputs differ")
        ms, plain_ms = alternate_ms(lambda: fn(*args), lambda: ref(*args),
                                    reps)
        lib_ms = library_ms(name, args, reps)
        log(f"kernel {name:24s} {label:32s} max_abs_err={err:.3e} "
            f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={fmt_ms(lib_ms)} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} ({label}) disagrees with its plain "
                                 f"version: max_abs_err={err}, tol={tol}")
        record(results, name, label, err, ms, plain_ms,
               forward_work(name, args, got), lib_ms, summed=summed)
        del got, want
    return results


def library_ms(name: str, args, reps: int, which=None) -> float | None:
    """Time of the one PyTorch call that computes the same function, where
    there is one: ``scaled_dot_product_attention`` for the flow-valued
    attention (if it takes a 2-wide value) and, with the bias as its
    ``attn_mask``, for the memory read. With ``which``, the time of its
    backward alone. A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    base = name.removesuffix("_bwd")
    if base not in ("flow_attention", "memory_attention"):
        return None
    mask = args[3][:, None, :] if base == "memory_attention" else None

    def call(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    try:
        if which is None:
            return cuda_ms(lambda: call(*args[:3]), reps)
        gen = torch.Generator(device=args[0].device).manual_seed(SEED + 3)
        _, _, rerun = _grads(call, args[:3], which, lambda out: torch.randn(
            out.shape, generator=gen, device=out.device))
        return cuda_ms(rerun, reps)
    except RuntimeError as e:  # no backend takes these shapes
        log(f"library call for {name} refused: {str(e).splitlines()[0]}")
        return None


# ---------------------------------------------------- backward kernels


def backward_cases(batch: int, device):
    """The cases (kernel, label, kernel fn, plain fn, args, indices of the
    args that take a gradient) at the shapes of the 352^2 train step and a
    few more, and the indices of C's and F's cases at 352^2."""
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + 2, device)
    cases, at_352 = [], set()
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
        at_352.add(len(cases))
        cases.append(("flow_attention_bwd", f"[{b},{L},128] v=[...,2] {label}",
                      K.fused_flow_attention,
                      K.fused_flow_attention_reference,
                      (r(b, L, 128), r(b, L, 128), r(b, L, 2, scale=10.0)),
                      which))
    # the 512^2 train step's shape (batch 2, both directions) and a small
    # ragged one (1000 = 15 tiles of 64 + 40)
    for b, L, label, which in ((2 * TRAIN_BATCH_512, 4096, "512^2 matching",
                                (0, 1)), (2, 1000, "ragged dq dk dv",
                                          (0, 1, 2))):
        cases.append(("flow_attention_bwd", f"[{b},{L},128] v=[...,2] {label}",
                      K.fused_flow_attention,
                      K.fused_flow_attention_reference,
                      (r(b, L, 128), r(b, L, 128), r(b, L, 2, scale=10.0)),
                      which))
    cases.append(("convex_upsample_bwd", f"flow [{2 * batch},44,44,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * batch, 44, 44, 2, scale=3.0),
                   r(2 * batch, 44, 44, 576), 8), (0, 1)))
    for label, args in memory_cases(r, MEMORY_BWD_CASES):
        for which, what in (((0, 1, 2), "dq dk dv"), ((0,), "dq")):
            at_352.add(len(cases))
            cases.append(("memory_attention_bwd", f"{label} {what}",
                          K.masked_memory_attention,
                          K.masked_memory_attention_reference, args, which))
    # the 512^2 long train step's shape, and a ragged one with every slot
    # empty (row max -1e9, uniform weights)
    for label, args in memory_cases(r, MEMORY_BWD_CASES_MORE):
        cases.append(("memory_attention_bwd", f"{label} dq dk dv",
                      K.masked_memory_attention,
                      K.masked_memory_attention_reference, args, (0, 1, 2)))

    # ---- G and H at the 512^2 train step's window (batch 2 pairs, both
    # directions) and at T = 484; I; J
    def layer_fns(kernel, plain, keys, **kw):
        return (lambda x, t, *p: kernel(x, t, dict(zip(keys, p)), **kw),
                lambda x, t, *p: plain(x, t, dict(zip(keys, p)), **kw))

    for b2, side in ((4, 64), (2 * batch, 44)):
        tok = (side // 2) ** 2
        x, t = r(b2, k2, tok, c), r(b2, k2, tok, c)
        sp, cp = window_params(r, c)
        mask = shifted_window_mask(side, side, 2, device=device)
        sflat, cflat = [sp[k] for k in WIN_SELF], [cp[k] for k in WIN_CROSS]
        for label, msk in (("unshifted", None), ("shifted mask", mask)):
            if tok == 484 and msk is None:
                continue
            for wgrads in (False, True):
                what = "x t + weight" if wgrads else "x t"
                shape = f"[{b2},{k2},{tok},{c}] {label}, {what} grads"
                for res in ((True, False) if tok == 1024 and wgrads
                            else (True,)):
                    fn, ref = layer_fns(
                        K.fused_window_attention_layer,
                        K.fused_window_attention_layer_reference, WIN_SELF,
                        mask=msk, add_residual=res)
                    cases.append((
                        "window_attention_layer_bwd",
                        shape + (" (+ x)" if res else " (message)"), fn, ref,
                        (x, t, *sflat),
                        tuple(range(2 + len(sflat))) if wgrads else (0, 1)))
                fn, ref = layer_fns(
                    K.fused_window_attention_ffn_layer,
                    K.fused_window_attention_ffn_layer_reference, WIN_CROSS,
                    mask=msk)
                cases.append((
                    "window_attention_ffn_layer_bwd", shape, fn, ref,
                    (x, t, *cflat),
                    tuple(range(2 + len(cflat))) if wgrads else (0, 1)))
    for b, n in ((batch, 1936), (2, 4096)):
        for which, what in (((0,), "dcorr"), ((0, 1), "dcorr dvalues")):
            cases.append(("softmax_expectation_bwd",
                          f"corr [{b},{n},{n}] {what}",
                          K.softmax_expectation,
                          K.softmax_expectation_reference,
                          (r(b, n, n, scale=3.0), r(n, 2, scale=20.0)),
                          which))
    for side, f in FFN_STAGES:
        cases.append(("dwconv_gelu_bwd",
                      f"u [{batch},{side * side},{f}] gu taps bias",
                      K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
                      (r(batch, side * side, f), r(3, 3, f, scale=0.3),
                       r(f, scale=0.1), side, side), (0, 1, 2)))
    return cases, at_352


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


def backward_phase(batch: int, device, reps: int, only: str = "") -> dict:
    """Each backward kernel against torch.autograd.grad of its plain
    version on the same seeded inputs and cotangent; CUDA-event times of
    the backward alone (the graph is built once and kept)."""
    import torch

    results = {}
    cases, at_352 = backward_cases(batch, device)
    for i, (name, label, fn, ref, args, which) in enumerate(cases):
        if not wanted(only, name):
            continue
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
        if name in TENSOR_CORE_KERNELS:
            # no atomics: a second call on the same inputs gives the same bits
            again = rerun_k()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} ({label}): two calls on the "
                                     f"same inputs differ")
            del again
        ms, plain_ms = alternate_ms(rerun_k, rerun_p, reps)
        lib_ms = library_ms(name, args, reps, which)
        log(f"kernel {name:28s} {label:44s} max_abs_err={err:.3e} "
            f"max_rel={rel:.3e} (tol {BWD_REL_TOL}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={fmt_ms(lib_ms)} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} ({label}) disagrees with the plain "
                                 f"backward: max_rel={rel}")
        record(results, name, label, err, ms, plain_ms,
               backward_work(name, args, which, out_k), lib_ms, max_rel=rel,
               at_352=i in at_352)
        del out_k, out_p, got, want, rerun_k, rerun_p
    for name in TENSOR_CORE_KERNELS:
        # the 352^2 cases apart from the 512^2 and ragged ones
        main = [c for c in results.get(name, {}).get("cases", ())
                if c["at_352"]]
        if main:
            tot = {k: sum(c[k] or 0.0 for c in main) for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "fp32_bound_ms")}
            results[name]["main_cases"] = tot
            log(f"kernel {name}: its {len(main)} cases at 352^2 sum to "
                + " ".join(f"{k}={v:.4f}" for k, v in tot.items())
                + " (bound_ms: 3xTF32 operations; fp32_bound_ms: fp32)")
    if wanted(only, "splat_density"):
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
           forward_work("splat_density", (coords,), got), mask_flips=flips)


# --------------------------------------------------------------- slice


def expected_launches(model, train: bool = False) -> dict:
    """Kernel launches per forward (``train``: per train step) implied by
    the model's structure and its configuration's kernel switches."""
    from emip_tpu_torch import kernels as K

    pvt = model.backbone.feat_net.pvtv2_en
    depths = pvt.config.depths
    gm = model.GMFlow.config
    layers = len(model.GMFlow.transformer.layers)
    tok = (model.config.inp_size // 8 // gm.attn_splits_list[0]) ** 2
    whole_block = tok <= gm.fused_block_max_t
    directions = 2 if gm.pred_bidir_flow else 1
    n = {k: 0 for k in K.LAUNCHES}
    n.update(sr_attention=2 * sum(depths),  # every PVT block, both frames
             window_attention_block=layers if whole_block else 0,
             window_attention_layer=0 if whole_block else layers,
             window_attention_ffn_layer=0 if whole_block else layers,
             # matching per direction (kernel C, or I on the stored
             # correlation) and one propagation
             flow_attention=1 + (directions if gm.global_match_qk_fused
                                 else 0),
             softmax_expectation=(0 if gm.global_match_qk_fused
                                  else directions),
             convex_upsample=1,
             dwconv_gelu=(2 * sum(depths) if pvt.config.fused_ffn == "always"
                          else 0))
    if train:
        # backward: every block of frame 1; of frame 2 only the stages up
        # to /8, whose output feeds the camouflage feeder (its /16 and /32
        # features do not reach the loss)
        blocks_bwd = sum(depths) + depths[0] + depths[1]
        ffn_kernel_bwd = (pvt.config.fused_ffn == "always"
                          or pvt.config.ffn_dwconv == "bwd_fused")
        n.update(sr_attention_bwd=blocks_bwd,
                 convex_upsample_bwd=1,
                 dwconv_gelu_bwd=blocks_bwd if ffn_kernel_bwd else 0,
                 splat_density=2,  # occlusion masks of both directions
                 **{k + "_bwd": n[k] for k in (
                     "window_attention_block", "window_attention_layer",
                     "window_attention_ffn_layer", "flow_attention",
                     "softmax_expectation")})
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


# what the default short train step launches: A-D forward and backward, E
TRAIN_KERNELS = ("sr_attention", "sr_attention_bwd", "window_attention_block",
                 "window_attention_block_bwd", "flow_attention",
                 "flow_attention_bwd", "convex_upsample",
                 "convex_upsample_bwd", "splat_density")
# at 512^2 the windows hold 1024 tokens: G and H in place of B
TRAIN_KERNELS_512 = tuple(
    k for k in TRAIN_KERNELS if "window" not in k) + (
    "window_attention_layer", "window_attention_layer_bwd",
    "window_attention_ffn_layer", "window_attention_ffn_layer_bwd")


def train_phase(model, batch: int, size: int, device, timed: int,
                must_run=TRAIN_KERNELS) -> dict:
    """Train steps of the full model: 1 warm-up, then ``timed`` steps
    timed with CUDA events; kernel launch counts per step against the
    structure (and none of ``must_run`` idle); GMFlow untouched; every
    trainable leaf with a grad moved."""
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
    idle = [k for k in must_run if launches[k] == 0]
    if launches != want or idle:
        raise AssertionError(f"train launch counts {launches} != {want}; "
                             f"not launched: {idle}")

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


def variant_phase(label: str, model, infer_cfg, train_cfg, batch: int,
                  size: int, device, timed: int, must_run) -> dict:
    """The short model under another kernel configuration, beside the
    default one (``model``) on the same weights and inputs.

    Inference with ``infer_cfg``: ``predict_arrays`` on seeded batches, in
    turns default, variant, variant, default; launch counts of the variant
    per forward against its structure; mask and flow of the first batch
    equal to the default's within the slice tolerance. Then train steps
    with ``train_cfg``, each model from the same weights with its own
    optimizer and the same seeded drop-path bits: launch counts per step,
    the first step's losses equal to the default's within the loss
    tolerance, every step's finite. ``must_run`` names the kernels the two
    variant runs must have launched between them. Times are medians of
    CUDA-event timed batches / steps."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    def twin(cfg):
        m = EMIPShort(cfg)
        m.load_state_dict(model.state_dict(), strict=True)  # the same keys
        return m.to(device)

    def timed_run(fn, n):
        """(results, ms of each call after the first)."""
        outs, times = [], []
        for i in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(fn(i))
            end.record()
            torch.cuda.synchronize()
            if i > 0:
                times.append(start.elapsed_time(end))
        return outs, times

    rng = np.random.default_rng(SEED + 11)
    n = 1 + timed
    frames = [(torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
               torch.from_numpy(seeded_frames(rng, batch, size)).to(device))
              for _ in range(n)]
    variant = twin(infer_cfg).eval()
    model.eval()
    runs = {}
    launched = {}
    for who in ("default", "variant", "variant", "default"):
        m = model if who == "default" else variant
        K.reset_launches()
        outs, times = timed_run(lambda i: predict_arrays(m, *frames[i]), n)
        runs.setdefault(who, dict(out=outs[0], times=[]))["times"] += times
        if who == "variant":
            want = {k: v * n for k, v in expected_launches(variant).items()}
            if dict(K.LAUNCHES) != want:
                raise AssertionError(f"{label}: launch counts "
                                     f"{dict(K.LAUNCHES)} != {want}")
            launched = dict(K.LAUNCHES)
    cmp = {}
    for name, got, ref in zip(("mask", "flow_fw"), runs["variant"]["out"],
                              runs["default"]["out"]):
        tol = SLICE_TOL[name]
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        ok = (bool(torch.isfinite(got).all())
              and torch.allclose(got, ref, **tol) and rel <= SLICE_REL_MAX)
        cmp[name] = dict(max_abs_err=err, rel_to_max=rel, ok=ok)
        log(f"{label} {name} vs default configuration: max_abs_err={err:.3e} "
            f"tol={tol}; max|err|/max|ref|={rel:.3e} (limit {SLICE_REL_MAX}) "
            f"{'ok' if ok else 'MISMATCH'}")
    ms = {who: statistics.median(r["times"]) for who, r in runs.items()}
    per_fwd = {k: v // n for k, v in launched.items() if v}
    log(f"{label} inference b5 {size}^2 bs={batch}: launches per forward "
        f"{per_fwd}; median {ms['variant']:.3f} ms/batch -> "
        f"{batch / ms['variant'] * 1e3:.3f} frames/s (default configuration "
        f"in the same turns: {ms['default']:.3f} ms/batch -> "
        f"{batch / ms['default'] * 1e3:.3f} frames/s)")
    if not all(c["ok"] for c in cmp.values()):
        raise AssertionError(f"{label}: outputs differ from the default "
                             f"configuration's: {cmp}")
    out = dict(infer=dict(launches=launched, ms=ms, compare=cmp,
                          frames_per_s={k: batch / v * 1e3
                                        for k, v in ms.items()}))
    del variant, runs

    # ---- train steps, each model from the same weights
    rng = np.random.default_rng(SEED + 12)
    batches = [seeded_batch(rng, batch, size, device) for _ in range(n)]
    res = {}
    for who, cfg in (("default", model.config), ("variant", train_cfg)):
        m = twin(cfg)
        opt = build_optimizer(m)
        gen = torch.Generator(device=device).manual_seed(SEED)
        K.reset_launches()
        metrics, times = timed_run(
            lambda i: short_train_step(m, opt, batches[i], gen), n)
        want = {k: v * n for k, v in expected_launches(m, True).items()}
        if dict(K.LAUNCHES) != want:
            raise AssertionError(f"{label} train ({who}): launch counts "
                                 f"{dict(K.LAUNCHES)} != {want}")
        res[who] = dict(launches=dict(K.LAUNCHES),
                        ms=statistics.median(times),
                        losses=[{k: float(v) for k, v in mt.items()}
                                for mt in metrics])
        del m, opt
        torch.cuda.empty_cache()
    # the first step starts from the same weights; after it the two runs'
    # weights differ in their last bits (kernel E's atomics) and the flow
    # loss, piecewise constant in the warp, moves in its 3rd-4th digit
    a, b = res["variant"]["losses"][0], res["default"]["losses"][0]
    bad = [(k, a[k], b[k]) for k in a
           if not abs(a[k] - b[k]) <= TRAIN_LOSS_RTOL * abs(b[k])]
    bad += [(i, m) for i, m in enumerate(res["variant"]["losses"])
            if not all(np.isfinite(v) for v in m.values())]
    per_step = {k: v // n for k, v in res["variant"]["launches"].items()
                if v and k.endswith("_bwd")}
    log(f"{label} train b5 {size}^2 bs={batch}: backward launches per step "
        f"{per_step}; median {res['variant']['ms']:.3f} ms/step (default "
        f"configuration: {res['default']['ms']:.3f}); first step's losses "
        f"within rel {TRAIN_LOSS_RTOL} of the default's, all {n} steps "
        f"finite: {'ok' if not bad else 'MISMATCH'}")
    if bad:
        raise AssertionError(f"{label}: train losses differ from the "
                             f"default configuration's: {bad[:4]}")
    idle = [k for k in must_run
            if launched[k] + res["variant"]["launches"][k] == 0]
    if idle:
        raise AssertionError(f"{label}: never launched: {idle}")
    out["train"] = res
    return out


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


def train_compare_phase(model, size: int, device,
                        label: str = "train") -> dict:
    """One pair, the seeded weights, card kernels vs CPU plain versions:
    loss values, and the seg-loss grads of every trainable leaf (GMFlow
    frozen) by the scale-floored relative max of
    tests/test_grad_parity.py. Drop path is off (the two devices'
    generators differ)."""
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
        log(f"{label} {k} card {loss_c[k]:.7f} vs CPU {loss_p[k]:.7f}: "
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
    log(f"{label} seg-loss grads card vs CPU over {len(rels)} leaves: worst "
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


# ----------------------------------------------------------- long model

LONG_CLIPS = (1, 4)   # clips streamed side by side: the reference protocol
#                       (one video at a time) and the trainer's group of 4
LONG_TIMED = 5


def long_expected(model, frames_encoded: int, pairs: int, reads: int,
                  backward_reads: int = 0) -> dict:
    """Kernel launches of the long model's frozen short-term net and its
    memory read: A (and J) per encoded frame, B or G + H, C, I and D per
    frame pair, F per read (and F's backward per train step); never a
    backward of the short-term net's kernels."""
    per = expected_launches(model.short_term)
    per_frame = ("sr_attention", "dwconv_gelu")  # counted for two frames
    n = {k: v // 2 * frames_encoded if k in per_frame else v * pairs
         for k, v in per.items()}
    n.update(memory_attention=reads, memory_attention_bwd=backward_reads)
    return n


def seeded_clip(rng, clips: int, frames: int, size: int, device):
    """[clips, frames, 3, size, size] normalized seeded frames."""
    import torch

    return torch.from_numpy(
        seeded_frames(rng, clips * frames, size).reshape(
            clips, frames, 3, size, size)).to(device)


def long_infer_phase(model, size: int, device, timed: int) -> dict:
    """Streaming inference of the full EMIPLong: per clip group, frame 0's
    mask from the short-term pair (f0, f1), then ``step_cached`` per frame
    with the encoding and the memory carried; launch counts against the
    structure; frames/s (median of CUDA-event timed steps) and peak
    memory. Then one 3-frame clip on the card against the same weights on
    the CPU through the plain versions: the short mask of frame 0, both
    long masks and the final memory."""
    import torch

    from emip_tpu_torch import kernels as K

    model.eval()
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for clips in LONG_CLIPS:
        steps = 1 + timed + model.memory_size  # fills the ring, then timed
        video = seeded_clip(rng, clips, steps + 1, size, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        K.reset_launches()
        times = []
        with torch.inference_mode():
            enc_prev = model.encode_frame(video[:, 0])
            enc = model.encode_frame(video[:, 1])
            mask0 = model.short_term.pair_from_encodings(enc_prev,
                                                         enc)["mask"]
            mask, state = model.step_encoded(enc_prev, enc,
                                             model.init_memory(clips))
            masks = [mask0, mask]
            for t in range(2, steps + 1):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                mask, enc, state = model.step_cached(enc, video[:, t], state)
                end.record()
                torch.cuda.synchronize()
                if t - 1 >= model.memory_size:  # every slot written
                    times.append(start.elapsed_time(end))
                masks.append(mask)
        launches = dict(K.LAUNCHES)
        want = long_expected(model, steps + 1, steps + 1, steps)
        log(f"long inference clips={clips} launches {launches} "
            f"(expected {want})")
        if launches != want or launches["memory_attention"] == 0:
            raise AssertionError(f"launch counts {launches} != {want}")
        for m in masks:
            if tuple(m.shape) != (clips, 1, size, size) or not bool(
                    torch.isfinite(m).all()):
                raise AssertionError("long mask: wrong shape or non-finite")
        if not bool(state.valid.all()):
            raise AssertionError("the memory ring did not fill")
        median_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(device)
        log(f"long inference b5 {size}^2 clips={clips} fp32: median "
            f"{median_ms:.3f} ms/step over {len(times)} steps (ring full) "
            f"-> {clips / (median_ms / 1e3):.3f} frames/s; peak memory "
            f"{peak / 2**30:.3f} GiB")
        out[f"clips{clips}"] = dict(
            launches=launches, expected=want, median_ms=median_ms,
            step_ms=times, frames_per_s=clips / (median_ms / 1e3),
            peak_bytes=peak)

    # card vs CPU plain versions, one 3-frame clip
    t0 = time.perf_counter()
    video = seeded_clip(np.random.default_rng(SEED + 8), 1, 3, size, device)
    cpu_model = copy.deepcopy(model).cpu()
    got, ref = long_clip(model, video), long_clip(cpu_model, video.cpu())
    out["compare"] = held_to_cpu("long", got, ref)
    log(f"CPU reference clip took {time.perf_counter() - t0:.1f} s")
    return out


def long_clip(model, video) -> dict:
    """Frames 0-2 of ``video`` [1, 3, ...] through the long model: frame 0's
    short mask from the pair (f0, f1), the long masks of frames 1 and 2,
    and the memory's last two slots after them (3 frames encoded, 3 pairs,
    2 memory reads)."""
    import torch

    with torch.inference_mode():
        enc_prev = model.encode_frame(video[:, 0])
        enc = model.encode_frame(video[:, 1])
        mask0 = model.short_term.pair_from_encodings(enc_prev, enc)["mask"]
        mask1, state = model.step_encoded(enc_prev, enc,
                                          model.init_memory(1))
        mask2, _, state = model.step_cached(enc, video[:, 2], state)
    return dict(mask0=mask0, mask_long1=mask1, mask_long2=mask2,
                memory_keys=state.keys[:, -2:],
                memory_values=state.values[:, -2:])


def held_to_cpu(label: str, got: dict, ref: dict, tols=None) -> dict:
    """Each output of the card (``got``) against the CPU's plain versions
    (``ref``) by the slice tolerance (``tols[name]``, else the mask's) and
    max|err| <= SLICE_REL_MAX * max|ref|; raises on a mismatch."""
    import torch

    cmp = {}
    for name in got:
        g, r = got[name].cpu(), ref[name]
        tol = (tols or {}).get(name, SLICE_TOL["mask"])
        err, ref_max = (g - r).abs().max().item(), r.abs().max().item()
        rel = err / ref_max if ref_max > 0 else float("inf")
        ok = (bool(torch.isfinite(g).all()) and torch.allclose(g, r, **tol)
              and rel <= SLICE_REL_MAX)
        cmp[name] = dict(max_abs_err=err, ref_max_abs=ref_max, rel_to_max=rel,
                         tol=tol, rel_max=SLICE_REL_MAX, ok=ok)
        log(f"{label} {name} card vs CPU plain: max_abs_err={err:.3e} (|ref| "
            f"max {ref_max:.3e}) tol={tol}; max|err|/max|ref|={rel:.3e} "
            f"(limit {SLICE_REL_MAX}) {'ok' if ok else 'MISMATCH'}")
    bad = [k for k, v in cmp.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"{label}: card disagrees with the CPU "
                             f"reference: {bad}")
    return cmp


def _long_frame(model, batch: dict):
    """One train-mode frame on a memory that holds the frame before:
    (loss, grads of the trainable leaves)."""
    import torch

    from emip_tpu_torch.losses.seg import hybrid_e_loss

    with torch.no_grad():
        model.eval()
        _, _, state = model.step(batch["f0"], batch["f1"],
                                 model.init_memory(1))
        enc = model.encode_frame(batch["f1"])
    model.train()
    mask, _, _ = model.step_cached(enc, batch["f2"], state)
    loss = hybrid_e_loss(mask, batch["gt"])
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(
        loss, [p for p in model.parameters() if p.requires_grad])
    return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}


def long_train_compare_phase(model, size: int, device,
                             label: str = "long train") -> dict:
    """One frame, the seeded weights, card kernels vs CPU plain versions:
    the loss and the grads of every trainable leaf of the long heads
    (through kernel F's backward), by the scale-floored relative max."""
    import torch

    rng = np.random.default_rng(SEED + 9)
    video = seeded_clip(rng, 1, 3, size, device)
    gt = torch.from_numpy((rng.uniform(size=(1, 1, size, size)) > 0.5
                           ).astype(np.float32)).to(device)
    batch = dict(f0=video[:, 0], f1=video[:, 1], f2=video[:, 2], gt=gt)
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    loss_c, grads_c = _long_frame(model, batch)
    loss_p, grads_p = _long_frame(cpu_model,
                                  {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    rel = abs(loss_c - loss_p) / max(abs(loss_p), 1e-30)
    log(f"{label} loss card {loss_c:.7f} vs CPU {loss_p:.7f}: rel "
        f"{rel:.3e} (tol {TRAIN_LOSS_RTOL})")
    scale = max(g.abs().max().item() for g in grads_p.values())
    rels = {n: (grads_c[n] - grads_p[n]).abs().max().item()
            / max(grads_p[n].abs().max().item(), 1e-6 * scale)
            for n in grads_p}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    log(f"{label} head grads card vs CPU over {len(rels)} leaves: worst "
        f"relmax {worst[0][1]:.3e} (tol {SEG_GRAD_RTOL}); top: "
        + ", ".join(f"{n}={r:.2e}" for n, r in worst)
        + f"; CPU side took {cpu_s:.1f} s")
    bad = [n for n, r in rels.items() if not r <= SEG_GRAD_RTOL]
    if not rel <= TRAIN_LOSS_RTOL or bad:
        raise AssertionError(f"card disagrees with the CPU reference: loss "
                             f"rel {rel}, leaves {bad[:8]}")
    return dict(loss_card=loss_c, loss_cpu=loss_p, leaves=len(rels),
                worst=worst, cpu_seconds=cpu_s)


def long_train_phase(model, size: int, device, timed: int) -> dict:
    """Per-frame long train steps of the full model, 1 warm-up + ``timed``
    steps per clip group, timed with CUDA events: launch counts per step
    against the structure (one frame encoded, one pair, one memory read
    and its backward; no backward of A-D); every ``short_term`` tensor and
    buffer bit-identical afterwards; every trainable leaf moved."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.train.long import long_train_step
    from emip_tpu_torch.train.state import build_long_optimizer

    opt = build_long_optimizer(model)  # lr 1e-5, wd 1e-7, clamp 0.5
    short0 = {k: v.clone() for k, v in model.short_term.state_dict().items()}
    trainable0 = {n: p.detach().clone() for n, p in model.named_parameters()
                  if p.requires_grad}
    if not trainable0 or any(n.startswith("short_term.") for n in trainable0):
        raise AssertionError("the frozen set is not exactly short_term")
    rng = np.random.default_rng(SEED + 10)
    out = {}
    for clips in reversed(LONG_CLIPS):
        steps = 1 + timed
        video = seeded_clip(rng, clips, steps + 1, size, device)
        gts = torch.from_numpy(
            (rng.uniform(size=(clips, steps + 1, 1, size, size)) > 0.5
             ).astype(np.float32)).to(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        K.reset_launches()
        times, losses = [], []
        state = model.init_memory(clips)
        enc = model.encode_frame(video[:, 0])
        for t in range(1, steps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics, enc, state = long_train_step(model, opt, enc,
                                                  video[:, t], gts[:, t],
                                                  state)
            end.record()
            torch.cuda.synchronize()
            if t > 1:
                times.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
        launches = dict(K.LAUNCHES)
        want = long_expected(model, steps + 1, steps, steps, steps)
        log(f"long train clips={clips} launches {launches} (expected {want})")
        if launches != want or 0 in (launches["memory_attention"],
                                     launches["memory_attention_bwd"]):
            raise AssertionError(f"launch counts {launches} != {want}")
        log(f"long train clips={clips} losses "
            + " ".join(f"{v:.6f}" for v in losses))
        if not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite long losses: {losses}")
        median_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(device)
        log(f"long train b5 {size}^2 clips={clips} fp32: median "
            f"{median_ms:.3f} ms/step over {len(times)} steps -> "
            f"{median_ms / clips:.3f} ms/frame; peak memory "
            f"{peak / 2**30:.3f} GiB")
        out[f"clips{clips}"] = dict(
            launches=launches, expected=want, median_ms=median_ms,
            step_ms=times, ms_per_frame=median_ms / clips, peak_bytes=peak,
            losses=losses)
    short = model.short_term.state_dict()
    changed = [k for k, v in short0.items() if not torch.equal(short[k], v)]
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p.detach(), trainable0[n])]
    if changed or still or model.short_term.training:
        raise AssertionError(f"short_term tensors changed: {changed[:8]}; "
                             f"trainable leaves that did not move: "
                             f"{still[:8]}")
    log(f"long train: {len(trainable0)} trainable leaves all moved, "
        f"{len(short0)} short_term tensors and buffers bit-identical")
    out["leaves"] = len(trainable0)
    out["short_term_tensors"] = len(short0)
    return out


def long_entry_phase(size: int) -> dict:
    """``python -m emip_tpu_torch.train_long`` and ``... test_long`` (in
    process) on a synthetic root that the port writes: b5 at 352^2, one
    epoch over 2 videos x 3 frames (4 per-frame steps), validation,
    checkpoints; then streaming prediction of both videos from the
    checkpoint."""
    import yaml

    from emip_tpu_torch.data import make_synthetic_video_root
    from emip_tpu_torch.test_long import main as test_long_main
    from emip_tpu_torch.train_long import main as train_long_main

    work = os.path.join(ROOT, "build", "chip_smoke_long")
    root = make_synthetic_video_root(os.path.join(work, "data"),
                                     num_videos=2, frames_per_video=6,
                                     seed=SEED)
    ds = dict(image_path=root, gt_path=root, inp_size=size, batch_size=1,
              dataset_type="MoCA")
    cfg = dict(train_dataset=ds, val_dataset=ds,
               model=dict(args=dict(inp_size=size,
                                    backbone_name="pvt_v2_b5", channel=32)),
               optimizer=dict(lr=1.0e-5, weight_decay=1.0e-7), clip=0.5,
               memory_size=5, seed=SEED, epoch=2, epoch_val=1, epoch_save=1,
               save_path=os.path.join(work, "run"))
    os.makedirs(work, exist_ok=True)
    cfg_path = os.path.join(work, "long.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    summary = train_long_main(["--config", cfg_path,
                               "--max_frames_per_video", "3"])
    t1 = time.perf_counter()
    ckpt = os.path.join(work, "run", "ckpt_long")
    pred = os.path.join(work, "pred")
    frames = test_long_main(["--config", cfg_path, "--ckpt", ckpt,
                             "--save_path", pred, "--data",
                             f"MoCA_test={root}"])
    t2 = time.perf_counter()
    pngs = sum(f.endswith(".png") for _, _, fs in os.walk(pred) for f in fs)
    ok = (summary["steps"] == 4 and 0.0 <= summary["best_sm"] <= 1.0
          and os.path.exists(os.path.join(ckpt, "ckpt.pt"))
          and frames == pngs == 12)
    log(f"entry python -m emip_tpu_torch.train_long: {summary['steps']} "
        f"steps, val Sm {summary['best_sm']:.5f}, {t1 - t0:.1f} s; "
        f"python -m emip_tpu_torch.test_long: {frames} frames, {pngs} PNGs, "
        f"{t2 - t1:.1f} s {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"long entry points failed: {summary}, "
                             f"{frames} frames, {pngs} PNGs")
    return dict(summary=summary, train_seconds=t1 - t0,
                predict_seconds=t2 - t1, frames=frames)


# ------------------------------------------------- tiny configuration

TINY_SIZE = 64
TINY_BATCH = 2


def tiny_phase(device) -> dict:
    """The configuration of the CPU tests' YAML on the card: pvt_v2_b0 at
    64^2 with 64-d flow features and 2 flow transformer blocks, so kernel
    A at head width 32 and B, C and F at channel width 64, on seeded
    weights. A short forward (launch counts against the structure; mask
    and flow against the CPU's plain versions), the seg-loss grads of one
    pair against the CPU's, one short train step (launch counts: A-D
    forward and backward, E), then the long model: a 3-frame clip (F's
    forward on every read) and one frame's head grads (F's backward),
    each against the CPU's."""
    import torch
    import yaml

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_long import EMIPLong
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    work = os.path.join(ROOT, "build", "chip_smoke_tiny")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(model=dict(args=dict(
            inp_size=TINY_SIZE, channel=8, backbone_name="pvt_v2_b0",
            include_dead_modules=False,
            GMFlow=dict(feature_channels=64, num_transformer_layers=2))),
            memory_size=5, compute_dtype="float32", seed=SEED), f)
    cfg = load_config(path)
    model = seeded_init_(EMIPShort(cfg.model), SEED).to(device).eval()
    rng = np.random.default_rng(SEED + 14)
    a, b = (torch.from_numpy(seeded_frames(rng, TINY_BATCH, TINY_SIZE)
                             ).to(device) for _ in range(2))
    out = {}

    K.reset_launches()
    mask, flow = predict_arrays(model, a, b)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = expected_launches(model)
    log(f"tiny b0 {TINY_SIZE}^2 forward launches {launches} (expected "
        f"{want})")
    if launches != want or min(launches[k] for k in FWD_KERNELS) == 0:
        raise AssertionError(f"tiny launch counts {launches} != {want}")
    cpu = copy.deepcopy(model).cpu()
    ref_mask, ref_flow = predict_arrays(cpu, a.cpu(), b.cpu())
    out["forward"] = dict(launches=launches, compare=held_to_cpu(
        "tiny", dict(mask=mask, flow_fw=flow),
        dict(mask=ref_mask, flow_fw=ref_flow), SLICE_TOL))
    del cpu

    out["train_compare"] = train_compare_phase(model, TINY_SIZE, device,
                                               "tiny train")
    opt = build_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = seeded_batch(rng, TINY_BATCH, TINY_SIZE, device)
    K.reset_launches()
    metrics = short_train_step(model, opt, batch, gen)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = expected_launches(model, True)
    losses = {k: float(v) for k, v in metrics.items()}
    log(f"tiny train step launches {launches} (expected {want}); losses "
        + " ".join(f"{k}={v:.6f}" for k, v in losses.items()))
    idle = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if launches != want or idle or not all(
            np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"tiny train step: launches {launches} != "
                             f"{want}, not launched {idle}, losses {losses}")
    out["train"] = dict(launches=launches, losses=losses)
    del model, opt

    long_model = seeded_init_(EMIPLong(cfg.model, cfg.memory_size), SEED)
    long_model = long_model.to(device).eval()
    video = seeded_clip(rng, 1, 3, TINY_SIZE, device)
    K.reset_launches()
    got = long_clip(long_model, video)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = long_expected(long_model, 3, 3, 2)
    log(f"tiny long clip launches {launches} (expected {want})")
    if launches != want or 0 in (launches[k] for k in FWD_KERNELS + (
            "memory_attention",)):
        raise AssertionError(f"tiny long launch counts {launches} != {want}")
    ref = long_clip(copy.deepcopy(long_model).cpu(), video.cpu())
    out["long"] = dict(launches=launches,
                       compare=held_to_cpu("tiny long", got, ref))
    out["long_train_compare"] = long_train_compare_phase(
        long_model, TINY_SIZE, device, "tiny long train")
    return out


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=None, metavar="NAMES",
                    help="development aid: only the kernel phases, and of "
                         "them only the kernels whose name contains one of "
                         "the comma-separated NAMES; prints no result line")
    opts = ap.parse_args(argv)

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

    if opts.kernels is not None:
        kernel_phase(BATCH, device, KERNEL_REPS, opts.kernels)
        backward_phase(BATCH, device, KERNEL_REPS, opts.kernels)
        if wanted(opts.kernels, "flow_attention"):
            stats_cost(BATCH, device, KERNEL_REPS)
        return 0
    kernels = kernel_phase(BATCH, device, KERNEL_REPS)
    kernels.update(backward_phase(BATCH, device, KERNEL_REPS))
    transpose_ms = transpose_cost(BATCH, device, KERNEL_REPS)
    stats_ms = stats_cost(BATCH, device, KERNEL_REPS)
    tiny = tiny_phase(device)
    torch.cuda.empty_cache()

    cfg = EMIPShortConfig(backbone_name="pvt_v2_b5", inp_size=SIZE)
    model = EMIPShort(cfg)
    seeded_init_(model, SEED)
    model = model.to(device).eval()
    slice_res = slice_phase(model, BATCH, SIZE, device, TIMED_BATCHES)
    compare_res = train_compare_phase(model, SIZE, device)
    train_res = train_phase(model, BATCH, SIZE, device, TIMED_STEPS)
    read_corr_cfg = dataclasses.replace(cfg, gmflow=dataclasses.replace(
        cfg.gmflow, global_match_qk_fused=False))
    read_corr = variant_phase(
        "read-corr matching", model, read_corr_cfg, read_corr_cfg, BATCH,
        SIZE, device, VARIANT_TIMED,
        ("softmax_expectation", "softmax_expectation_bwd"))
    fused_ffn = variant_phase(
        "fused MixFFN", model, dataclasses.replace(cfg, fused_ffn="always"),
        dataclasses.replace(cfg, ffn_dwconv="bwd_fused"), BATCH, SIZE,
        device, VARIANT_TIMED, ("dwconv_gelu", "dwconv_gelu_bwd"))
    del model
    torch.cuda.empty_cache()
    entry_res = entry_phase(BATCH, SIZE)

    from emip_tpu_torch.models.emip_long import EMIPLong

    long_model = EMIPLong(cfg, memory_size=5)
    seeded_init_(long_model, SEED)
    long_model = long_model.to(device).eval()
    long_infer = long_infer_phase(long_model, SIZE, device, LONG_TIMED)
    long_compare = long_train_compare_phase(long_model, SIZE, device)
    long_train = long_train_phase(long_model, SIZE, device, LONG_TIMED)
    del long_model
    torch.cuda.empty_cache()
    long_entry = long_entry_phase(SIZE)

    # 512^2: windows of 1024 tokens, so kernels G and H in place of B
    cfg512 = dataclasses.replace(cfg, inp_size=SIZE_512)
    model512 = EMIPShort(cfg512)
    seeded_init_(model512, SEED)
    model512 = model512.to(device)
    train512 = train_phase(model512, TRAIN_BATCH_512, SIZE_512, device,
                           TIMED_STEPS_512, TRAIN_KERNELS_512)
    del model512
    torch.cuda.empty_cache()
    long512 = EMIPLong(cfg512, memory_size=5)
    seeded_init_(long512, SEED)
    long512 = long512.to(device).eval()
    long_infer512 = long_infer_phase(long512, SIZE_512, device, LONG_TIMED)
    for clips in LONG_CLIPS:
        got = long_infer512[f"clips{clips}"]["launches"]
        if (got["window_attention_block"] or not got["window_attention_layer"]
                or not got["window_attention_ffn_layer"]):
            raise AssertionError(f"512^2 streaming did not run G and H: {got}")
    del long512
    torch.cuda.empty_cache()

    # launches on the main paths, each counted from 0 just before its run:
    # the short train step's; for the memory read the long train steps';
    # for G and H the 512^2 train steps'; for I and J the read-corr and
    # fused-MixFFN runs'
    runs = (train_res["launches"], long_train["clips4"]["launches"],
            train512["launches"], read_corr["train"]["variant"]["launches"],
            fused_ffn["infer"]["launches"],
            fused_ffn["train"]["variant"]["launches"])
    launches = {name: next((r[name] for r in runs if r[name]), 0)
                for name in KERNEL_INFO}
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNEL_INFO[name][0],
             replaces=KERNEL_INFO[name][1], launches=launches[name],
             max_abs_err=kernels[name]["max_abs_err"],
             ms=kernels[name]["ms"], plain_ms=kernels[name]["plain_ms"],
             bound_ms=kernels[name]["bound_ms"],
             bound_by=kernels[name]["bound_by"],
             library_ms=kernels[name]["library_ms"],
             **({"fp32_bound_ms": kernels[name]["fp32_bound_ms"],
                 "bound_rate": "tf32x3"}
                if name in TENSOR_CORE_KERNELS else {}))
        for name in KERNEL_INFO]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, slice=slice_res,
                       train=train_res, train_compare=compare_res,
                       entry=entry_res, long_infer=long_infer,
                       long_train_compare=long_compare,
                       long_train=long_train, long_entry=long_entry,
                       read_corr=read_corr, fused_ffn=fused_ffn,
                       read_corr_transpose_ms=transpose_ms,
                       flow_attention_stats_ms=stats_ms, tiny=tiny,
                       train_512=train512, long_infer_512=long_infer512),
                  f, indent=1, default=str)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
