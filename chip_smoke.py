#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and ``nvcc``. It
needs one card and no arguments, and it imports nothing of JAX. In order:

1. requires ``torch.cuda.is_available()`` and prints the card's
   ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``emip_tpu_torch/csrc`` and prints the
   build time;
3. turns TF32 off for matmuls and cuDNN convolutions (fp32 comparisons);
4. kernel phase: each kernel A-D against its plain PyTorch version on the
   same seeded CUDA tensors, at the production shapes of the 352^2 path at
   batch 8 (A at all four PVT stages, B with and without the shift mask),
   with the tolerance stated, and CUDA-event times of both;
5. slice phase: the full pvt_v2_b5 EMIPShort at 352^2 on seeded random
   weights runs ``predict_arrays`` on batches of 8 seeded frame pairs; the
   kernel launch counts of that run must equal what the model structure
   implies; one pair's mask logits and forward flow are compared with the
   same weights run on the CPU through the plain versions; frames/s
   (median of CUDA-event timed batches) and peak memory are printed.

It prints one JSON line with the kernels' numbers (per kernel: launches in
the slice run, the largest max_abs_err of its cases, and ``ms`` /
``plain_ms`` summed over its cases, one call each), and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and the exit code
is non-zero, with no result line. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
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

KERNEL_INFO = {
    "sr_attention": ("emip_tpu_torch/csrc/sr_attention.cu",
                     "emip_tpu/ops/pallas/sr_attention.py:293"),
    "window_attention_block": ("emip_tpu_torch/csrc/window_attention.cu",
                               "emip_tpu/ops/pallas/window_attention.py:1321"),
    "flow_attention": ("emip_tpu_torch/csrc/flow_attention.cu",
                       "emip_tpu/ops/pallas/corr_softmax.py:195"),
    "convex_upsample": ("emip_tpu_torch/csrc/convex_upsample.cu",
                        "emip_tpu/ops/pallas/convex_upsample.py:224"),
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


# ------------------------------------------------------------ kernels


def kernel_cases(batch: int, device):
    """(kernel, case label, kernel fn, plain fn, args) at the 352^2 shapes."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    rng = np.random.default_rng(SEED)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(device)

    cases = []
    for n, m, c, heads in ((7744, 121, 64, 1), (1936, 121, 128, 2),
                           (484, 121, 320, 5), (121, 121, 512, 8)):
        s = c**-0.5
        args = (r(batch, n, c), r(batch, m, c), r(c, c, scale=s),
                r(c, scale=0.1), r(2 * c, c, scale=s), r(2 * c, scale=0.1),
                r(c, c, scale=s), r(c, scale=0.1), heads)
        cases.append(("sr_attention", f"N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      args))

    c, f, tok, k2 = 128, 1024, 484, 4
    s = c**-0.5

    def layer(with_ffn):
        p = dict(wq=r(c, c, scale=s), wk=r(c, c, scale=s),
                 wv=r(c, c, scale=s), wm=r(c, c, scale=s),
                 s1=1.0 + r(c, scale=0.1), b1=r(c, scale=0.1))
        if with_ffn:
            p.update(w0=r(f, 2 * c, scale=(2 * c)**-0.5),
                     w2=r(c, f, scale=f**-0.5),
                     s2=1.0 + r(c, scale=0.1), b2=r(c, scale=0.1))
        return p

    x, t = r(2 * batch, k2, tok, c), r(2 * batch, k2, tok, c)
    sp, cp = layer(False), layer(True)
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
        # in turns (plain, kernel, kernel, plain), each the mean of two
        p1 = cuda_ms(lambda: ref(*args), reps)
        k1 = cuda_ms(lambda: fn(*args), reps)
        k2 = cuda_ms(lambda: fn(*args), reps)
        p2 = cuda_ms(lambda: ref(*args), reps)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"kernel {name:24s} {label:32s} max_abs_err={err:.3e} "
            f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} ({label}) disagrees with its plain "
                                 f"version: max_abs_err={err}, tol={tol}")
        entry = results.setdefault(name, dict(max_abs_err=0.0, ms=0.0,
                                              plain_ms=0.0, cases=[]))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        entry["cases"].append(dict(case=label, max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms))
        del got, want
    return results


# --------------------------------------------------------------- slice


def expected_launches(model) -> dict:
    """Kernel launches per forward implied by the model's structure."""
    pvt = model.backbone.feat_net.pvtv2_en
    blocks = sum(pvt.config.depths)
    return {
        "sr_attention": 2 * blocks,  # every PVT block, for both frames
        "window_attention_block": len(model.GMFlow.transformer.layers),
        "flow_attention": 3 if model.GMFlow.config.pred_bidir_flow else 2,
        "convex_upsample": 1,
    }


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
    if launches != want or min(launches.values()) == 0:
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

    model = EMIPShort(EMIPShortConfig(backbone_name="pvt_v2_b5",
                                      inp_size=SIZE))
    seeded_init_(model, SEED)
    model = model.to(device).eval()
    slice_res = slice_phase(model, BATCH, SIZE, device, TIMED_BATCHES)

    line = {"kernels": [
        dict(name=name, route="cuda", source=KERNEL_INFO[name][0],
             replaces=KERNEL_INFO[name][1],
             launches=slice_res["launches"][name],
             max_abs_err=kernels[name]["max_abs_err"],
             ms=kernels[name]["ms"], plain_ms=kernels[name]["plain_ms"],
             cases=kernels[name]["cases"])
        for name in KERNEL_INFO]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=line["kernels"], slice=slice_res),
                  f, indent=1)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
