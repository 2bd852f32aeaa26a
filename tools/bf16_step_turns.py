#!/usr/bin/env python3
"""The bf16 short inference batch and the bf16 train, static and long train
steps of two checkouts of the port, in turns, on one GPU.

    python3 tools/bf16_step_turns.py --trees REF NEW [--steps 8]
        [--cells infer,train,static,long,long512,train512]
                                     [--out chiprun_out/bf16_step_turns.json]

REF and NEW are checkout roots (each holds ``emip_tpu_torch/``). Each turn
is a process of its own that imports one tree's package and runs, in the
bf16 band (``dtype=bfloat16`` on fp32 seeded weights, TF32 and cuBLAS's
reduced-precision bf16 reduction off) at pvt_v2_b5 352^2, batch 8, on
seeded frames:

- ``infer``: short inference of 8 frame pairs (``predict_arrays`` on
  ``EMIPShort(cfg, dtype=bfloat16)`` in eval mode), as ``chip_smoke.py``'s
  bf16 slice phase; a "step" is one batch;
- ``train``: the short train step (``short_train_step`` on
  ``EMIPShort(cfg, dtype=bfloat16)``: drop path 0.1, the hybrid-E and
  flow losses, clamp 0.5 + AdamW), as ``chip_smoke.py``'s bf16 train
  phase;
- ``static``: the static pretrain step (``static_train_step`` on
  ``SegNetwork("pvt_v2_b5", 32, dtype=bfloat16)``), as its bf16 static
  phase;
- ``long``: the long train step at 4 clips (``long_train_step`` on
  ``EMIPLong(cfg, 5, dtype=bfloat16)``: one frame encoded, the pair and
  the long head, kernel F's bf16 forward and backward once, clamp +
  AdamW over the long heads), as its bf16 long train phase, with the
  5-slot ring full (five frames pushed first);
- ``long512``: bf16 streaming at 512^2, 4 clips, the ring full
  (``step_cached`` on ``EMIPLong(cfg, 5, dtype=bfloat16)`` in inference
  mode, the carried encoding): windows of 1024 tokens, so kernels G and H
  (H's bf16 forward 6 times a step) in place of B, as ``chip_smoke.py``'s
  bf16 long inference at 512^2;
- ``train512``: the short train step at 512^2, batch 2 (as ``train``; its
  windows of 1024 tokens take kernels G and H in place of B, so G's and
  H's bf16 backwards run 6 times a step each), as ``chip_smoke.py``'s bf16
  train step at 512^2.

``--cells`` runs the named cells only (all six by default).

Per cell: two warm-up steps, ``--steps`` steps timed by CUDA events (and
the device memory's peak over them), one step counted from zero kernel
launches (the port's counters), then two
steps under ``torch.profiler``: the device's busy ms per step (the union
of its kernels' and copies' intervals), its idle share (one minus busy over
the median step) and the device launches per step. The turns run REF,
NEW, NEW, REF; the ratio REF / NEW of the step medians is given over all
steps and per half (turns 1-2 and 3-4): where the three fall on both sides
of 1 the call does not tell which tree is faster ("unresolved").

Prints the card's ``nvidia-smi`` name and power limit, one line per turn
and cell, and a summary line per cell; writes every step to ``--out``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 352
BATCH = 8
SEED = 0
WARMUP = 2
PROFILED = 2
SIZE_512 = 512
CELLS = ("infer", "train", "static", "long", "long512", "train512")
BATCH_512 = 2  # the 512^2 train step's pairs
LONG_CLIPS = 4
MEMORY = 5  # the ring's slots


def _frames(rng, n: int, device, size: int = SIZE):
    import torch

    from emip_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

    img = rng.uniform(0.0, 1.0, (n, 3, size, size)).astype(np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)[:, None, None]
    std = np.asarray(IMAGENET_STD, np.float32)[:, None, None]
    return torch.from_numpy((img - mean) / std).to(device)


def _batch(rng, device, batch: int = BATCH, size: int = SIZE) -> dict:
    import torch

    gt = (rng.uniform(size=(batch, 1, size, size)) > 0.5).astype(np.float32)
    return dict(image1=_frames(rng, batch, device, size),
                image2=_frames(rng, batch, device, size),
                gt=torch.from_numpy(gt).to(device))


def _measure(step, steps: int) -> dict:
    """Timed steps, one step's kernel launches, then the profiled steps'
    device busy time and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from emip_tpu_torch import kernels as K

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    K.reset_launches()
    step()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events)
    busy, reach = 0.0, -float("inf")  # us
    for s, e in spans:
        busy += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    busy_ms = busy / 1e3 / PROFILED
    median = statistics.median(times)
    return dict(step_ms=times, median_ms=median, device_busy_ms=busy_ms,
                idle=1.0 - busy_ms / median,
                device_launches_per_step=len(events) / PROFILED,
                kernel_launches_per_step=launches, peak_gib=peak)


def worker(tree: str, steps: int, cells=CELLS) -> dict:
    """The ``cells`` on ``tree``'s package; returns their measurements."""
    sys.path.insert(0, os.path.abspath(tree))
    import dataclasses

    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda:0")
    K.library()
    out = {}

    cfg = EMIPShortConfig(backbone_name="pvt_v2_b5", inp_size=SIZE)
    m32 = EMIPShort(cfg)
    seeded_init_(m32, SEED)
    if "infer" in cells:
        model = EMIPShort(cfg, dtype=torch.bfloat16)
        model.load_state_dict(m32.state_dict())
        model = model.to(device).eval()
        rng = np.random.default_rng(SEED + 1)
        pairs = itertools.cycle([(_frames(rng, BATCH, device),
                                  _frames(rng, BATCH, device))
                                 for _ in range(2)])
        out["infer"] = _measure(
            lambda: predict_arrays(model, *next(pairs)), steps)
        del model, pairs
        torch.cuda.empty_cache()

    if "train" in cells:
        model = EMIPShort(cfg, dtype=torch.bfloat16)
        model.load_state_dict(m32.state_dict())
        model = model.to(device)
        opt = build_optimizer(model)
        gen = torch.Generator(device=device).manual_seed(SEED)
        rng = np.random.default_rng(SEED + 5)
        batches = itertools.cycle([_batch(rng, device) for _ in range(2)])
        out["train"] = _measure(
            lambda: short_train_step(model, opt, next(batches), gen), steps)
        del model, opt, batches
        torch.cuda.empty_cache()
    del m32

    if "static" in cells:
        out["static"] = _static(steps, device)
    if "long" in cells:
        out["long"] = _long(cfg, steps, device)
    if "long512" in cells:
        out["long512"] = _long512(
            dataclasses.replace(cfg, inp_size=SIZE_512), steps, device)
    if "train512" in cells:
        out["train512"] = _train512(
            dataclasses.replace(cfg, inp_size=SIZE_512), steps, device)
    return out


def _train512(cfg, steps: int, device) -> dict:
    """The bf16 short train step at 512^2, batch 2."""
    import torch

    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    m32 = seeded_init_(EMIPShort(cfg), SEED)
    model = EMIPShort(cfg, dtype=torch.bfloat16)
    model.load_state_dict(m32.state_dict())
    del m32
    model = model.to(device)
    opt = build_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 20)
    batches = itertools.cycle([_batch(rng, device, BATCH_512, SIZE_512)
                               for _ in range(2)])
    out = _measure(
        lambda: short_train_step(model, opt, next(batches), gen), steps)
    del model, opt, batches
    torch.cuda.empty_cache()
    return out


def _static(steps: int, device) -> dict:
    import torch

    from emip_tpu_torch.models.emip_short import SegNetwork
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.state import ClampAdamW
    from emip_tpu_torch.train.static import static_train_step

    m32 = seeded_init_(SegNetwork("pvt_v2_b5", 32), SEED)
    model = SegNetwork("pvt_v2_b5", 32, dtype=torch.bfloat16)
    model.load_state_dict(m32.state_dict())
    del m32
    model = model.to(device)
    opt = ClampAdamW(model.parameters(), 1e-5, 1e-7, 0.5)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 8)
    imgs = []
    for _ in range(2):
        b = _batch(rng, device)
        imgs.append(dict(image=b["image1"], gt=b["gt"]))
    imgs = itertools.cycle(imgs)
    out = _measure(
        lambda: static_train_step(model, opt, next(imgs), gen), steps)
    del model, opt, imgs
    torch.cuda.empty_cache()
    return out


def _long(cfg, steps: int, device) -> dict:
    import torch

    from emip_tpu_torch.models.emip_long import EMIPLong
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.long import CachedStep, long_train_step
    from emip_tpu_torch.train.state import build_long_optimizer

    m32 = seeded_init_(EMIPLong(cfg, memory_size=MEMORY), SEED)
    model = EMIPLong(cfg, memory_size=MEMORY, dtype=torch.bfloat16)
    model.load_state_dict(m32.state_dict())
    del m32
    model = model.to(device)
    opt = build_long_optimizer(model)
    rng = np.random.default_rng(SEED + 18)
    video = _frames(rng, LONG_CLIPS * (MEMORY + 2), device).reshape(
        LONG_CLIPS, MEMORY + 2, 3, SIZE, SIZE)
    gt = torch.from_numpy((rng.uniform(size=(LONG_CLIPS, 1, SIZE, SIZE))
                           > 0.5).astype(np.float32)).to(device)
    with torch.no_grad():  # fill the ring: frames 1..5 pushed
        model.eval()
        enc = model.encode_frame(video[:, 0])
        state = model.init_memory(LONG_CLIPS)
        for i in range(1, MEMORY + 1):
            _, enc, state = model.step_cached(enc, video[:, i], state)
    if not bool(state.valid.all()):
        raise SystemExit("the long cell's ring is not full")
    out = _measure(
        lambda: long_train_step(CachedStep(model), opt, enc,
                                video[:, MEMORY + 1], gt, state), steps)
    del model, opt
    torch.cuda.empty_cache()
    return out


def _long512(cfg, steps: int, device) -> dict:
    """bf16 streaming at 512^2: ``step_cached`` of 4 clips on a full ring
    (the carried encoding and ring are not advanced, so every step reads
    the same state)."""
    import torch

    from emip_tpu_torch.models.emip_long import EMIPLong
    from emip_tpu_torch.models.init import seeded_init_

    m32 = seeded_init_(EMIPLong(cfg, memory_size=MEMORY), SEED)
    model = EMIPLong(cfg, memory_size=MEMORY, dtype=torch.bfloat16)
    model.load_state_dict(m32.state_dict())
    del m32
    model = model.to(device).eval()
    rng = np.random.default_rng(SEED + 19)
    video = _frames(rng, LONG_CLIPS * (MEMORY + 2), device,
                    SIZE_512).reshape(LONG_CLIPS, MEMORY + 2, 3, SIZE_512,
                                      SIZE_512)
    with torch.inference_mode():
        enc = model.encode_frame(video[:, 0])
        state = model.init_memory(LONG_CLIPS)
        for i in range(1, MEMORY + 1):
            _, enc, state = model.step_cached(enc, video[:, i], state)
    if not bool(state.valid.all()):
        raise SystemExit("the long512 cell's ring is not full")

    def step():
        with torch.inference_mode():
            model.step_cached(enc, video[:, MEMORY + 1], state)

    out = _measure(step, steps)
    del model
    torch.cuda.empty_cache()
    return out


def _verdict(ratios) -> str:
    if all(r > 1 for r in ratios):
        return "NEW faster"
    if all(r < 1 for r in ratios):
        return "NEW slower"
    return "unresolved"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("REF", "NEW"))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells to run (default: all)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "bf16_step_turns.json"))
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    cells = tuple(c for c in CELLS if c in opts.cells.split(","))
    if opts.worker:
        print("RESULT " + json.dumps(worker(opts.worker, opts.steps, cells)),
              flush=True)
        return 0
    if not opts.trees:
        ap.error("--trees REF NEW is required")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ref, new = opts.trees
    turns = []
    for label, tree in (("REF", ref), ("NEW", new), ("NEW", new),
                        ("REF", ref)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--steps", str(opts.steps), "--cells", ",".join(cells)],
            capture_output=True, text=True, timeout=1200)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if proc.returncode or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {len(turns) + 1} ({tree}) failed")
        res = json.loads(line[0][len("RESULT "):])
        turns.append(dict(tree=label, **res))
        for cell in cells:
            r = res[cell]
            print(f"turn {len(turns)} {label} {cell}: median "
                  f"{r['median_ms']:.3f} ms (steps "
                  + " ".join(f"{t:.1f}" for t in r["step_ms"])
                  + f"); busy {r['device_busy_ms']:.3f} ms, idle "
                  f"{r['idle']:.3f}, {r['device_launches_per_step']:g} "
                  f"device launches a step, peak {r['peak_gib']:.3f} GiB; "
                  f"kernels "
                  f"{r['kernel_launches_per_step']}", flush=True)
    med = statistics.median
    summary = {}
    for cell in cells:
        steps = {lab: [t for tr in turns if tr["tree"] == lab
                       for t in tr[cell]["step_ms"]] for lab in ("REF", "NEW")}
        halves = (med(turns[0][cell]["step_ms"]) /
                  med(turns[1][cell]["step_ms"]),
                  med(turns[3][cell]["step_ms"]) /
                  med(turns[2][cell]["step_ms"]))
        ratio = med(steps["REF"]) / med(steps["NEW"])
        busy = {lab: [tr[cell]["device_busy_ms"] for tr in turns
                      if tr["tree"] == lab] for lab in ("REF", "NEW")}
        idle = {lab: [tr[cell]["idle"] for tr in turns if tr["tree"] == lab]
                for lab in ("REF", "NEW")}
        dev = {lab: [tr[cell]["device_launches_per_step"] for tr in turns
                     if tr["tree"] == lab] for lab in ("REF", "NEW")}
        peak = {lab: [tr[cell]["peak_gib"] for tr in turns
                      if tr["tree"] == lab] for lab in ("REF", "NEW")}
        summary[cell] = dict(ratio=ratio, halves=halves,
                             verdict=_verdict((ratio, *halves)),
                             median_ms={k: med(v) for k, v in steps.items()},
                             busy_ms=busy, idle=idle,
                             device_launches_per_step=dev, peak_gib=peak)
        print(f"{cell}: REF / NEW x{ratio:.3f} (halves x{halves[0]:.3f}, "
              f"x{halves[1]:.3f}): {summary[cell]['verdict']}; medians "
              f"{med(steps['REF']):.3f} / {med(steps['NEW']):.3f} ms; busy "
              f"{busy['REF']} / {busy['NEW']} ms; idle {idle['REF']} / "
              f"{idle['NEW']}; device launches a step {dev['REF']} / "
              f"{dev['NEW']}; peak {peak['REF']} / {peak['NEW']} GiB",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(dict(card=card, trees=dict(REF=ref, NEW=new),
                       turns=turns, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
