#!/usr/bin/env python3
"""Per-layer time of the PyTorch port's short inference slice on one GPU.

    python3 tools/profile_torch_slice.py [--batch 8] [--timed 5] [--trace F]

Runs the full pvt_v2_b5 EMIPShort at 352^2, fp32 (TF32 off), on seeded
random weights and seeded frames, as ``chip_smoke.py``'s slice phase does,
and prints:

- the card's ``nvidia-smi`` name and power limit;
- the median ms per batch of ``predict_arrays`` over ``--timed`` batches
  after two warm-ups (CUDA events);
- per top-level module, the ms per batch between CUDA events recorded by
  forward pre/post hooks, and its share of the median;
- from one ``torch.profiler`` run, the device self-time of the 30 largest
  kernels, their sum, and the device's idle share: one minus that sum over
  the unprofiled median batch time (one stream, so kernels do not overlap).

``--trace`` writes the profiler's Chrome trace to that file. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def module_table(model) -> dict:
    gm = model.GMFlow
    return {
        "pvt backbone": model.backbone,
        "flow cnn encoder": gm.backbone,
        "injector (feeder)": model.injector,
        "flow transformer": gm.transformer,
        "flow propagation": gm.feature_flow_attn,
        "upsampler convs": gm.upsampler,
        "conv_corr": model.conv_corr,
        "injector1 (collector)": model.injector1,
        "dr1": model.dr1, "dr2": model.dr2, "dr3": model.dr3,
        "decoder": model.decoder,
    }


def attach_event_hooks(modules: dict) -> dict:
    """Record a CUDA event pair around every call of each module."""
    import torch

    pairs = {name: [] for name in modules}
    for name, mod in modules.items():
        def pre(_mod, _inp, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pairs[name].append([ev, None])

        def post(_mod, _inp, _out, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pairs[name][-1][1] = ev

        mod.register_forward_pre_hook(pre)
        mod.register_forward_hook(post)
    return pairs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--timed", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_

    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.library()
    dev = torch.device("cuda:0")
    model = EMIPShort(EMIPShortConfig(backbone_name="pvt_v2_b5",
                                      inp_size=cs.SIZE))
    seeded_init_(model, cs.SEED)
    model = model.to(dev).eval()
    rng = np.random.default_rng(cs.SEED + 1)
    a, b = (torch.from_numpy(cs.seeded_frames(rng, args.batch, cs.SIZE))
            .to(dev) for _ in range(2))

    pairs = attach_event_hooks(module_table(model))
    for _ in range(2):
        predict_arrays(model, a, b)
    torch.cuda.synchronize()
    for p in pairs.values():
        p.clear()
    totals = []
    for _ in range(args.timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        predict_arrays(model, a, b)
        end.record()
        torch.cuda.synchronize()
        totals.append(start.elapsed_time(end))
    median = statistics.median(totals)
    print(f"slice b5 {cs.SIZE}^2 bs={args.batch} fp32: median {median:.3f} "
          f"ms/batch over {args.timed} batches {totals}")
    per_layer = {name: sum(s.elapsed_time(e) for s, e in p) / args.timed
                 for name, p in pairs.items()}
    for name, ms in sorted(per_layer.items(), key=lambda kv: -kv[1]):
        print(f"layer {name:24s} {ms:9.3f} ms/batch {100 * ms / median:6.2f}%")
    rest = median - sum(per_layer.values())
    print(f"layer {'rest (outside hooks)':24s} {rest:9.3f} ms/batch "
          f"{100 * rest / median:6.2f}%")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        predict_arrays(model, a, b)
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        ms, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (end - start) / 1e3, count + 1)
    if not spans:
        print("profiler shows no device time; idle share not measured")
        return 1
    busy, reach = 0.0, -float("inf")  # union of the kernels' intervals, us
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy /= 1e3
    print(f"device busy {busy:.3f} ms in one profiled batch; idle share "
          f"{max(0.0, 1.0 - busy / median):.4f} of the median batch time")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for key, (ms, count) in rows[:30]:
        print(f"kernel {ms:9.3f} ms x{count:5d} {key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
