#!/usr/bin/env python3
"""Per-layer time of the PyTorch port's short and long slices on one GPU.

    python3 tools/profile_torch_slice.py [--long] [--train] [--batch 8]
                                         [--size 352] [--timed 5] [--trace F]

Runs the full pvt_v2_b5 EMIPShort at 352^2 (``--size 512``: at 512^2, where
the flow transformer runs kernels G and H), fp32 (TF32 off), on seeded
random weights and seeded frames, as ``chip_smoke.py``'s slice phase (or,
with ``--train``, its train phase) does. With ``--long`` it runs the full
EMIPLong instead: one streaming ``step_cached`` per batch on a full
5-slot memory with ``--batch`` clips side by side (``--train``: one
per-frame long train step). It prints:

- the card's ``nvidia-smi`` name and power limit;
- the median ms per batch of ``predict_arrays`` (``--train``: per train
  step, split into forward + losses, backward and optimizer) over
  ``--timed`` batches after two warm-ups (CUDA events, no hooks);
- per top-level module, the ms per batch between CUDA events recorded by
  forward pre/post hooks (``--train``: and by backward pre/post hooks),
  and its share of the median of those hooked batches;
- from one ``torch.profiler`` run without hooks, the device self-time of
  the 30 largest kernels, their sum, and the device's idle share: one
  minus that sum over the median without hooks (one stream, so kernels
  do not overlap).

``--trace`` writes the profiler's Chrome trace to that file. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def module_table(model, backward: bool = False) -> dict:
    """Layer name -> the modules whose calls (or backwards) it sums. The
    backbone returns a list, which a backward hook cannot see, so in the
    backward its 52 blocks are timed instead (patch embeds and stage norms
    fall under "rest")."""
    gm = model.GMFlow
    pvt = model.backbone.feat_net.pvtv2_en
    blocks = [blk for i in range(len(pvt.config.depths))
              for blk in getattr(pvt, f"block{i + 1}")]
    table = {
        "pvt backbone": blocks if backward else model.backbone,
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
    return {k: v if isinstance(v, list) else [v] for k, v in table.items()}


def long_module_table(model, backward: bool = False) -> dict:
    """The long model's layers: the frozen short-term net's (forward only:
    it takes no gradient) and the long heads."""
    table = {} if backward else {
        f"short {k}": v for k, v in module_table(model.short_term).items()
        if k not in ("injector1 (collector)", "dr1", "decoder")}
    heads = {
        "ltm fusion": model.LTM.fusion, "ltm kv memory": model.LTM.KV_M_r4,
        "ltm kv query": model.LTM.KV_Q_r4, "long_dr": model.long_dr,
        "long injector1": model.injector1, "long dr1": model.dr1,
        "long decoder": model.decoder}
    table.update({k: [v] for k, v in heads.items()})
    return table


def attach_event_hooks(modules: dict, backward: bool = False,
                       handles: list | None = None) -> dict:
    """Record a CUDA event pair around every call of each module (with
    ``backward``, around every backward through it instead); the hook
    handles are appended to ``handles``."""
    import torch

    pairs = {name: [] for name in modules}
    for name, mod in ((n, m) for n, ms in modules.items() for m in ms):
        def pre(_mod, _inp, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pairs[name].append([ev, None])

        def post(_mod, _inp, _out, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pairs[name][-1][1] = ev

        if backward:
            hs = (mod.register_full_backward_pre_hook(pre),
                  mod.register_full_backward_hook(post))
        else:
            hs = (mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post))
        if handles is not None:
            handles.extend(hs)
    return pairs


def layer_rows(pairs: dict, runs: int, median: float, tag: str) -> float:
    per_layer = {name: sum(s.elapsed_time(e) for s, e in p if e is not None)
                 / runs for name, p in pairs.items()}
    for name, ms in sorted(per_layer.items(), key=lambda kv: -kv[1]):
        print(f"layer {tag}{name:24s} {ms:9.3f} ms/batch "
              f"{100 * ms / median:6.2f}%")
    return sum(per_layer.values())


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--timed", type=int, default=5)
    ap.add_argument("--size", type=int, default=352,
                    help="input size: 352, or 512 (windows of 1024 tokens: "
                         "kernels G and H in place of B)")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of inference")
    ap.add_argument("--long", action="store_true",
                    help="profile the long-term model (one streaming step "
                         "per batch of clips) instead of the short one")
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
    cfg = EMIPShortConfig(backbone_name="pvt_v2_b5", inp_size=args.size)
    if args.long:
        from emip_tpu_torch.models.emip_long import EMIPLong

        model = EMIPLong(cfg, memory_size=5)
    else:
        model = EMIPShort(cfg)
    seeded_init_(model, cs.SEED)
    model = model.to(dev).eval()
    table = long_module_table if args.long else module_table
    rng = np.random.default_rng(cs.SEED + 1)
    a, b = (torch.from_numpy(cs.seeded_frames(rng, args.batch, args.size))
            .to(dev) for _ in range(2))

    if args.long:
        from emip_tpu_torch.losses.seg import hybrid_e_loss
        from emip_tpu_torch.train.state import build_long_optimizer

        # a full ring and the previous frame's encoding, reused by every
        # timed step
        video = cs.seeded_clip(rng, args.batch, 6, args.size, dev)
        with torch.inference_mode():
            state = model.init_memory(args.batch)
            enc = model.encode_frame(video[:, 0])
            for t in range(1, 6):
                _, enc, state = model.step_cached(enc, video[:, t], state)
        state = type(state)(*(x.clone() for x in state))
        enc = dict(fea=tuple(x.clone() for x in enc["fea"]),
                   inj=enc["inj"].clone())
        gt = cs.seeded_batch(rng, args.batch, args.size, dev)["gt"]
        if args.train:
            opt = build_long_optimizer(model)
            model.train()

            def run(split=None):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                mask, _, _ = model.step_cached(enc, a, state)
                loss = hybrid_e_loss(mask, gt)
                ev[1].record()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                ev[2].record()
                opt.step()
                ev[3].record()
                if split is not None:
                    split.append(ev)
        else:
            def run(split=None):
                with torch.inference_mode():
                    model.step_cached(enc, a, state)
    elif args.train:
        from emip_tpu_torch.train.short import short_losses
        from emip_tpu_torch.train.state import build_optimizer

        opt = build_optimizer(model)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        batch = cs.seeded_batch(rng, args.batch, args.size, dev)
        model.train()

        def run(split=None):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = short_losses(model, batch, gen)["loss"]
            ev[1].record()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            ev[2].record()
            opt.step()
            ev[3].record()
            if split is not None:
                split.append(ev)
    else:
        def run(split=None):
            predict_arrays(model, a, b)

    def timed(splits=None) -> tuple[float, list]:
        totals = []
        for _ in range(args.timed):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(splits)
            end.record()
            torch.cuda.synchronize()
            totals.append(start.elapsed_time(end))
        return statistics.median(totals), totals

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    # the median without hooks: the hooks' host work (and, in the
    # backward, their autograd nodes) slow the step down
    splits = []
    median, totals = timed(splits)
    what = "train step" if args.train else "slice"
    if args.long:
        what = "long " + ("train step" if args.train else "streaming step")
    print(f"{what} b5 {args.size}^2 bs={args.batch} fp32: median {median:.3f} "
          f"ms/batch over {args.timed} batches {totals} (no hooks)")
    if args.train:
        for i, part in enumerate(("forward + losses", "backward",
                                  "optimizer")):
            ms = statistics.median(e[i].elapsed_time(e[i + 1])
                                   for e in splits)
            print(f"phase {part:18s} {ms:9.3f} ms/step "
                  f"{100 * ms / median:6.2f}%")

    handles = []
    pairs = attach_event_hooks(table(model), handles=handles)
    if args.train:
        bwd_pairs = attach_event_hooks(table(model, backward=True),
                                       backward=True, handles=handles)
    hooked_median, _ = timed()
    print(f"with hooks: median {hooked_median:.3f} ms/batch; layer shares "
          f"are of that median")
    hooked = layer_rows(pairs, args.timed, hooked_median,
                        "fwd " if args.train else "")
    if args.train:
        hooked += layer_rows(bwd_pairs, args.timed, hooked_median, "bwd ")
    rest = hooked_median - hooked
    print(f"layer {'rest (outside hooks)':24s} {rest:9.3f} ms/batch "
          f"{100 * rest / hooked_median:6.2f}%")
    for h in handles:
        h.remove()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for ev in prof.events():
        # record_function ranges (e.g. Optimizer.step) are mirrored onto
        # the device timeline as annotations; they are not kernels
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
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
