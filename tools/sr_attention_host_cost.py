#!/usr/bin/env python3
"""Host time per call of kernel A's, B's or H's bf16 forward, on one GPU.

    python3 tools/sr_attention_host_cost.py [--kernel A|B|H] TREE [TREE ...]

Each TREE is a checkout root (it holds ``emip_tpu_torch/``); each is run in
a process of its own, in the order given (run two trees as REF NEW NEW REF
to compare them). A (the default): the four PVT stages of pvt_v2_b5 at
352^2 (batch 8, bf16 tokens and weights, fp32 biases); B: its windows at
352^2, [16, 4, 484, 128] with the shift mask; H: [2, 4, 1024, 128] and [8,
4, 1024, 128] with the shift mask (512^2, 1 and 4 clips); bf16 x and t,
fp32 parameters; seeded. After 20 warm-up calls: five runs of 300 calls (B,
H: 100) with no synchronisation inside, timed on the host clock to the last
enqueue and to the synchronise after it, in microseconds per call. Where
the first reads as the second, the host and not the card sets the pace of
back-to-back calls. Prints the card's ``nvidia-smi`` name and power limit,
then one line per tree. Imports no JAX.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

STAGES = ((7744, 121, 64, 1), (1936, 121, 128, 2), (484, 121, 320, 5),
          (121, 121, 512, 8))
BATCH = 8
WARMUP = 20
CALLS = 300
RUNS = 5


def _cases(kernel: str, r, dev):
    """(label, fn, args) of the kernel's cases."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    bf = torch.bfloat16
    if kernel == "A":
        for n, m, c, heads in STAGES:
            s = c**-0.5
            yield (f"C={c}", K.fused_sr_attention,
                   (r(BATCH, n, c).to(bf), r(BATCH, m, c).to(bf),
                    r(c, c, scale=s).to(bf), r(c, scale=0.1),
                    r(2 * c, c, scale=s).to(bf), r(2 * c, scale=0.1),
                    r(c, c, scale=s).to(bf), r(c, scale=0.1), heads))
        return
    c, f = 128, 1024

    def layer(ffn):
        s = c**-0.5
        p = {k: r(c, c, scale=s) for k in ("wq", "wk", "wv", "wm")}
        p.update(s1=1 + r(c, scale=0.1), b1=r(c, scale=0.1))
        if ffn:
            p.update(w0=r(f, 2 * c, scale=(2 * c)**-0.5),
                     w2=r(c, f, scale=f**-0.5), s2=1 + r(c, scale=0.1),
                     b2=r(c, scale=0.1))
        return p

    if kernel == "B":
        mask = shifted_window_mask(44, 44, 2, device=dev)
        yield ("[16,4,484,128] masked", K.fused_window_attention_block,
               (r(16, 4, 484, c).to(bf), r(16, 4, 484, c).to(bf),
                layer(False), layer(True), mask))
        return
    mask = shifted_window_mask(64, 64, 2, device=dev)
    for b in (2, 8):
        yield (f"[{b},4,1024,128] masked", K.fused_window_attention_ffn_layer,
               (r(b, 4, 1024, c).to(bf), r(b, 4, 1024, c).to(bf),
                layer(True), mask))


def worker(tree: str, kernel: str) -> str:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    calls = CALLS if kernel == "A" else CALLS // 3
    out = []
    for label, fn, args in _cases(kernel, r, dev):
        with torch.no_grad():
            for _ in range(WARMUP):
                fn(*args)
            torch.cuda.synchronize()
            enqueue, synced = [], []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                enqueue.append((t1 - t0) / calls * 1e6)
                synced.append((t2 - t0) / calls * 1e6)
        out.append(f"{label}: enqueue {statistics.median(enqueue):.1f} "
                   f"us/call (runs {' '.join(f'{e:.1f}' for e in enqueue)}), "
                   f"to the synchronise {statistics.median(synced):.1f}")
    return f"{tree} | " + "; ".join(out)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    kernel = "A"
    if args[:1] == ["--kernel"]:
        kernel, args = args[1], args[2:]
    if args[:1] == ["--worker"]:
        print(worker(args[1], kernel), flush=True)
        return 0
    if not args or kernel not in ("A", "B", "H"):
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in args:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--kernel", kernel,
             "--worker", tree],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
