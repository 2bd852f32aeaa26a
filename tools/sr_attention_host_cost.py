#!/usr/bin/env python3
"""Host time per call of kernel A's bf16 forward, on one GPU.

    python3 tools/sr_attention_host_cost.py TREE [TREE ...]

Each TREE is a checkout root (it holds ``emip_tpu_torch/``); each is run in
a process of its own, in the order given (run two trees as REF NEW NEW REF
to compare them). At the four PVT stages of pvt_v2_b5 at 352^2 (batch 8,
bf16 tokens and weights, fp32 biases, seeded), after 20 warm-up calls: five
runs of 300 calls with no synchronisation inside, timed on the host clock
to the last enqueue and to the synchronise after it, in microseconds per
call. Where the first reads as the second, the host and not the card sets
the pace of back-to-back calls. Prints the card's ``nvidia-smi`` name and
power limit, then one line per tree. Imports no JAX.
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


def worker(tree: str) -> str:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from emip_tpu_torch import kernels as K

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    out = []
    for n, m, c, heads in STAGES:
        s = c**-0.5
        args = (r(BATCH, n, c).to(bf), r(BATCH, m, c).to(bf),
                r(c, c, scale=s).to(bf), r(c, scale=0.1),
                r(2 * c, c, scale=s).to(bf), r(2 * c, scale=0.1),
                r(c, c, scale=s).to(bf), r(c, scale=0.1), heads)
        with torch.no_grad():
            for _ in range(WARMUP):
                K.fused_sr_attention(*args)
            torch.cuda.synchronize()
            enqueue, synced = [], []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                for _ in range(CALLS):
                    K.fused_sr_attention(*args)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                enqueue.append((t1 - t0) / CALLS * 1e6)
                synced.append((t2 - t0) / CALLS * 1e6)
        out.append(f"C={c}: enqueue {statistics.median(enqueue):.1f} us/call "
                   f"(runs {' '.join(f'{e:.1f}' for e in enqueue)}), to the "
                   f"synchronise {statistics.median(synced):.1f}")
    return f"{tree} | " + "; ".join(out)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--worker"]:
        print(worker(args[1]), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in args:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
