#!/usr/bin/env python3
"""Registers, spills and tensor-core instructions of the port's CUDA kernels.

    python3 tools/kernel_resources.py [SOURCE ...] [--match TEXT]

Compiles each named source of ``emip_tpu_torch/csrc`` (all ``*.cu`` when
none is named, e.g. ``memory_attention dwconv_gelu``) with the flags of
``emip_tpu_torch/kernels/_build.py`` plus ``-Xptxas -v`` into a cubin under
``build/kernel_resources/``, and prints one line per kernel: its registers a
thread, spill stores and loads (bytes a thread, from ptxas), and how many
``HGMMA`` (warpgroup) and ``HMMA`` (warp) tensor-core instructions and
``UTMALDG`` (TMA load) instructions its SASS holds (``cuobjdump -sass``).
``--match`` keeps the kernels whose mangled name contains TEXT. Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit of the machine with the card);
runs no kernel and needs no GPU.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from emip_tpu_torch.kernels._build import CSRC, NVCC_FLAGS, find_nvcc  # noqa


def ptxas_lines(log: str) -> dict:
    """kernel -> (registers, spill store bytes, spill load bytes)."""
    out, name = {}, None
    spills = (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def sass_counts(sass: str) -> dict:
    """kernel -> {opcode: count} for HGMMA, HMMA and UTMALDG."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"HGMMA": 0, "HMMA": 0, "UTMALDG": 0}
        elif name:
            for op in out[name]:
                if re.search(r"\b" + op + r"\b", line):
                    out[name][op] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--match", default="")
    opts = ap.parse_args(argv)
    nvcc = find_nvcc()
    if nvcc is None:
        print("kernel_resources: nvcc not found", file=sys.stderr)
        return 2
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    names = opts.sources or sorted(p.stem for p in CSRC.glob("*.cu"))
    out_dir = os.path.join(ROOT, "build", "kernel_resources")
    os.makedirs(out_dir, exist_ok=True)
    for stem in names:
        cubin = os.path.join(out_dir, stem + ".cubin")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-cubin",
             str(CSRC / (stem + ".cu")), "-o", cubin],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        regs = ptxas_lines(proc.stdout + proc.stderr)
        sass = subprocess.run([cuobjdump, "-sass", cubin],
                              capture_output=True, text=True, check=True)
        ops = sass_counts(sass.stdout)
        for name in sorted(regs):
            if opts.match not in name:
                continue
            r, st, ld = regs[name]
            count = ops.get(name, {})
            print(f"{stem}: {name} registers {r} spill stores {st} B loads "
                  f"{ld} B " + " ".join(f"{k} {v}" for k, v in count.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
