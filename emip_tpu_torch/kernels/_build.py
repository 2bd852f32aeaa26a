"""Build and load the port's CUDA kernels.

The sources in ``emip_tpu_torch/csrc/*.cu`` are compiled at first use by
``nvcc``, one process per source, all started together, and linked into
one shared library with a plain C interface, which is loaded with
``ctypes``. The library goes to ``build/emip_tpu_torch/<hash>/`` under
the repository root, keyed by a hash of the sources and the flags, so an
edited source is rebuilt and an unchanged one is not. Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["library", "find_nvcc", "KernelBuildError", "build_seconds"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "emip_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argument types of each C entry point (pointers, then ints/floats, stream)
# and the result types of those that return other than a cudaError_t
_SIGNATURES = {
    "emip_sr_attention": [_P] * 14 + [_L] + [_I] * 5 + [_P],
    "emip_sr_attention_bwd": [_P] * 22 + [_L] + [_I] * 5 + [_P],
    "emip_window_block": ([_P] * 19 + [_I] + [_P] * 14 + [_L] + [_I] * 4
                          + [_F, _P]),
    "emip_window_block_bwd": ([_P] * 16 + [_I] + [_P] * 32 + [_L]
                              + [_I] * 4 + [_F, _P]),
    "emip_window_layer": ([_P] * 9 + [_I] + [_P] * 6 + [_L] + [_I] * 4
                          + [_F, _P]),
    "emip_window_layer_bwd": ([_P] * 8 + [_I] + [_P] * 14 + [_L] + [_I] * 4
                              + [_F, _P]),
    "emip_window_ffn_layer": ([_P] * 13 + [_I] + [_P] * 10 + [_L] + [_I] * 4
                              + [_F, _P]),
    "emip_window_ffn_layer_bwd": ([_P] * 11 + [_I] + [_P] * 22 + [_L]
                                  + [_I] * 4 + [_F, _P]),
    "emip_attention_fwd": ([_P, _L, _I] * 3 + [_P, _I, _P, _L, _I, _P, _P, _L]
                           + [_I] * 6 + [_P]),
    "emip_attention_fwd_workspace": [_I] * 6,
    "emip_gemm": ([_P, _L, _L, _P, _L, _L, _P, _P, _L] + [_I] * 4
                  + [_P, _L, _P]),
    "emip_flow_attention": [_P] * 6 + [_L] + [_I] * 4 + [_P],
    "emip_flow_attention_bwd": [_P] * 10 + [_L] + [_I] * 4 + [_P],
    "emip_convex_upsample": [_P] * 3 + [_I] * 4 + [_P],
    "emip_convex_upsample_bwd": [_P] * 6 + [_I] * 4 + [_P],
    "emip_splat_density": [_P] * 3 + [_L] + [_I] * 3 + [_P],
    "emip_splat_density_workspace": [_I] * 3,
    "emip_memory_attention": [_P] * 7 + [_L] + [_I] * 4 + [_P],
    "emip_memory_attention_bwd": [_P] * 11 + [_L] + [_I] * 4 + [_P],
    "emip_softmax_expectation": [_P] * 3 + [_L, _I, _P],
    "emip_softmax_expectation_bwd": [_P] * 6 + [_L, _L, _I, _P],
    "emip_softmax_expectation_bwd_workspace": [_L, _I],
    "emip_dwconv_gelu": [_P] * 4 + [_I] * 4 + [_P],
    "emip_dwconv_gelu_bwd": [_P] * 8 + [_L] + [_I] * 4 + [_P],
    "emip_dwconv_gelu_bwd_workspace": [_I] * 4,
    # the bf16 band of short inference: A, B, C and D forward, the GEMM
    # and the attention alone
    "emip_sr_attention_bf16": [_P] * 10 + [_I] * 5 + [_P],
    "emip_window_block_bf16": ([_P] * 19 + [_I, _P, _I] + [_P] * 11 + [_L]
                               + [_I] * 4 + [_F, _P]),
    "emip_flow_attention_bf16": [_P] * 4 + [_I] * 3 + [_P],
    "emip_convex_upsample_bf16": [_P] * 3 + [_I] * 4 + [_P],
    "emip_gemm_bf16": [_P, _L, _P, _L, _P, _P, _L] + [_I] * 4 + [_P],
    # the wgmma product of B's and H's bf16 forwards alone
    "emip_gemm_wgmma": ([_P, _L, _I, _P, _L] + [_I] * 3 + [_P, _P]
                        + [_I] * 3 + [_P] * 3 + [_L, _F, _P]),
    # and the input grads dy W of G's and H's bf16 backwards, on it or on
    # the 3xTF32 GEMM
    "emip_gemm_dyw": ([_P, _L, _I, _P, _P] + [_I] * 3 + [_P, _P]
                      + [_I] * 2 + [_P, _L, _I, _P]),
    "emip_attention_fwd_bf16": ([_P, _L, _I] * 3
                                + [_P, _I, _I, _P, _P, _L, _I]
                                + [_I] * 6 + [_P]),
    # the bf16 train step: A, B, C and D backward
    "emip_sr_attention_bwd_bf16": [_P] * 18 + [_L] + [_I] * 5 + [_P],
    "emip_window_block_bwd_bf16": ([_P] * 18 + [_I] + [_P] * 20 + [_L]
                                   + [_I] * 4 + [_F, _P]),
    "emip_flow_attention_bwd_bf16": [_P] * 9 + [_L] + [_I] * 3 + [_P],
    "emip_convex_upsample_bwd_bf16": [_P] * 6 + [_I] * 4 + [_P],
    # the bf16 long model and 512^2: F forward and backward, G and H
    # forward
    "emip_memory_attention_bf16": [_P] * 7 + [_L] + [_I] * 4 + [_P],
    "emip_memory_attention_bf16_workspace": [_I] * 4,
    "emip_memory_attention_bwd_bf16": [_P] * 11 + [_L] + [_I] * 4 + [_P],
    "emip_window_layer_bf16": ([_P] * 9 + [_I, _I] + [_P] * 4 + [_I] * 4
                               + [_F, _P]),
    "emip_window_ffn_layer_bf16": ([_P] * 13 + [_I] + [_P] * 7 + [_L]
                                   + [_I] * 4 + [_F, _P]),
    # the rest of the bf16 band: G and H backward (the train step at
    # 512^2), J forward and backward
    "emip_window_layer_bwd_bf16": ([_P] * 8 + [_I] + [_P] * 10 + [_L]
                                   + [_I] * 4 + [_F, _P]),
    "emip_window_ffn_layer_bwd_bf16": ([_P] * 13 + [_I] + [_P] * 14 + [_L]
                                       + [_I] * 4 + [_F, _P]),
    "emip_dwconv_gelu_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "emip_dwconv_gelu_bwd_bf16": [_P] * 8 + [_L] + [_I] * 4 + [_P],
}
_RESTYPES = {"emip_attention_fwd_workspace": _L,
             "emip_memory_attention_bf16_workspace": _L,
             "emip_dwconv_gelu_bwd_workspace": _L,
             "emip_splat_density_workspace": _L,
             "emip_softmax_expectation_bwd_workspace": _L}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None


def find_nvcc() -> str | None:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent loader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                   os.path.join(tmp, src.stem + ".o")]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append("nvcc failed (exit %d): %s\n%s" % (
                    proc.returncode, " ".join(cmd), log[-4000:]))
        if failed:
            raise KernelBuildError("\n".join(failed))
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *(os.path.join(tmp, p.stem + ".o")
                 for p in sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                "nvcc link failed (exit %d): %s\n%s" % (
                    proc.returncode, " ".join(cmd),
                    proc.stderr[-4000:] or proc.stdout[-4000:]))
        os.replace(lib, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use.

    Raises :class:`KernelBuildError` when ``nvcc`` is missing or fails.
    There is no fallback: a CUDA tensor reaches a kernel or an error.
    """
    global _lib, _build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out = BUILD_ROOT / _digest() / "libemip_kernels.so"
        if not out.exists():
            nvcc = find_nvcc()
            if nvcc is None:
                raise KernelBuildError(
                    "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                    "/usr/local/cuda/bin): the CUDA kernels of "
                    "emip_tpu_torch cannot be built, and CUDA tensors have "
                    "no other path")
            _compile(nvcc, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, _I)
        _build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def build_seconds() -> float | None:
    """Seconds the first :func:`library` call took (build + load)."""
    return _build_seconds
