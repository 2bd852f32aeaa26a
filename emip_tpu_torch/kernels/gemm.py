"""The 3xTF32 GEMM core of kernels A, B, G and H, called alone.

On the model's paths the GEMM runs inside the entry points of
``csrc/sr_attention.cu`` and ``csrc/window_attention.cu``; :func:`gemm`
exposes the same device code (``csrc/gemm_tf32.cuh`` through
``csrc/gemm.cu``) so that ``chip_smoke.py`` and the ``cuda`` tests can hold
it against ``torch.matmul`` and time it at the shapes those kernels give
it. CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["gemm", "gemm_reference"]

_NAME = "gemm"


def gemm_reference(a, b, bias=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm`."""
    out = a @ b
    return out if bias is None else out + bias


def _unit_stride(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or 1 not in t.stride():
        raise ValueError(f"{_NAME}: {name} must be 2-D with one unit stride "
                         f"(row-major or a transposed view), got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
         split_k: bool = False) -> torch.Tensor:
    """``a @ b (+ bias)`` -> [M, N] fp32.

    a: [M, K], b: [K, N], each row-major or a transposed view (the kernel
    reads both orientations in place); bias [N] or None. ``split_k`` splits
    K across blocks as a weight gradient's product does (no bias then). Not
    differentiable: a check of the kernels' GEMM, not a layer.
    """
    tensors = [a, b] + ([] if bias is None else [bias])
    if cm.on_cpu(_NAME, *tensors):
        return gemm_reference(a, b, bias)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{_NAME}: {name} must be float32")
        _unit_stride(name, t)
    if bias is not None:
        cm.check_kernel_args(_NAME, bias=bias)
        if split_k:
            raise ValueError(f"{_NAME}: split_k takes no bias")
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"{_NAME}: inner dimensions {k} and {b.shape[0]}")
    if bias is not None:
        cm.check_shape(_NAME, "bias", bias, (n,))
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    ws = cm.workspace(a.device, 0)
    rc = library().emip_gemm(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), cm.ptr(bias), out.data_ptr(), n, m, n, k, int(split_k),
        ws.data_ptr(), ws.numel(), cm.stream_handle(a.device))
    cm.raise_on_error(_NAME, rc)
    cm.LAUNCHES["gemm"] += 1
    return out
