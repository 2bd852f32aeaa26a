"""The GEMM cores of kernels A, B, G and H, called alone.

On the model's paths the GEMM runs inside the entry points of
``csrc/sr_attention.cu`` and ``csrc/window_attention.cu``; :func:`gemm`
exposes the same device code so that ``chip_smoke.py`` and the ``cuda``
tests can hold it against ``torch.matmul`` and time it at the shapes those
kernels give it: fp32 operands take the 3xTF32 GEMM
(``csrc/gemm_tf32.cuh``), bf16 ones the bf16 GEMM of the bf16 band
(``csrc/gemm_bf16.cuh``, A's projections and B's self layer), both through
``csrc/gemm.cu``. CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["gemm", "gemm_reference"]

_NAME = "gemm"


def gemm_reference(a, b, bias=None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm`. bf16 operands: their exact
    products summed in fp32, the fp32 bias added, then one rounding to
    ``out_dtype`` (bf16 unless given)."""
    if a.dtype == torch.bfloat16:
        out = a.float() @ b.float()
        if bias is not None:
            out = out + bias.float()
        return out.to(out_dtype or torch.bfloat16)
    out = a @ b
    return out if bias is None else out + bias


def _unit_stride(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or 1 not in t.stride():
        raise ValueError(f"{_NAME}: {name} must be 2-D with one unit stride "
                         f"(row-major or a transposed view), got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _gemm_bf16(a, b, bias, split_k, out_dtype) -> torch.Tensor:
    """The bf16 GEMM: ``b`` a transposed view of a row-major weight."""
    name = _NAME + " (bf16)"
    out_dtype = out_dtype or torch.bfloat16
    if out_dtype not in (torch.bfloat16, torch.float32) or split_k:
        raise ValueError(f"{name}: writes bf16 or fp32, without split_k")
    if b.dtype != torch.bfloat16:
        raise TypeError(f"{name}: b must be bfloat16 as a is")
    if a.dim() != 2 or a.stride(1) != 1 or b.dim() != 2 or b.stride(0) != 1:
        raise ValueError(f"{name}: a must be row-major [M, K] and b [K, N] "
                         f"a transposed view of a row-major [N, K] weight")
    if bias is not None:
        cm.check_kernel_args(name, bias=bias)
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"{name}: inner dimensions {k} and {b.shape[0]}")
    if bias is not None:
        cm.check_shape(name, "bias", bias, (n,))
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    rc = library().emip_gemm_bf16(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(1), cm.ptr(bias),
        out.data_ptr(), n, m, n, k, int(out_dtype == torch.bfloat16),
        cm.stream_handle(a.device))
    cm.raise_on_error(name, rc)
    cm.LAUNCHES["gemm_bf16"] += 1
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
         split_k: bool = False,
         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a @ b (+ bias)`` -> [M, N].

    fp32 a: [M, K], b: [K, N], each row-major or a transposed view (the
    kernel reads both orientations in place); bias [N] or None; the result
    fp32. ``split_k`` splits K across blocks as a weight gradient's product
    does (no bias then). bf16 a (row-major) and b (a transposed view of a
    row-major [N, K] weight, as ``w.t()``), fp32 bias: the bf16 GEMM, fp32
    sums rounded once to ``out_dtype`` (bf16 unless given; fp32 too). Not
    differentiable: a check of the kernels' GEMMs, not a layer.
    """
    tensors = [a, b] + ([] if bias is None else [bias])
    if cm.on_cpu(_NAME, *tensors):
        return gemm_reference(a, b, bias, out_dtype)
    if a.dtype == torch.bfloat16:
        return _gemm_bf16(a, b, bias, split_k, out_dtype)
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
