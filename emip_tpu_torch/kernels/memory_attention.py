"""Kernel F: the long-term memory read
softmax(q k^T / sqrt(C) + bias, over the keys) v, forward and backward.

Port of :func:`emip_tpu.ops.pallas.memory_attention.masked_memory_attention`;
the CUDA source is ``csrc/memory_attention.cu``.
:func:`masked_memory_attention` is one ``torch.autograd.Function``: CPU
tensors take the plain version (and its autograd backward), CUDA tensors
the forward and backward kernels. The bias is a constant mask and gets no
gradient.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["masked_memory_attention", "masked_memory_attention_reference"]

_NAME = "masked_memory_attention"
_WIDTHS = (128,)  # the memory's key / value width = GMFlow's feature width


def masked_memory_attention_reference(q, k, v, bias) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_memory_attention`."""
    c = q.shape[-1]
    scores = q @ k.transpose(-1, -2) / c**0.5 + bias[:, None, :]
    return torch.softmax(scores, dim=-1) @ v


def _check(q, k, v, bias) -> None:
    cm.check_kernel_args(_NAME, q=q, k=k, v=v, bias=bias)
    if q.dim() != 3:
        raise ValueError(f"{_NAME}: q must be [B, M, C]")
    b, m, c = q.shape
    if c not in _WIDTHS:
        raise ValueError(f"{_NAME}: channel width {c} not in {_WIDTHS}")
    if k.dim() != 3 or m == 0 or k.shape[1] == 0:
        raise ValueError(f"{_NAME}: k must be [B, N, C] with M, N > 0")
    n = k.shape[1]
    cm.check_shape(_NAME, "k", k, (b, n, c))
    cm.check_shape(_NAME, "v", v, (b, n, c))
    cm.check_shape(_NAME, "bias", bias, (b, n))


class _MemoryAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, keep):
        ctx.cpu = cm.on_cpu(_NAME, q, k, v, bias)
        if ctx.cpu:
            if keep:
                ctx.save_for_backward(q, k, v, bias)
            return masked_memory_attention_reference(q, k, v, bias)
        _check(q, k, v, bias)
        b, m, c = q.shape
        n = k.shape[1]
        out = torch.empty_like(q)
        # row max and row sum of the scores, read by the backward
        stats = (torch.empty((2, b, m), device=q.device, dtype=q.dtype)
                 if keep else None)
        ws = cm.workspace(q.device, 0)
        rc = library().emip_memory_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), cm.ptr(stats), ws.data_ptr(), ws.numel(), b, m,
            n, c, cm.stream_handle(q.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["memory_attention"] += 1
        if keep:
            ctx.save_for_backward(q, k, v, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        if ctx.cpu:
            q, k, v, bias = ctx.saved_tensors
            return (*cm.plain_vjp(masked_memory_attention_reference,
                                  (q, k, v), needs, g, bias), None, None)
        q, k, v, bias, out, stats = ctx.saved_tensors
        g = g.contiguous()
        b, m, c = q.shape
        n = k.shape[1]
        dq, dk, dv = (cm.empty_if(nd, t) for nd, t in zip(needs, (q, k, v)))
        # delta, and room for the key-tiled pass to split its queries three
        # ways (partial dk and dv) where that evens out its last wave
        ws = cm.workspace(q.device, b * m + (6 * b * n * c
                                             if needs[1] or needs[2] else 0))
        rc = library().emip_memory_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats.data_ptr(), g.data_ptr(), cm.ptr(dq),
            cm.ptr(dk), cm.ptr(dv), ws.data_ptr(), ws.numel(), b, m, n, c,
            cm.stream_handle(q.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["memory_attention_bwd"] += 1
        return dq, dk, dv, None, None


def masked_memory_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """q: [B, M, C]; k, v: [B, N, C]; bias: [B, N] additive (-1e9 masks an
    empty memory slot). Returns [B, M, C] (fp32).

    Differentiable in q, k and v; the backward computes only the grads that
    are asked for.
    """
    return _MemoryAttention.apply(q, k, v, bias, cm.grad_wanted(q, k, v))
