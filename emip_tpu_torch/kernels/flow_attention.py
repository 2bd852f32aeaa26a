"""Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v, forward and
backward.

Port of :func:`emip_tpu.ops.pallas.corr_softmax.fused_flow_attention`; the
CUDA source is ``csrc/flow_attention.cu``. :func:`fused_flow_attention` is
one ``torch.autograd.Function``: CPU tensors take the plain version (and
its autograd backward), CUDA tensors the forward and backward kernels.
When a gradient is wanted the forward kernel also writes each row's max
and sum of the scores, which the backward kernel reads. Channel widths 128
(pvt_v2_b5's GMFlow features) and 64 (b0's) are instantiated.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_flow_attention", "fused_flow_attention_reference"]

_NAME = "fused_flow_attention"
# GMFlow feature width = the backbone's /8 width: 128 in pvt_v2_b5, 64 in b0
_WIDTHS = (64, 128)
_VALUE_WIDTH = 2


def fused_flow_attention_reference(q, k, v) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_flow_attention`."""
    c = q.shape[-1]
    scores = q @ k.transpose(-1, -2) / c**0.5
    return torch.softmax(scores, dim=-1) @ v


def _check(q, k, v) -> None:
    cm.check_kernel_args(_NAME, q=q, k=k, v=v)
    if q.dim() != 3:
        raise ValueError(f"{_NAME}: q must be [B, L, C]")
    b, l, c = q.shape
    if c not in _WIDTHS:
        raise ValueError(f"{_NAME}: channel width {c} not in {_WIDTHS}")
    if l == 0:
        raise ValueError(f"{_NAME}: empty token axis")
    cm.check_shape(_NAME, "k", k, (b, l, c))
    cm.check_shape(_NAME, "v", v, (b, l, _VALUE_WIDTH))


class _FlowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, keep):
        ctx.cpu = cm.on_cpu(_NAME, q, k, v)
        if ctx.cpu:
            if keep:
                ctx.save_for_backward(q, k, v)
            return fused_flow_attention_reference(q, k, v)
        _check(q, k, v)
        b, l, c = q.shape
        out = torch.empty((b, l, _VALUE_WIDTH), device=q.device,
                          dtype=q.dtype)
        # row max and row sum of the scores, read by the backward
        stats = (torch.empty((2, b, l), device=q.device, dtype=q.dtype)
                 if keep else None)
        # room for the partials where the keys are split across blocks
        ws = cm.workspace(q.device, 0)
        rc = library().emip_flow_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            cm.ptr(stats), ws.data_ptr(), ws.numel(), b, l, c, _VALUE_WIDTH,
            cm.stream_handle(q.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["flow_attention"] += 1
        if keep:
            ctx.save_for_backward(q, k, v, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        if ctx.cpu:
            return (*cm.plain_vjp(fused_flow_attention_reference,
                                  ctx.saved_tensors, needs, g), None)
        q, k, v, out, stats = ctx.saved_tensors
        g = g.contiguous()
        b, l, c = q.shape
        dq, dk, dv = (cm.empty_if(nd, t) for nd, t in zip(needs, (q, k, v)))
        # delta, and room for a pass to split its streamed side two ways
        # (partial dq, or partial dk and dv) where it has too few blocks
        if needs[1] or needs[2]:
            partials = 2 * b * l * (c + _VALUE_WIDTH)
        else:
            partials = 2 * b * l * c
        ws = cm.workspace(q.device, b * l + partials)
        rc = library().emip_flow_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            stats.data_ptr(), g.data_ptr(), cm.ptr(dq), cm.ptr(dk),
            cm.ptr(dv), ws.data_ptr(), ws.numel(), b, l, c, _VALUE_WIDTH,
            cm.stream_handle(q.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["flow_attention_bwd"] += 1
        return dq, dk, dv, None


def fused_flow_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q, k: [B, L, C]; v: [B, L, 2]. Returns [B, L, 2] (fp32).

    Differentiable in q, k and v; the backward computes only the grads that
    are asked for.
    """
    return _FlowAttention.apply(q, k, v, cm.grad_wanted(q, k, v))
