"""Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v, forward and
backward.

Port of :func:`emip_tpu.ops.pallas.corr_softmax.fused_flow_attention`; the
CUDA source is ``csrc/flow_attention.cu``. :func:`fused_flow_attention` is
one ``torch.autograd.Function``: CPU tensors take the plain version (and
its autograd backward), CUDA tensors the forward and backward kernels.
When a gradient is wanted the forward kernel also writes each row's max
and sum of the scores, which the backward kernel reads. Channel widths 128
(pvt_v2_b5's GMFlow features) and 64 (b0's) are instantiated.

In the bf16 band q and k are bf16 and v fp32, as the JAX kernel takes
them in a bf16 model: ``emip_flow_attention_bf16`` (the bf16 attention of
``csrc/attention_bf16.cu``, on ``wgmma`` fed by TMA: q k^T from bf16
operands into fp32, P and the 2-wide P v in fp32;
:func:`~emip_tpu_torch.kernels.tf32.attention_bf16_walk`) writes fp32,
at any L (v's 2-wide tile goes into each key tile's stage). Its backward
(``emip_flow_attention_bwd_bf16``) is the JAX kernel's: the scores and P
recomputed in fp32 from q and k as they are (with the row statistics: the
bf16 forward keeps only its inputs and output), dq and dk rounded to bf16
where they are finished, dv fp32. It reads q and k in bf16 and computes
the fp32 backward's bits on them: a product with a bf16 operand leaves out
the TF32 terms that are zero (``tf32.flow_attention_bwd_bf16_walk``).
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
    """Plain PyTorch version of :func:`fused_flow_attention` (bf16 q and
    k: their exact products summed in fp32, everything after in fp32)."""
    if q.dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
    c = q.shape[-1]
    scores = q @ k.transpose(-1, -2) / c**0.5
    return torch.softmax(scores, dim=-1) @ v


def _check(q, k, v, dtype=torch.float32) -> None:
    cm.check_kernel_args(_NAME, dtype, q=q, k=k)
    cm.check_kernel_args(_NAME, v=v)
    if q.dim() != 3:
        raise ValueError(f"{_NAME}: q must be [B, L, C]")
    b, l, c = q.shape
    if c not in _WIDTHS:
        raise ValueError(f"{_NAME}: channel width {c} not in {_WIDTHS}")
    if l == 0:
        raise ValueError(f"{_NAME}: empty token axis")
    cm.check_shape(_NAME, "k", k, (b, l, c))
    cm.check_shape(_NAME, "v", v, (b, l, _VALUE_WIDTH))


def _partials(b: int, l: int, c: int, needs) -> int:
    """Workspace floats for the backward's passes to split their streamed
    side two ways (partial dq, or partial dk and dv) where they have too
    few blocks."""
    if needs[1] or needs[2]:
        return 2 * b * l * (c + _VALUE_WIDTH)
    return 2 * b * l * c


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
        ws = cm.workspace(q.device, b * l + _partials(b, l, c, needs))
        rc = library().emip_flow_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            stats.data_ptr(), g.data_ptr(), cm.ptr(dq), cm.ptr(dk),
            cm.ptr(dv), ws.data_ptr(), ws.numel(), b, l, c, _VALUE_WIDTH,
            cm.stream_handle(q.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["flow_attention_bwd"] += 1
        return dq, dk, dv, None


class _FlowAttentionBf16(torch.autograd.Function):
    """The bf16 band: bf16 q and k, fp32 v and output."""

    @staticmethod
    def forward(ctx, q, k, v, keep):
        ctx.cpu = cm.on_cpu(_NAME, q, k, v)
        if ctx.cpu:
            out = fused_flow_attention_reference(q, k, v)
        else:
            _check(q, k, v, torch.bfloat16)
            b, l, c = q.shape
            out = torch.empty((b, l, _VALUE_WIDTH), device=q.device,
                              dtype=torch.float32)
            rc = library().emip_flow_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                l, c, cm.stream_handle(q.device))
            cm.raise_on_error(_NAME + " (bf16)", rc)
            cm.LAUNCHES["flow_attention_bf16"] += 1
        if keep:  # the backward reads the inputs and the output (delta)
            ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        q, k, v, out = ctx.saved_tensors
        if ctx.cpu:
            return (*cm.plain_vjp_fp32(fused_flow_attention_reference,
                                       (q, k, v), needs, g), None)
        g = g.contiguous()
        b, l, c = q.shape
        dq, dk, dv = (cm.empty_if(nd, t) for nd, t in zip(needs, (q, k, v)))
        # the row statistics, delta and the partials of the split passes
        # (two ways, as the fp32 backward's: the same splits, the same sums)
        ws = cm.workspace(q.device, 3 * b * l + _partials(b, l, c, needs))
        rc = library().emip_flow_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), cm.ptr(dq), cm.ptr(dk), cm.ptr(dv), ws.data_ptr(),
            ws.numel(), b, l, c, cm.stream_handle(q.device))
        cm.raise_on_error(_NAME + " backward (bf16)", rc)
        cm.LAUNCHES["flow_attention_bwd_bf16"] += 1
        return dq, dk, dv, None


def fused_flow_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q, k: [B, L, C]; v: [B, L, 2]. Returns [B, L, 2] (fp32).

    Differentiable in q, k and v; the backward computes only the grads that
    are asked for. bf16 q and k (fp32 v) take the bf16 kernels (dq and dk
    bf16).
    """
    fn = _FlowAttentionBf16 if q.dtype == torch.bfloat16 else _FlowAttention
    return fn.apply(q, k, v, cm.grad_wanted(q, k, v))
