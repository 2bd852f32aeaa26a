"""Kernel A: fused PVTv2 spatial-reduction attention, forward and backward.

Port of :func:`emip_tpu.ops.pallas.sr_attention.fused_sr_attention`; the
CUDA source is ``csrc/sr_attention.cu``. Weights are in torch
``nn.Linear`` layout ([out, in]). :func:`fused_sr_attention` is one
``torch.autograd.Function``: CPU tensors take the plain version (and its
autograd backward), CUDA tensors the forward and backward kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_sr_attention", "fused_sr_attention_reference"]

_NAME = "fused_sr_attention"
# head width at every PVT stage: 64 in pvt_v2_b5 (and b1-b4), 32 in b0
_HEAD_DIMS = (32, 64)


def fused_sr_attention_reference(x, kv_in, wq, bq, wkv, bkv, wp, bp,
                                 num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_sr_attention`."""
    b, n, c = x.shape
    m = kv_in.shape[1]
    ch = c // num_heads
    q = F.linear(x, wq, bq).reshape(b, n, num_heads, ch).transpose(1, 2)
    kv = F.linear(kv_in, wkv, bkv).reshape(b, m, 2, num_heads, ch)
    k = kv[:, :, 0].transpose(1, 2)
    v = kv[:, :, 1].transpose(1, 2)
    attn = torch.softmax(q @ k.transpose(-1, -2) * ch**-0.5, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(b, n, c)
    return F.linear(o, wp, bp)


def _check(args: dict, num_heads: int) -> None:
    cm.check_kernel_args(_NAME, **args)
    x, kv_in = args["x"], args["kv_in"]
    if x.dim() != 3 or kv_in.dim() != 3:
        raise ValueError(f"{_NAME}: x and kv_in must be [B, N, C] / [B, M, C]")
    b, n, c = x.shape
    m = kv_in.shape[1]
    if c % num_heads or c // num_heads not in _HEAD_DIMS:
        raise ValueError(f"{_NAME}: head width {c}/{num_heads} not in "
                         f"{_HEAD_DIMS}")
    if n == 0 or m == 0:
        raise ValueError(f"{_NAME}: empty token axis (N={n}, M={m})")
    cm.check_shape(_NAME, "kv_in", kv_in, (b, m, c))
    for key, shape in (("wq", (c, c)), ("bq", (c,)), ("wkv", (2 * c, c)),
                       ("bkv", (2 * c,)), ("wp", (c, c)), ("bp", (c,))):
        cm.check_shape(_NAME, key, args[key], shape)


class _SRAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kv_in, wq, bq, wkv, bkv, wp, bp, num_heads, keep):
        ctx.num_heads = num_heads
        inputs = (x, kv_in, wq, bq, wkv, bkv, wp, bp)
        ctx.cpu = cm.on_cpu(_NAME, *inputs)
        if ctx.cpu:
            if keep:
                ctx.save_for_backward(*inputs)
            return fused_sr_attention_reference(*inputs, num_heads)
        _check(dict(x=x, kv_in=kv_in, wq=wq, bq=bq, wkv=wkv, bkv=bkv, wp=wp,
                    bp=bp), num_heads)
        b, n, c = x.shape
        m = kv_in.shape[1]
        q_buf = torch.empty_like(x)
        kv_buf = torch.empty((b, m, 2 * c), device=x.device, dtype=x.dtype)
        o_buf = torch.empty_like(x)
        out = torch.empty_like(x)
        rc = library().emip_sr_attention(
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wkv.data_ptr(), bkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            q_buf.data_ptr(), kv_buf.data_ptr(), o_buf.data_ptr(),
            out.data_ptr(), b, n, m, c, num_heads,
            cm.stream_handle(x.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["sr_attention"] += 1
        if keep:  # what the backward kernel reads
            ctx.save_for_backward(x, kv_in, wq, wkv, wp, q_buf, kv_buf, o_buf)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:8]
        if ctx.cpu:
            grads = cm.plain_vjp(fused_sr_attention_reference,
                                 ctx.saved_tensors, needs, g, ctx.num_heads)
            return (*grads, None, None)
        x, kv_in, wq, wkv, wp, q_buf, kv_buf, o_buf = ctx.saved_tensors
        g = g.contiguous()
        b, n, c = x.shape
        m = kv_in.shape[1]
        shapes = (x.shape, kv_in.shape, (c, c), (c,), (2 * c, c), (2 * c,),
                  (c, c), (c,))
        grads = [torch.empty(s, device=x.device, dtype=x.dtype) if nd
                 else None for nd, s in zip(needs, shapes)]
        go, gq = torch.empty_like(x), torch.empty_like(x)
        gkv = torch.empty_like(kv_buf)
        ws = cm.workspace(x.device, 2 * b * ctx.num_heads * n)
        rc = library().emip_sr_attention_bwd(
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), wkv.data_ptr(),
            wp.data_ptr(), q_buf.data_ptr(), kv_buf.data_ptr(),
            o_buf.data_ptr(), g.data_ptr(), *(cm.ptr(t) for t in grads),
            go.data_ptr(), gq.data_ptr(), gkv.data_ptr(), ws.data_ptr(),
            ws.numel(), b, n, m, c, ctx.num_heads,
            cm.stream_handle(x.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["sr_attention_bwd"] += 1
        return (*grads, None, None)


def fused_sr_attention(x: torch.Tensor, kv_in: torch.Tensor,
                       wq: torch.Tensor, bq: torch.Tensor,
                       wkv: torch.Tensor, bkv: torch.Tensor,
                       wp: torch.Tensor, bp: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """proj(multi-head-attn(q(x), kv(kv_in))) -> [B, N, C].

    x: [B, N, C] normalized tokens; kv_in: [B, M, C] reduced tokens;
    wq, wp: [C, C]; wkv: [2C, C]; biases [C] / [2C]. Differentiable in
    every tensor argument.
    """
    inputs = (x, kv_in, wq, bq, wkv, bkv, wp, bp)
    return _SRAttention.apply(*inputs, num_heads, cm.grad_wanted(*inputs))
