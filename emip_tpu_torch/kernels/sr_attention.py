"""Kernel A: fused PVTv2 spatial-reduction attention, forward and backward.

Port of :func:`emip_tpu.ops.pallas.sr_attention.fused_sr_attention`; the
CUDA source is ``csrc/sr_attention.cu``. Weights are in torch
``nn.Linear`` layout ([out, in]). :func:`fused_sr_attention` is one
``torch.autograd.Function``: CPU tensors take the plain version (and its
autograd backward), CUDA tensors the forward and backward kernels (every
product on the tensor cores). When a gradient is wanted the forward kernel
also writes each attention row's max and sum, which the backward kernel
reads.

In the bf16 band (bf16 ``x``, ``kv_in`` and weights, fp32 biases) the
forward is ``emip_sr_attention_bf16``, rounding where the JAX kernel rounds
with a bf16 storage dtype, in two launches: the kv projection (the bf16
GEMM of ``csrc/gemm_bf16.cuh``), then one fused kernel in which a cluster
of ``num_heads`` blocks per (image, 64-row query tile) projects each head's
q, runs its attention (the key loop of ``csrc/attention_bf16.cuh``) and,
with the heads' o exchanged through distributed shared memory, the output
projection; q and o never reach device memory. Every sum runs in the
order of the bf16 GEMM and the bf16 attention kernel
(``tf32.sr_attention_fwd_bf16_walk`` states it). Its backward (``emip_sr_attention_bwd_bf16``) is the
JAX kernel's: the forward recomputed in fp32 from the bf16 inputs and
weights (the bf16 forward's rounded q, [k | v] and o are not the JAX
backward's, so the bf16 forward keeps only its inputs), the fp32 backward
above, and gx, g_kv_in and the three weight grads rounded to bf16 once; the
bias grads fp32. Its GEMMs read the bf16 operands as they are and leave
out the TF32 terms that are zero, which gives the bits of the fp32
backward on the upcast inputs (``tf32.sr_attention_bwd_bf16_walk``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library
from emip_tpu_torch.kernels.attention import (
    _workspace_floats,
    forward_workspace,
)

__all__ = ["fused_sr_attention", "fused_sr_attention_reference"]

_NAME = "fused_sr_attention"
# head width at every PVT stage: 64 in pvt_v2_b5 (and b1-b4), 32 in b0
_HEAD_DIMS = (32, 64)


def fused_sr_attention_reference(x, kv_in, wq, bq, wkv, bkv, wp, bp,
                                 num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_sr_attention` (with bf16 ``x``
    that of its bf16 forward)."""
    if x.dtype == torch.bfloat16:
        return _reference_bf16(x, kv_in, wq, bq, wkv, bkv, wp, bp, num_heads)
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


def _reference_bf16(x, kv_in, wq, bq, wkv, bkv, wp, bp, num_heads):
    """The JAX kernel's rounding points with a bf16 storage dtype: bf16
    operands (the weights cast), fp32 sums and biases; q, k, v rounded
    after their projections, the normalised P before P v, o before the
    output projection, the output at the end."""
    dt = torch.bfloat16
    b, n, c = x.shape
    m = kv_in.shape[1]
    ch = c // num_heads

    def proj(t, w, bias):
        return F.linear(t.float(), w.to(dt).float(), bias.float()).to(dt)

    q = proj(x, wq, bq).float().reshape(b, n, num_heads, ch).transpose(1, 2)
    kv = proj(kv_in, wkv, bkv).float().reshape(b, m, 2, num_heads, ch)
    k = kv[:, :, 0].transpose(1, 2)
    v = kv[:, :, 1].transpose(1, 2)
    attn = torch.softmax(q @ k.transpose(-1, -2) * ch**-0.5, dim=-1)
    o = (attn.to(dt).float() @ v).transpose(1, 2).reshape(b, n, c).to(dt)
    return proj(o, wp, bp)


def _check(args: dict, num_heads: int, dtype=torch.float32) -> None:
    if dtype == torch.float32:
        cm.check_kernel_args(_NAME, **args)
    else:
        cm.check_kernel_args(_NAME, dtype, **{
            k: args[k] for k in ("x", "kv_in", "wq", "wkv", "wp")})
        cm.check_kernel_args(_NAME, **{k: args[k] for k in ("bq", "bkv",
                                                              "bp")})
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
        # each attention row's max and sum, read by the backward
        stats = (torch.empty((2, b, num_heads, n), device=x.device,
                             dtype=x.dtype) if keep else None)
        out = torch.empty_like(x)
        ws = forward_workspace(x.device, b, num_heads, n, m, c // num_heads,
                               False)
        rc = library().emip_sr_attention(
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wkv.data_ptr(), bkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            q_buf.data_ptr(), kv_buf.data_ptr(), o_buf.data_ptr(),
            cm.ptr(stats), out.data_ptr(), cm.ptr(ws), cm.numel(ws), b, n, m,
            c, num_heads, cm.stream_handle(x.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["sr_attention"] += 1
        if keep:  # what the backward kernel reads
            ctx.save_for_backward(x, kv_in, wq, wkv, wp, q_buf, kv_buf, o_buf,
                                  stats)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:8]
        if ctx.cpu:
            grads = cm.plain_vjp(fused_sr_attention_reference,
                                 ctx.saved_tensors, needs, g, ctx.num_heads)
            return (*grads, None, None)
        x, kv_in, wq, wkv, wp, q_buf, kv_buf, o_buf, stats = ctx.saved_tensors
        g = g.contiguous()
        b, n, c = x.shape
        m = kv_in.shape[1]
        shapes = (x.shape, kv_in.shape, (c, c), (c,), (2 * c, c), (2 * c,),
                  (c, c), (c,))
        grads = [torch.empty(s, device=x.device, dtype=x.dtype) if nd
                 else None for nd, s in zip(needs, shapes)]
        go, gq = torch.empty_like(x), torch.empty_like(x)
        gkv = torch.empty_like(kv_buf)
        # delta, and room for the attention's key-tiled pass to split the
        # queries 16 ways (partial dk and dv) where it has few blocks
        ws = cm.workspace(x.device,
                          b * ctx.num_heads * n + 16 * b * m * 2 * c)
        rc = library().emip_sr_attention_bwd(
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), wkv.data_ptr(),
            wp.data_ptr(), q_buf.data_ptr(), kv_buf.data_ptr(),
            o_buf.data_ptr(), stats.data_ptr(), g.data_ptr(),
            *(cm.ptr(t) for t in grads),
            go.data_ptr(), gq.data_ptr(), gkv.data_ptr(), ws.data_ptr(),
            ws.numel(), b, n, m, c, ctx.num_heads,
            cm.stream_handle(x.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["sr_attention_bwd"] += 1
        return (*grads, None, None)


class _SRAttentionBf16(torch.autograd.Function):
    """The bf16 band: bf16 x, kv_in and weights, fp32 biases."""

    @staticmethod
    def forward(ctx, x, kv_in, wq, bq, wkv, bkv, wp, bp, num_heads, keep):
        ctx.num_heads = num_heads
        inputs = (x, kv_in, wq, bq, wkv, bkv, wp, bp)
        ctx.cpu = cm.on_cpu(_NAME, *inputs)
        if keep:  # the backward recomputes the rest from them
            ctx.save_for_backward(*inputs)
        if ctx.cpu:
            return _reference_bf16(*inputs, num_heads)
        _check(dict(x=x, kv_in=kv_in, wq=wq, bq=bq, wkv=wkv, bkv=bkv, wp=wp,
                    bp=bp), num_heads, torch.bfloat16)
        b, n, c = x.shape
        m = kv_in.shape[1]
        kv_buf = torch.empty((b, m, 2 * c), device=x.device, dtype=x.dtype)
        out = torch.empty_like(x)
        rc = library().emip_sr_attention_bf16(
            *(t.data_ptr() for t in inputs), kv_buf.data_ptr(),
            out.data_ptr(), b, n, m, c, num_heads,
            cm.stream_handle(x.device))
        cm.raise_on_error(_NAME + " (bf16)", rc)
        cm.LAUNCHES["sr_attention_bf16"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:8]
        inputs = ctx.saved_tensors
        if ctx.cpu:
            grads = cm.plain_vjp_fp32(fused_sr_attention_reference, inputs,
                                      needs, g, ctx.num_heads)
            return (*grads, None, None)
        x, kv_in = inputs[0], inputs[1]
        g = g.contiguous()
        b, n, c = x.shape
        m = kv_in.shape[1]
        heads = ctx.num_heads
        grads = [torch.empty_like(t) if nd else None
                 for nd, t in zip(needs, inputs)]
        # fp32 scratch (see emip_sr_attention_bwd_bf16): the recomputed q,
        # [k | v], o and row statistics, go, gq and gkv; then the larger of
        # the forward's key-split partials and the backward's delta and
        # query-split partials (the split-K and column sums' partials fit)
        nq, nk = b * n * c, b * m * c
        scratch = 4 * nq + 4 * nk + 2 * b * heads * n
        rest = max(_workspace_floats(b, heads, n, m, c // heads, False),
                   b * heads * n + 32 * nk)
        ws = cm.workspace(x.device, scratch + rest)
        rc = library().emip_sr_attention_bwd_bf16(
            *(t.data_ptr() for t in inputs), g.data_ptr(),
            *(cm.ptr(t) for t in grads), ws.data_ptr(), ws.numel(), b, n, m,
            c, heads, cm.stream_handle(x.device))
        cm.raise_on_error(_NAME + " backward (bf16)", rc)
        cm.LAUNCHES["sr_attention_bwd_bf16"] += 1
        return (*grads, None, None)


def fused_sr_attention(x: torch.Tensor, kv_in: torch.Tensor,
                       wq: torch.Tensor, bq: torch.Tensor,
                       wkv: torch.Tensor, bkv: torch.Tensor,
                       wp: torch.Tensor, bp: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """proj(multi-head-attn(q(x), kv(kv_in))) -> [B, N, C].

    x: [B, N, C] normalized tokens; kv_in: [B, M, C] reduced tokens;
    wq, wp: [C, C]; wkv: [2C, C]; biases [C] / [2C]. Differentiable in
    every tensor argument. With bf16 ``x`` (the bf16 band: bf16 kv_in and
    weights, fp32 biases) the bf16 kernels: [B, N, C] bf16, the grads in
    their inputs' dtypes.
    """
    inputs = (x, kv_in, wq, bq, wkv, bkv, wp, bp)
    fn = _SRAttentionBf16 if x.dtype == torch.bfloat16 else _SRAttention
    return fn.apply(*inputs, num_heads, cm.grad_wanted(*inputs))
