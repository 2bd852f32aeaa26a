"""Kernel F: the long-term memory read
softmax(q k^T / sqrt(C) + bias, over the keys) v, forward and backward.

Port of :func:`emip_tpu.ops.pallas.memory_attention.masked_memory_attention`;
the CUDA source is ``csrc/memory_attention.cu``.
:func:`masked_memory_attention` is one ``torch.autograd.Function``: CPU
tensors take the plain version and its plain backward
(:func:`masked_memory_attention_bwd_reference`), CUDA tensors the forward
and backward kernels. The bias is a constant mask and gets no
gradient. Widths 128 (pvt_v2_b5's configuration) and 64 (b0's) are
instantiated: ``EMIPLong`` builds its memory at GMFlow's feature width.

In the bf16 band (the long model in bf16) q is bf16 and k, v and the bias
fp32 (the ring stays fp32), as the JAX kernel takes them in a bf16 model:
``emip_memory_attention_bf16`` accumulates q k^T in fp32, rounds P =
exp(S - m) to bf16 for P v against the fp32 v and divides by the fp32 sum
of the unrounded P, writing fp32; it runs both products on bf16 tensor
cores against the ring split exactly into three bf16 parts
(:func:`~emip_tpu_torch.kernels.tf32.memory_attention_fwd_bf16_walk`
states its order). Its backward
(``emip_memory_attention_bwd_bf16``) is the JAX kernel's: P recomputed in
fp32, delta from the bf16 forward's output, dq rounded to bf16, dk and dv
fp32; it reads q as bf16 where it lies, its products with q take the TF32
terms that q's exactness leaves (``kernels/tf32.py``,
:func:`~emip_tpu_torch.kernels.tf32.memory_attention_bwd_bf16_walk`), and
it needs no scratch beyond the fp32 backward's. No other mix of dtypes is
taken.
"""

from __future__ import annotations

import functools

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["masked_memory_attention", "masked_memory_attention_reference",
           "masked_memory_attention_bwd_reference"]

_NAME = "masked_memory_attention"
# the memory's key / value width = GMFlow's feature width (EMIPLong builds
# its LTM at that width): 128 in pvt_v2_b5's configuration, 64 in b0's
_WIDTHS = (64, 128)


def masked_memory_attention_reference(q, k, v, bias) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_memory_attention` (with bf16
    q that of its bf16 forward: the exact products of q and k summed in
    fp32, P = exp(S - row max) rounded to bf16 for P v, the sum of the
    unrounded P divided out after)."""
    c = q.shape[-1]
    if q.dtype == torch.bfloat16:
        scores = q.float() @ k.transpose(-1, -2) / c**0.5 + bias[:, None, :]
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        return (p.to(torch.bfloat16).float() @ v) / p.sum(-1, keepdim=True)
    scores = q @ k.transpose(-1, -2) / c**0.5 + bias[:, None, :]
    return torch.softmax(scores, dim=-1) @ v


def masked_memory_attention_bwd_reference(q, k, v, bias, out, g,
                                          needs=(True, True, True)) -> list:
    """Plain PyTorch version of the backward (the CPU's, in both bands):
    (dq, dk, dv), each None where ``needs`` says so, as the JAX kernel
    computes them: q upcast, P recomputed in fp32, ``delta = sum(g * out)``
    from the forward's output ``out``, dq rounded to q's dtype, dk and dv
    fp32."""
    c = q.shape[-1]
    q32 = q.float() if q.dtype == torch.bfloat16 else q
    scores = q32 @ k.transpose(-1, -2) / c**0.5 + bias[:, None, :]
    p = torch.softmax(scores, dim=-1)
    delta = (g * out).sum(-1, keepdim=True)
    ds = p * (g @ v.transpose(-1, -2) - delta)
    return [(ds @ k / c**0.5).to(q.dtype) if needs[0] else None,
            ds.transpose(-1, -2) @ q32 / c**0.5 if needs[1] else None,
            p.transpose(-1, -2) @ g if needs[2] else None]


@functools.lru_cache(maxsize=None)
def _bf16_workspace(b: int, m: int, n: int, c: int) -> int:
    """Floats of scratch the bf16 forward takes at this shape: the ring's
    three bf16 parts of k and of v, and the partials of its key splits, as
    the kernel plans them."""
    return library().emip_memory_attention_bf16_workspace(b, m, n, c)


def _check(q, k, v, bias) -> None:
    cm.check_kernel_args(_NAME, q.dtype, q=q)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{_NAME}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    # k, v and the bias are fp32 in both bands (the ring stays fp32)
    cm.check_kernel_args(_NAME, k=k, v=v, bias=bias)
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
    """Both bands: a bf16 q takes the kernels named ``..._bf16``; the
    output, the row statistics and every other tensor are fp32 in both."""

    @staticmethod
    def forward(ctx, q, k, v, bias, keep):
        ctx.cpu = cm.on_cpu(_NAME, q, k, v, bias)
        ctx.band = "_bf16" if q.dtype == torch.bfloat16 else ""
        stats = None
        if ctx.cpu:
            out = masked_memory_attention_reference(q, k, v, bias)
        else:
            _check(q, k, v, bias)
            b, m, c = q.shape
            n = k.shape[1]
            out = torch.empty((b, m, c), device=q.device,
                              dtype=torch.float32)
            # row max and row sum of the (unrounded) scores, read by the
            # backward
            stats = (torch.empty((2, b, m), device=q.device,
                                 dtype=torch.float32) if keep else None)
            if ctx.band:  # the ring's bf16 parts and the key splits'
                ws = torch.empty(_bf16_workspace(b, m, n, c),
                                 device=q.device, dtype=torch.float32)
            else:
                # room for the partials of two key splits beyond the
                # shared scratch, so that 4 clips at 512^2 (64 blocks of
                # 256 query rows) can split their keys and fill the card
                ws = cm.workspace(q.device, 2 * b * m * (c + 2))
            rc = getattr(library(), "emip_memory_attention" + ctx.band)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), cm.ptr(stats), ws.data_ptr(), ws.numel(), b,
                m, n, c, cm.stream_handle(q.device))
            cm.raise_on_error(_NAME, rc)
            cm.LAUNCHES["memory_attention" + ctx.band] += 1
        if keep:  # the backward reads the output (delta), as the JAX one
            ctx.save_for_backward(q, k, v, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        q, k, v, bias, out, stats = ctx.saved_tensors
        g = g.contiguous()
        if ctx.cpu:
            return (*masked_memory_attention_bwd_reference(
                q, k, v, bias, out, g, needs), None, None)
        b, m, c = q.shape
        n = k.shape[1]
        dq, dk, dv = (cm.empty_if(nd, t) for nd, t in zip(needs, (q, k, v)))
        # delta, and room for the key-tiled pass to split its queries three
        # ways (partial dk and dv) where that evens out its last wave; the
        # same in both bands, so that both split alike
        ws = cm.workspace(q.device, b * m
                          + (6 * b * n * c if needs[1] or needs[2] else 0))
        rc = getattr(library(), "emip_memory_attention_bwd" + ctx.band)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats.data_ptr(), g.data_ptr(), cm.ptr(dq),
            cm.ptr(dk), cm.ptr(dv), ws.data_ptr(), ws.numel(), b, m, n, c,
            cm.stream_handle(q.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["memory_attention_bwd" + ctx.band] += 1
        return dq, dk, dv, None, None


def masked_memory_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """q: [B, M, C]; k, v: [B, N, C]; bias: [B, N] additive (-1e9 masks an
    empty memory slot). Returns [B, M, C] (fp32).

    Differentiable in q, k and v; the backward computes only the grads that
    are asked for. A bf16 q (fp32 k, v and bias) takes the bf16 kernels (dq
    bf16, dk and dv fp32).
    """
    return _MemoryAttention.apply(q, k, v, bias, cm.grad_wanted(q, k, v))
