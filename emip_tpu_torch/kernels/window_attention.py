"""Kernels B, G and H: the GMFlow swin transformer per window, forward and
backward.

Ports of :mod:`emip_tpu.ops.pallas.window_attention`; the CUDA source is
``csrc/window_attention.cu``:

- :func:`fused_window_attention_layer` (G): ``LN1(attention(x, t) Wm)``,
  plus ``x`` with ``add_residual``;
- :func:`fused_window_attention_ffn_layer` (H): G's message, then
  ``x + LN2(gelu([x, msg] W0) W2)``;
- :func:`fused_window_attention_block` (B): G on ``(x, x)`` with the self
  layer's weights, then H on ``(x1, t)`` with the cross layer's, as one
  call. The model takes B for windows up to 784 tokens and G + H above.

Projection weights are in torch ``nn.Linear`` layout ([out, in]): a
layer's ``params`` holds wq, wk, wv, wm [C, C] and the LayerNorm s1, b1
[C]; a layer with FFN also w0 [F, 2C] (one weight, not the JAX kernel's
two halves), w2 [C, F] and s2, b2 [C]. Each public function is one
``torch.autograd.Function``: CPU tensors take the plain version (and its
autograd backward), CUDA tensors the forward and backward kernels, which
compute only the grads that are asked for (every product on the tensor
cores). When a gradient is wanted the forward kernel also writes each
attention row's max and sum, which the backward kernel reads.

In the bf16 band, B with bf16 ``x`` and ``t`` (fp32 parameters) is the
mixed block of the JAX kernel with a bf16 storage dtype: the self layer
in bf16 (its weights cast once, :func:`emip_tpu_torch.dtypes.cast`; G's
bf16 layer, ``emip_window_layer_bf16``, with t = x and the residual), the
cross layer and the FFN in fp32 on x1 and t,
the output rounded to bf16 (``emip_window_block_bf16``). The cross layer
and FFN are H's bf16 forward: every product on the wgmma product of
``csrc/gemm_wgmma.cuh`` (3xTF32, two terms where A is bf16), x1 and t read
as bf16 where they lie, W0 in JAX's two halves, msg and the output in
their products' LayerNorm epilogues
(:func:`~emip_tpu_torch.kernels.tf32.window_block_fwd_bf16_walk`).
Its backward (``emip_window_block_bwd_bf16``) is the JAX kernel's: the self
layer recomputed in fp32 on x and the fp32 weights, x1 rounded as the
forward rounds it and its roundings passed straight through, the fp32
cross layer, FFN and block backward, gx and gt rounded to bf16 (the bf16
forward's buffers are not the recompute's, so it keeps only its inputs).
It reads x, t and the gradient as bf16 where they lie, and the products
with x, t or x1 take the TF32 terms their exactness leaves
(:func:`~emip_tpu_torch.kernels.tf32.window_block_bwd_bf16_walk`).

G and H with bf16 ``x`` and ``t`` (fp32 parameters) are the two halves of
B's bf16 forward, as the JAX kernels compute them with a bf16 storage
dtype: G in bf16 (``emip_window_layer_bf16``: q, k, v, P and o rounded,
LN1 in fp32, the residual added in bf16; three launches: q, k, v on the
bf16 wgmma product, the bf16 attention, Wm with LN1 and the residual in
that product's epilogue,
:func:`~emip_tpu_torch.kernels.tf32.window_layer_fwd_bf16_walk`; the
attention reads the shift mask's rows by TMA, whose strides are whole 16
bytes, so at a T that is no multiple of 4, as the 121 tokens of
multi-scale GMFlow's fine windows, it reads a copy of the mask with its
rows padded, :func:`~emip_tpu_torch.kernels.attention.mask_rows16`), H in
fp32 on x and t with only
its output rounded (``emip_window_ffn_layer_bf16``, on the wgmma product
as B's cross layer; :func:`~emip_tpu_torch.kernels.tf32.window_ffn_bf16_walk`).
Their bf16
backwards (``emip_window_layer_bwd_bf16``, ``emip_window_ffn_layer_bwd_bf16``)
are the JAX kernels' as B's is: the layer recomputed in fp32 on x and t and
the fp32 weights, its fp32 backward, gx and gt rounded to bf16, the
parameter grads fp32. They read x, t and the gradient as bf16 where they
lie and run the recompute's products and the input grads on the wgmma
product (the input grads on the transposed weights, split once a call),
the attention on the 3xTF32 tensor-core kernels and the weight grads on
the 3xTF32 GEMM
(:func:`~emip_tpu_torch.kernels.tf32.window_layer_bwd_bf16_walk`,
:func:`~emip_tpu_torch.kernels.tf32.window_ffn_layer_bwd_bf16_walk`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.dtypes import cast
from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library
from emip_tpu_torch.kernels.attention import (
    _workspace_floats,
    forward_workspace,
    mask_rows16,
    mask_zero_tiles,
)

__all__ = ["fused_window_attention_block",
           "fused_window_attention_block_reference",
           "fused_window_attention_layer",
           "fused_window_attention_layer_reference",
           "fused_window_attention_ffn_layer",
           "fused_window_attention_ffn_layer_reference"]

_NAME = "fused_window_attention_block"
_LAYER = "fused_window_attention_layer"
_FFN_LAYER = "fused_window_attention_ffn_layer"
EPS = 1e-6  # flax LayerNorm epsilon, as in the JAX kernel
# GMFlow feature width = the backbone's /8 width: 128 in pvt_v2_b5, 64 in b0
_WIDTHS = (64, 128)
_SELF_KEYS = ("wq", "wk", "wv", "wm", "s1", "b1")
_CROSS_KEYS = _SELF_KEYS + ("w0", "w2", "s2", "b2")
# the parameters the backward kernels read (biases of LayerNorms are not)
_BWD_READS = (0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14)
_LAYER_BWD_READS = (0, 1, 2, 3, 4)
_FFN_LAYER_BWD_READS = (0, 1, 2, 3, 4, 6, 7, 8)


def _message(x, t, p, mask):
    c = x.shape[-1]
    q = F.linear(x, p["wq"])
    k = F.linear(t, p["wk"])
    v = F.linear(t, p["wv"])
    scores = q @ k.transpose(-1, -2) / c**0.5
    if mask is not None:
        scores = scores + mask
    o = torch.softmax(scores, dim=-1) @ v
    return F.layer_norm(F.linear(o, p["wm"]), (c,), p["s1"], p["b1"], EPS)


def fused_window_attention_layer_reference(x, t, params, mask=None,
                                           add_residual: bool = True
                                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_window_attention_layer` (with
    bf16 ``x`` that of its bf16 forward)."""
    if x.dtype == torch.bfloat16:
        return _layer_reference_bf16(x, t, params, mask, add_residual)
    msg = _message(x, t, params, mask)
    return x + msg if add_residual else msg


def fused_window_attention_ffn_layer_reference(x, t, params, mask=None
                                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_window_attention_ffn_layer`
    (with bf16 ``x`` that of its bf16 forward)."""
    if x.dtype == torch.bfloat16:
        return _ffn_layer_reference_bf16(x, t, params, mask)
    c = x.shape[-1]
    msg = _message(x, t, params, mask)
    u = F.gelu(F.linear(torch.cat([x, msg], dim=-1), params["w0"]))
    z = F.linear(u, params["w2"])
    return x + F.layer_norm(z, (c,), params["s2"], params["b2"], EPS)


def _layer_reference_bf16(x, t, params, mask=None, add_residual=True):
    """G's bf16 forward at the JAX kernel's rounding points with a bf16
    storage dtype: q from x, k and v from t, each rounded to bf16 (fp32
    sums over the weights cast to bf16), P and o rounded, LN1 in fp32 and
    rounded, then x + msg added in bf16."""
    dt = torch.bfloat16
    c = x.shape[-1]
    w = {k: params[k].to(dt).float() for k in ("wq", "wk", "wv", "wm")}
    q = F.linear(x.float(), w["wq"]).to(dt).float()
    k, v = (F.linear(t.float(), w[n]).to(dt).float() for n in ("wk", "wv"))
    scores = q @ k.transpose(-1, -2) / c**0.5
    if mask is not None:
        scores = scores + mask
    o = (torch.softmax(scores, dim=-1).to(dt).float() @ v).to(dt).float()
    msg = F.layer_norm(F.linear(o, w["wm"]), (c,), params["s1"].float(),
                       params["b1"].float(), EPS).to(dt)
    return x + msg if add_residual else msg


def _ffn_layer_reference_bf16(x, t, params, mask=None):
    """H's bf16 forward as the JAX kernel computes it with a bf16 storage
    dtype: the fp32 layer on the upcast x and t with the fp32 weights, the
    output rounded once."""
    return fused_window_attention_ffn_layer_reference(
        x.float(), t.float(), params, mask).to(torch.bfloat16)


def _block_reference_bf16(x, t, self_params, cross_params, mask=None):
    """The JAX block kernel's rounding points with a bf16 storage dtype:
    G's bf16 self layer on (x, x), then H's bf16 layer on (x1, t)."""
    x1 = _layer_reference_bf16(x, x, self_params, mask)
    return _ffn_layer_reference_bf16(x1, t, cross_params, mask)


def _block_recompute_bf16(x, t, self_params, cross_params, mask=None):
    """The function the JAX block's bf16 backward differentiates, on fp32
    x and t holding bf16 values: the self layer in fp32 on the fp32
    weights, x1 = bf16(x + bf16(msg)) with its roundings passed straight
    through, the fp32 cross layer and FFN."""
    dt = torch.bfloat16
    msg = _message(x, x, self_params, mask)
    x1 = x + msg
    rounded = (x + msg.to(dt).float()).to(dt).float()
    x1 = x1 + (rounded - x1).detach()
    return fused_window_attention_ffn_layer_reference(x1, t, cross_params,
                                                      mask)


def fused_window_attention_block_reference(x, t, self_params, cross_params,
                                           mask=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_window_attention_block` (with
    bf16 ``x`` that of its bf16 forward)."""
    if x.dtype == torch.bfloat16:
        return _block_reference_bf16(x, t, self_params, cross_params, mask)
    x1 = fused_window_attention_layer_reference(x, x, self_params, mask)
    return fused_window_attention_ffn_layer_reference(x1, t, cross_params,
                                                      mask)


def _reference_flat(x, t, *rest):
    *params, mask = rest
    return fused_window_attention_block_reference(
        x, t, dict(zip(_SELF_KEYS, params[:6])),
        dict(zip(_CROSS_KEYS, params[6:])), mask)


def _recompute_flat(x, t, *rest):
    *params, mask = rest
    return _block_recompute_bf16(x, t, dict(zip(_SELF_KEYS, params[:6])),
                                 dict(zip(_CROSS_KEYS, params[6:])), mask)


def _check_layer(name, x, t, p, mask, prefix="",
                 dtype=torch.float32) -> None:
    """x, t (in ``dtype``) and one layer's fp32 parameters (with its FFN's
    if ``p`` has one)."""
    cm.check_kernel_args(name, dtype, x=x, t=t)
    cm.check_kernel_args(name, **{prefix + k: v for k, v in p.items()})
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, K2, T, C]")
    _, k2, tok, c = x.shape
    if c not in _WIDTHS:
        raise ValueError(f"{name}: channel width {c} not in {_WIDTHS}")
    cm.check_shape(name, "t", t, x.shape)
    for key in ("wq", "wk", "wv", "wm"):
        cm.check_shape(name, prefix + key, p[key], (c, c))
    for key in ("s1", "b1"):
        cm.check_shape(name, prefix + key, p[key], (c,))
    if "w0" in p:
        f = p["w0"].shape[0]
        cm.check_shape(name, "w0", p["w0"], (f, 2 * c))
        cm.check_shape(name, "w2", p["w2"], (c, f))
        cm.check_shape(name, "s2", p["s2"], (c,))
        cm.check_shape(name, "b2", p["b2"], (c,))
    if mask is not None:
        cm.check_kernel_args(name, mask=mask)
        cm.check_shape(name, "mask", mask, (k2, tok, tok))


def _check(x, t, params, mask, dtype=torch.float32) -> None:
    _check_layer(_NAME, x, t, dict(zip(_SELF_KEYS, params[:6])), mask,
                 "self_", dtype)
    _check_layer(_NAME, x, t, dict(zip(_CROSS_KEYS, params[6:])), mask,
                 "cross_", dtype)


def _buffers(x, widths):
    """Uninitialised [rows, width] scratch per width, on x's device."""
    rows = x.numel() // x.shape[-1]
    return [torch.empty((rows, w), device=x.device, dtype=x.dtype)
            for w in widths]


def _stats(x, keep):
    """[2, windows, T] row max and row sum of a layer's attention, kept when
    a gradient will be taken (the backward reads them), else None."""
    b, k2, tok, _ = x.shape
    return (torch.empty((2, b * k2, tok), device=x.device, dtype=x.dtype)
            if keep else None)


def _fwd_workspace(x):
    """Scratch for the key-split partials of a forward's attention (None
    where it takes one split)."""
    b, k2, tok, c = x.shape
    return forward_workspace(x.device, b * k2, 1, tok, tok, c, True)


def _split_workspace(x, c, f):
    """fp32 room for the cross layer's and the FFN's weights split into
    their TF32 halves (``cross_ffn_bf16``): [Wq; Wk; Wv], Wm, W0 and W2, each
    [2 out, in]."""
    return torch.empty(8 * c * c + 6 * c * f, device=x.device,
                       dtype=torch.float32)


def _bwd_split_floats(c, f):
    """fp32 room for G's (f = 0) or H's weights split into their TF32
    halves by their bf16 backwards, as they are and transposed
    (``split_layer``)."""
    return 14 * c * c + 10 * c * f


def _stats_floats(rows):
    """A backward's [2, windows, T] attention statistics, rounded up to 16
    bytes."""
    return -(-2 * rows // 4) * 4


def _param_grads(needs, shapes, like):
    return [torch.empty(s, device=like.device, dtype=like.dtype) if nd
            else None for nd, s in zip(needs, shapes)]


class _WindowLayer(torch.autograd.Function):
    """G. params: wq, wk, wv, wm, s1, b1."""

    @staticmethod
    def forward(ctx, x, t, mask, keep, add_residual, *params):
        tensors = [x, t, *params] + ([] if mask is None else [mask])
        ctx.cpu = cm.on_cpu(_LAYER, *tensors)
        ctx.add_residual = add_residual
        p = dict(zip(_SELF_KEYS, params))
        if ctx.cpu:
            if keep:
                ctx.save_for_backward(x, t, mask, *params)
            return fused_window_attention_layer_reference(x, t, p, mask,
                                                          add_residual)
        _check_layer(_LAYER, x, t, p, mask)
        b, k2, tok, c = x.shape
        qkv, o, m = _buffers(x, (3 * c, c, c))
        stats = _stats(x, keep)
        out = torch.empty_like(x)
        ws = _fwd_workspace(x)
        rc = library().emip_window_layer(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in params),
            cm.ptr(mask), k2, qkv.data_ptr(), o.data_ptr(), m.data_ptr(),
            cm.ptr(stats), out.data_ptr(), cm.ptr(ws), cm.numel(ws),
            b * k2, tok, c, int(add_residual), EPS,
            cm.stream_handle(x.device))
        cm.raise_on_error(_LAYER, rc)
        cm.LAUNCHES["window_attention_layer"] += 1
        if keep:
            ctx.save_for_backward(x, t, mask,
                                  *(params[i] for i in _LAYER_BWD_READS),
                                  qkv, o, m, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        needs_x, needs_t = ctx.needs_input_grad[:2]
        needs_p = ctx.needs_input_grad[5:]
        if ctx.cpu:
            x, t, mask, *params = ctx.saved_tensors

            def plain(x, t, *p):
                return fused_window_attention_layer_reference(
                    x, t, dict(zip(_SELF_KEYS, p)), mask, ctx.add_residual)

            grads = cm.plain_vjp(plain, (x, t, *params),
                                 (needs_x, needs_t, *needs_p), g)
            return (grads[0], grads[1], None, None, None, *grads[2:])
        x, t, mask, *rest = ctx.saved_tensors
        weights, saved = rest[:5], rest[5:]
        g = g.contiguous()
        b, k2, tok, c = x.shape
        pgrads = _param_grads(needs_p, [(c, c)] * 4 + [(c,)] * 2, x)
        gx, gt = cm.empty_if(needs_x, x), cm.empty_if(needs_t, t)
        ws = cm.workspace(x.device, b * k2 * tok * 6 * c)
        rc = library().emip_window_layer_bwd(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in weights),
            cm.ptr(mask), k2, *(s.data_ptr() for s in saved), g.data_ptr(),
            cm.ptr(gx), cm.ptr(gt), *(cm.ptr(p) for p in pgrads),
            ws.data_ptr(), ws.numel(), b * k2, tok, c,
            int(ctx.add_residual), EPS, cm.stream_handle(x.device))
        cm.raise_on_error(_LAYER + " backward", rc)
        cm.LAUNCHES["window_attention_layer_bwd"] += 1
        return (gx, gt, None, None, None, *pgrads)


class _WindowFFNLayer(torch.autograd.Function):
    """H. params: wq, wk, wv, wm, s1, b1, w0, w2, s2, b2."""

    @staticmethod
    def forward(ctx, x, t, mask, keep, *params):
        tensors = [x, t, *params] + ([] if mask is None else [mask])
        ctx.cpu = cm.on_cpu(_FFN_LAYER, *tensors)
        p = dict(zip(_CROSS_KEYS, params))
        if ctx.cpu:
            if keep:
                ctx.save_for_backward(x, t, mask, *params)
            return fused_window_attention_ffn_layer_reference(x, t, p, mask)
        _check_layer(_FFN_LAYER, x, t, p, mask)
        b, k2, tok, c = x.shape
        f = p["w0"].shape[0]
        qkv, o, m, cat, u = _buffers(x, (3 * c, c, c, 2 * c, f))
        if keep:  # what the backward reads
            h, z = _buffers(x, (f, c))
        else:
            h, z = None, m
        stats = _stats(x, keep)
        out = torch.empty_like(x)
        ws = _fwd_workspace(x)
        rc = library().emip_window_ffn_layer(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in params),
            cm.ptr(mask), k2, qkv.data_ptr(), o.data_ptr(), m.data_ptr(),
            cm.ptr(stats), cat.data_ptr(), cm.ptr(h), u.data_ptr(),
            z.data_ptr(), out.data_ptr(), cm.ptr(ws), cm.numel(ws), b * k2,
            tok, c, f, EPS, cm.stream_handle(x.device))
        cm.raise_on_error(_FFN_LAYER, rc)
        cm.LAUNCHES["window_attention_ffn_layer"] += 1
        if keep:
            ctx.save_for_backward(
                x, t, mask, *(params[i] for i in _FFN_LAYER_BWD_READS), qkv,
                o, m, stats, cat, h, u, z)
        return out

    @staticmethod
    def backward(ctx, g):
        needs_x, needs_t = ctx.needs_input_grad[:2]
        needs_p = ctx.needs_input_grad[4:]
        if ctx.cpu:
            x, t, mask, *params = ctx.saved_tensors

            def plain(x, t, *p):
                return fused_window_attention_ffn_layer_reference(
                    x, t, dict(zip(_CROSS_KEYS, p)), mask)

            grads = cm.plain_vjp(plain, (x, t, *params),
                                 (needs_x, needs_t, *needs_p), g)
            return (grads[0], grads[1], None, None, *grads[2:])
        x, t, mask, *rest = ctx.saved_tensors
        n = len(_FFN_LAYER_BWD_READS)
        weights, saved = rest[:n], rest[n:]
        g = g.contiguous()
        b, k2, tok, c = x.shape
        f = saved[5].shape[1]  # h
        pgrads = _param_grads(
            needs_p, [(c, c)] * 4 + [(c,)] * 2 + [(f, 2 * c), (c, f), (c,),
                                                  (c,)], x)
        gx, gt = cm.empty_if(needs_x, x), cm.empty_if(needs_t, t)
        ws = cm.workspace(x.device, b * k2 * tok * (8 * c + f))
        rc = library().emip_window_ffn_layer_bwd(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in weights),
            cm.ptr(mask), k2, *(s.data_ptr() for s in saved), g.data_ptr(),
            cm.ptr(gx), cm.ptr(gt), *(cm.ptr(p) for p in pgrads),
            ws.data_ptr(), ws.numel(), b * k2, tok, c, f, EPS,
            cm.stream_handle(x.device))
        cm.raise_on_error(_FFN_LAYER + " backward", rc)
        cm.LAUNCHES["window_attention_ffn_layer_bwd"] += 1
        return (gx, gt, None, None, *pgrads)


class _WindowBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t, mask, keep, *params):
        tensors = [x, t, *params] + ([] if mask is None else [mask])
        ctx.cpu = cm.on_cpu(_NAME, *tensors)
        if ctx.cpu:
            if keep:
                ctx.save_for_backward(x, t, mask, *params)
            return _reference_flat(x, t, *params, mask)
        _check(x, t, params, mask)
        b, k2, tok, c = x.shape
        f = params[12].shape[0]
        if keep:  # separate buffers per layer: what the backward reads
            qkv1, qkv2, o1, o2, m1, m2, h, z = _buffers(
                x, (3 * c, 3 * c, c, c, c, c, f, c))
        else:  # one buffer per kind, reused by both layers
            qkv1, o1, m1 = _buffers(x, (3 * c, c, c))
            qkv2, o2, m2, z, h = qkv1, o1, m1, m1, None
        stats1, stats2 = _stats(x, keep), _stats(x, keep)
        cat, u = _buffers(x, (2 * c, f))
        out = torch.empty_like(x)
        ws = _fwd_workspace(x)
        rc = library().emip_window_block(
            x.data_ptr(), t.data_ptr(), *(p.data_ptr() for p in params),
            cm.ptr(mask), k2, qkv1.data_ptr(), qkv2.data_ptr(),
            o1.data_ptr(), o2.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            cm.ptr(stats1), cm.ptr(stats2), cat.data_ptr(), cm.ptr(h),
            u.data_ptr(), z.data_ptr(), out.data_ptr(), cm.ptr(ws),
            cm.numel(ws), b * k2, tok, c, f, EPS, cm.stream_handle(x.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["window_attention_block"] += 1
        if keep:
            ctx.save_for_backward(x, t, mask,
                                  *(params[i] for i in _BWD_READS), qkv1,
                                  qkv2, o1, o2, m1, m2, stats1, stats2, cat,
                                  h, u, z)
        return out

    @staticmethod
    def backward(ctx, g):
        needs_x, needs_t = ctx.needs_input_grad[:2]
        needs_p = ctx.needs_input_grad[4:]
        if ctx.cpu:
            x, t, mask, *params = ctx.saved_tensors
            grads = cm.plain_vjp(_reference_flat, (x, t, *params),
                                 (needs_x, needs_t, *needs_p), g, mask)
            return (grads[0], grads[1], None, None, *grads[2:])
        x, t, mask, *rest = ctx.saved_tensors
        weights, saved = rest[:len(_BWD_READS)], rest[len(_BWD_READS):]
        g = g.contiguous()
        b, k2, tok, c = x.shape
        f = saved[9].shape[1]  # h
        rows = b * k2 * tok
        layer = [(c, c)] * 4 + [(c,)] * 2
        pgrads = _param_grads(
            needs_p, layer + layer + [(f, 2 * c), (c, f), (c,), (c,)], x)
        gx = cm.empty_if(needs_x, x)
        gt = cm.empty_if(needs_t, t)
        ws = cm.workspace(x.device, rows * (9 * c + f))
        rc = library().emip_window_block_bwd(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in weights),
            cm.ptr(mask), k2, *(s.data_ptr() for s in saved), g.data_ptr(),
            cm.ptr(gx), cm.ptr(gt), *(cm.ptr(p) for p in pgrads),
            ws.data_ptr(), ws.numel(), b * k2, tok, c, f, EPS,
            cm.stream_handle(x.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["window_attention_block_bwd"] += 1
        return (gx, gt, None, None, *pgrads)


class _WindowBlockBf16(torch.autograd.Function):
    """B in the bf16 band: bf16 x, t and output, fp32 parameters."""

    @staticmethod
    def forward(ctx, x, t, mask, keep, *params):
        tensors = [x, t, *params] + ([] if mask is None else [mask])
        ctx.cpu = cm.on_cpu(_NAME, *tensors)
        if keep:  # the backward recomputes the rest from them
            ctx.save_for_backward(x, t, mask, *params)
        if ctx.cpu:
            return _block_reference_bf16(
                x, t, dict(zip(_SELF_KEYS, params[:6])),
                dict(zip(_CROSS_KEYS, params[6:])), mask)
        _check(x, t, params, mask, torch.bfloat16)
        b, k2, tok, c = x.shape
        f = params[12].shape[0]
        self_w = [cast(w, torch.bfloat16) for w in params[:4]]
        rows = b * k2 * tok
        qkv1, o1, x1 = (torch.empty((rows, w), device=x.device,
                                    dtype=torch.bfloat16)
                        for w in (3 * c, c, c))
        qkv2, o2, msg, u = (
            torch.empty((rows, w), device=x.device, dtype=torch.float32)
            for w in (3 * c, c, c, f))
        wsplit = _split_workspace(x, c, f)
        out = torch.empty_like(x)
        ws = _fwd_workspace(x)
        mask16, mask_sn = mask_rows16(mask)
        rc = library().emip_window_block_bf16(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in self_w),
            *(p.data_ptr() for p in params[4:]), cm.ptr(mask), k2,
            cm.ptr(mask16), mask_sn, cm.ptr(mask_zero_tiles(mask)),
            qkv1.data_ptr(), o1.data_ptr(), x1.data_ptr(),
            wsplit.data_ptr(), qkv2.data_ptr(), o2.data_ptr(),
            msg.data_ptr(), u.data_ptr(), out.data_ptr(), cm.ptr(ws),
            cm.numel(ws), b * k2, tok, c, f, EPS, cm.stream_handle(x.device))
        cm.raise_on_error(_NAME + " (bf16)", rc)
        cm.LAUNCHES["window_attention_block_bf16"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs_x, needs_t = ctx.needs_input_grad[:2]
        needs_p = ctx.needs_input_grad[4:]
        x, t, mask, *params = ctx.saved_tensors
        if ctx.cpu:
            grads = cm.plain_vjp_fp32(_recompute_flat, (x, t, *params),
                                      (needs_x, needs_t, *needs_p), g, mask)
            return (grads[0], grads[1], None, None, *grads[2:])
        g = g.contiguous()
        b, k2, tok, c = x.shape
        f = params[12].shape[0]
        rows = b * k2 * tok
        pgrads = [torch.empty_like(p) if nd else None
                  for nd, p in zip(needs_p, params)]
        gx = cm.empty_if(needs_x, x)
        gt = cm.empty_if(needs_t, t)
        # fp32 scratch for the recompute (see emip_window_block_bwd_bf16),
        # then the larger of its key-split partials and the block
        # backward's activation grads and workspace (the fp32 backward's,
        # so that both split alike)
        scratch = rows * (13 * c + 2 * f) + 4 * rows
        rest = max(_workspace_floats(b * k2, 1, tok, tok, c, True),
                   rows * (9 * c + f))
        ws = cm.workspace(x.device, scratch + rest)
        rc = library().emip_window_block_bwd_bf16(
            x.data_ptr(), t.data_ptr(),
            *(params[i].data_ptr() for i in range(15)), cm.ptr(mask), k2,
            g.data_ptr(), cm.ptr(gx), cm.ptr(gt),
            *(cm.ptr(p) for p in pgrads), ws.data_ptr(), ws.numel(), b * k2,
            tok, c, f, EPS, cm.stream_handle(x.device))
        cm.raise_on_error(_NAME + " backward (bf16)", rc)
        cm.LAUNCHES["window_attention_block_bwd_bf16"] += 1
        return (gx, gt, None, None, *pgrads)


class _WindowLayerBf16(torch.autograd.Function):
    """G in the bf16 band: bf16 x, t and output, fp32 parameters (wq, wk,
    wv, wm, s1, b1)."""

    @staticmethod
    def forward(ctx, x, t, mask, keep, add_residual, *params):
        tensors = [x, t, *params] + ([] if mask is None else [mask])
        ctx.cpu = cm.on_cpu(_LAYER, *tensors)
        ctx.add_residual = add_residual
        if keep:  # the backward recomputes the rest from them
            ctx.save_for_backward(x, t, mask, *params)
        p = dict(zip(_SELF_KEYS, params))
        if ctx.cpu:
            return _layer_reference_bf16(x, t, p, mask, add_residual)
        return _layer_bf16(x, t, p, mask, add_residual)

    @staticmethod
    def backward(ctx, g):
        needs_x, needs_t = ctx.needs_input_grad[:2]
        needs_p = ctx.needs_input_grad[5:]
        x, t, mask, *params = ctx.saved_tensors
        if ctx.cpu:
            def plain(x, t, *p):
                return fused_window_attention_layer_reference(
                    x, t, dict(zip(_SELF_KEYS, p)), mask, ctx.add_residual)

            grads = cm.plain_vjp_fp32(plain, (x, t, *params),
                                      (needs_x, needs_t, *needs_p), g)
            return (grads[0], grads[1], None, None, None, *grads[2:])
        g = g.contiguous()
        b, k2, tok, c = x.shape
        rows = b * k2 * tok
        pgrads = [torch.empty_like(p) if nd else None
                  for nd, p in zip(needs_p, params)]
        gx, gt = cm.empty_if(needs_x, x), cm.empty_if(needs_t, t)
        # the split weights and fp32 scratch (see
        # emip_window_layer_bwd_bf16), then the larger of the recompute's
        # key-split partials and what the backward's LayerNorm and weight
        # grads take
        scratch = _bwd_split_floats(c, 0) + rows * 10 * c + _stats_floats(rows)
        rest = max(_workspace_floats(b * k2, 1, tok, tok, c, True),
                   rows * 2 * c)
        ws = cm.workspace(x.device, scratch + rest)
        rc = library().emip_window_layer_bwd_bf16(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in params[:5]),
            cm.ptr(mask), k2, g.data_ptr(), cm.ptr(gx), cm.ptr(gt),
            *(cm.ptr(p) for p in pgrads), ws.data_ptr(), ws.numel(), b * k2,
            tok, c, int(ctx.add_residual), EPS, cm.stream_handle(x.device))
        cm.raise_on_error(_LAYER + " backward (bf16)", rc)
        cm.LAUNCHES["window_attention_layer_bwd_bf16"] += 1
        return (gx, gt, None, None, None, *pgrads)


class _WindowFFNLayerBf16(torch.autograd.Function):
    """H in the bf16 band: bf16 x, t and output, fp32 parameters (wq, wk,
    wv, wm, s1, b1, w0, w2, s2, b2)."""

    @staticmethod
    def forward(ctx, x, t, mask, keep, *params):
        tensors = [x, t, *params] + ([] if mask is None else [mask])
        ctx.cpu = cm.on_cpu(_FFN_LAYER, *tensors)
        if keep:  # the backward recomputes the rest from them
            ctx.save_for_backward(x, t, mask, *params)
        p = dict(zip(_CROSS_KEYS, params))
        if ctx.cpu:
            return _ffn_layer_reference_bf16(x, t, p, mask)
        return _ffn_layer_bf16(x, t, p, mask)

    @staticmethod
    def backward(ctx, g):
        needs_x, needs_t = ctx.needs_input_grad[:2]
        needs_p = ctx.needs_input_grad[4:]
        x, t, mask, *params = ctx.saved_tensors
        if ctx.cpu:
            def plain(x, t, *p):
                return fused_window_attention_ffn_layer_reference(
                    x, t, dict(zip(_CROSS_KEYS, p)), mask)

            grads = cm.plain_vjp_fp32(plain, (x, t, *params),
                                      (needs_x, needs_t, *needs_p), g)
            return (grads[0], grads[1], None, None, *grads[2:])
        g = g.contiguous()
        b, k2, tok, c = x.shape
        f = params[6].shape[0]
        rows = b * k2 * tok
        pgrads = [torch.empty_like(p) if nd else None
                  for nd, p in zip(needs_p, params)]
        gx, gt = cm.empty_if(needs_x, x), cm.empty_if(needs_t, t)
        # the split weights and fp32 scratch (see
        # emip_window_ffn_layer_bwd_bf16), then the larger of the
        # recompute's key-split partials and what the backward's LayerNorms
        # and weight grads take
        scratch = (_bwd_split_floats(c, f) + rows * (15 * c + 3 * f)
                   + _stats_floats(rows))
        rest = max(_workspace_floats(b * k2, 1, tok, tok, c, True),
                   rows * 2 * c)
        ws = cm.workspace(x.device, scratch + rest)
        rc = library().emip_window_ffn_layer_bwd_bf16(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in params),
            cm.ptr(mask), k2, g.data_ptr(), cm.ptr(gx), cm.ptr(gt),
            *(cm.ptr(p) for p in pgrads), ws.data_ptr(), ws.numel(), b * k2,
            tok, c, f, EPS, cm.stream_handle(x.device))
        cm.raise_on_error(_FFN_LAYER + " backward (bf16)", rc)
        cm.LAUNCHES["window_attention_ffn_layer_bwd_bf16"] += 1
        return (gx, gt, None, None, *pgrads)


def _layer_bf16(x, t, p, mask, add_residual):
    """G's bf16 kernel (see ``emip_window_layer_bf16``)."""
    _check_layer(_LAYER, x, t, p, mask, dtype=torch.bfloat16)
    b, k2, tok, c = x.shape
    rows = b * k2 * tok
    w = [cast(p[k], torch.bfloat16) for k in ("wq", "wk", "wv", "wm")]
    qkv, o = (torch.empty((rows, n), device=x.device, dtype=torch.bfloat16)
              for n in (3 * c, c))
    out = torch.empty_like(x)
    mask16, mask_sn = mask_rows16(mask)
    rc = library().emip_window_layer_bf16(
        x.data_ptr(), t.data_ptr(), *(a.data_ptr() for a in w),
        p["s1"].data_ptr(), p["b1"].data_ptr(), cm.ptr(mask16), mask_sn, k2,
        cm.ptr(mask_zero_tiles(mask)), qkv.data_ptr(), o.data_ptr(),
        out.data_ptr(), b * k2, tok, c, int(add_residual), EPS,
        cm.stream_handle(x.device))
    cm.raise_on_error(_LAYER + " (bf16)", rc)
    cm.LAUNCHES["window_attention_layer_bf16"] += 1
    return out


def _ffn_layer_bf16(x, t, p, mask):
    """H's bf16 kernel (see ``emip_window_ffn_layer_bf16``)."""
    _check_layer(_FFN_LAYER, x, t, p, mask, dtype=torch.bfloat16)
    b, k2, tok, c = x.shape
    f = p["w0"].shape[0]
    rows = b * k2 * tok
    qkv, o, msg, u = (
        torch.empty((rows, n), device=x.device, dtype=torch.float32)
        for n in (3 * c, c, c, f))
    wsplit = _split_workspace(x, c, f)
    out = torch.empty_like(x)
    ws = _fwd_workspace(x)
    rc = library().emip_window_ffn_layer_bf16(
        x.data_ptr(), t.data_ptr(), *(p[k].data_ptr() for k in _CROSS_KEYS),
        cm.ptr(mask), k2, wsplit.data_ptr(), qkv.data_ptr(), o.data_ptr(),
        msg.data_ptr(), u.data_ptr(), out.data_ptr(), cm.ptr(ws),
        cm.numel(ws), b * k2, tok, c, f, EPS, cm.stream_handle(x.device))
    cm.raise_on_error(_FFN_LAYER + " (bf16)", rc)
    cm.LAUNCHES["window_attention_ffn_layer_bf16"] += 1
    return out


def fused_window_attention_block(x: torch.Tensor, t: torch.Tensor,
                                 self_params: dict, cross_params: dict,
                                 mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Self + cross attention + concat-FFN block per window.

    x, t: [B, K2, T, C] pre-split (and, if shifted, pre-rolled) windows;
    mask: [K2, T, T] additive shift mask or None, applied to both layers.
    Differentiable in x, t and every parameter (not in the mask). With
    bf16 ``x`` and ``t`` (fp32 parameters) the bf16 kernels: bf16 out, gx
    and gt bf16, the parameter grads fp32.
    """
    params = [self_params[k] for k in _SELF_KEYS] + [
        cross_params[k] for k in _CROSS_KEYS]
    fn = _WindowBlockBf16 if x.dtype == torch.bfloat16 else _WindowBlock
    return fn.apply(x, t, mask, cm.grad_wanted(x, t, *params), *params)


def fused_window_attention_layer(x: torch.Tensor, t: torch.Tensor,
                                 params: dict,
                                 mask: torch.Tensor | None = None,
                                 add_residual: bool = True) -> torch.Tensor:
    """One attention layer per window: q from ``x``, k and v from ``t``.

    x, t: [B, K2, T, C] pre-split (and, if shifted, pre-rolled) windows of
    any token count T; mask: [K2, T, T] additive shift mask or None.
    Returns ``LN1(attention Wm)``, plus ``x`` with ``add_residual``.
    Differentiable in x, t and every parameter (not in the mask). With
    bf16 ``x`` and ``t`` (fp32 parameters) the bf16 kernels: bf16 out, gx
    and gt bf16, the parameter grads fp32.
    """
    flat = [params[k] for k in _SELF_KEYS]
    fn = _WindowLayerBf16 if x.dtype == torch.bfloat16 else _WindowLayer
    return fn.apply(x, t, mask, cm.grad_wanted(x, t, *flat),
                    bool(add_residual), *flat)


def fused_window_attention_ffn_layer(x: torch.Tensor, t: torch.Tensor,
                                     params: dict,
                                     mask: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Cross-attention + concat-FFN layer per window.

    Shapes as :func:`fused_window_attention_layer`; ``params`` also holds
    w0 [F, 2C], w2 [C, F], s2, b2. Returns
    ``x + LN2(gelu([x, msg] W0) W2)`` with ``msg`` the attention message.
    bf16 ``x`` and ``t`` (fp32 parameters) take the bf16 kernels, as
    :func:`fused_window_attention_layer`.
    """
    flat = [params[k] for k in _CROSS_KEYS]
    fn = (_WindowFFNLayerBf16 if x.dtype == torch.bfloat16
          else _WindowFFNLayer)
    return fn.apply(x, t, mask, cm.grad_wanted(x, t, *flat), *flat)
