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
compute only the grads that are asked for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

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
    """Plain PyTorch version of :func:`fused_window_attention_layer`."""
    msg = _message(x, t, params, mask)
    return x + msg if add_residual else msg


def fused_window_attention_ffn_layer_reference(x, t, params, mask=None
                                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_window_attention_ffn_layer`."""
    c = x.shape[-1]
    msg = _message(x, t, params, mask)
    u = F.gelu(F.linear(torch.cat([x, msg], dim=-1), params["w0"]))
    z = F.linear(u, params["w2"])
    return x + F.layer_norm(z, (c,), params["s2"], params["b2"], EPS)


def fused_window_attention_block_reference(x, t, self_params, cross_params,
                                           mask=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_window_attention_block`."""
    x1 = fused_window_attention_layer_reference(x, x, self_params, mask)
    return fused_window_attention_ffn_layer_reference(x1, t, cross_params,
                                                      mask)


def _reference_flat(x, t, *rest):
    *params, mask = rest
    return fused_window_attention_block_reference(
        x, t, dict(zip(_SELF_KEYS, params[:6])),
        dict(zip(_CROSS_KEYS, params[6:])), mask)


def _check_layer(name, x, t, p, mask, prefix="") -> None:
    """x, t and one layer's parameters (with its FFN's if ``p`` has one)."""
    cm.check_kernel_args(name, x=x, t=t,
                         **{prefix + k: v for k, v in p.items()})
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


def _check(x, t, params, mask) -> None:
    _check_layer(_NAME, x, t, dict(zip(_SELF_KEYS, params[:6])), mask,
                 "self_")
    _check_layer(_NAME, x, t, dict(zip(_CROSS_KEYS, params[6:])), mask,
                 "cross_")


def _buffers(x, widths):
    """Uninitialised [rows, width] scratch per width, on x's device."""
    rows = x.numel() // x.shape[-1]
    return [torch.empty((rows, w), device=x.device, dtype=x.dtype)
            for w in widths]


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
        out = torch.empty_like(x)
        rc = library().emip_window_layer(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in params),
            cm.ptr(mask), k2, qkv.data_ptr(), o.data_ptr(), m.data_ptr(),
            out.data_ptr(), b * k2, tok, c, int(add_residual), EPS,
            cm.stream_handle(x.device))
        cm.raise_on_error(_LAYER, rc)
        cm.LAUNCHES["window_attention_layer"] += 1
        if keep:
            ctx.save_for_backward(x, t, mask,
                                  *(params[i] for i in _LAYER_BWD_READS),
                                  qkv, o, m)
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
        out = torch.empty_like(x)
        rc = library().emip_window_ffn_layer(
            x.data_ptr(), t.data_ptr(), *(w.data_ptr() for w in params),
            cm.ptr(mask), k2, qkv.data_ptr(), o.data_ptr(), m.data_ptr(),
            cat.data_ptr(), cm.ptr(h), u.data_ptr(), z.data_ptr(),
            out.data_ptr(), b * k2, tok, c, f, EPS,
            cm.stream_handle(x.device))
        cm.raise_on_error(_FFN_LAYER, rc)
        cm.LAUNCHES["window_attention_ffn_layer"] += 1
        if keep:
            ctx.save_for_backward(
                x, t, mask, *(params[i] for i in _FFN_LAYER_BWD_READS), qkv,
                o, m, cat, h, u, z)
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
        f = saved[4].shape[1]
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
        cat, u = _buffers(x, (2 * c, f))
        out = torch.empty_like(x)
        rc = library().emip_window_block(
            x.data_ptr(), t.data_ptr(), *(p.data_ptr() for p in params),
            cm.ptr(mask), k2, qkv1.data_ptr(), qkv2.data_ptr(),
            o1.data_ptr(), o2.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            cat.data_ptr(), cm.ptr(h), u.data_ptr(), z.data_ptr(),
            out.data_ptr(), b * k2, tok, c, f, EPS,
            cm.stream_handle(x.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["window_attention_block"] += 1
        if keep:
            ctx.save_for_backward(x, t, mask,
                                  *(params[i] for i in _BWD_READS), qkv1,
                                  qkv2, o1, o2, m1, m2, cat, h, u, z)
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
        f = saved[7].shape[1]
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


def fused_window_attention_block(x: torch.Tensor, t: torch.Tensor,
                                 self_params: dict, cross_params: dict,
                                 mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Self + cross attention + concat-FFN block per window.

    x, t: [B, K2, T, C] pre-split (and, if shifted, pre-rolled) windows;
    mask: [K2, T, T] additive shift mask or None, applied to both layers.
    Differentiable in x, t and every parameter (not in the mask).
    """
    params = [self_params[k] for k in _SELF_KEYS] + [
        cross_params[k] for k in _CROSS_KEYS]
    return _WindowBlock.apply(x, t, mask, cm.grad_wanted(x, t, *params),
                              *params)


def fused_window_attention_layer(x: torch.Tensor, t: torch.Tensor,
                                 params: dict,
                                 mask: torch.Tensor | None = None,
                                 add_residual: bool = True) -> torch.Tensor:
    """One attention layer per window: q from ``x``, k and v from ``t``.

    x, t: [B, K2, T, C] pre-split (and, if shifted, pre-rolled) windows of
    any token count T; mask: [K2, T, T] additive shift mask or None.
    Returns ``LN1(attention Wm)``, plus ``x`` with ``add_residual``.
    Differentiable in x, t and every parameter (not in the mask).
    """
    flat = [params[k] for k in _SELF_KEYS]
    return _WindowLayer.apply(x, t, mask, cm.grad_wanted(x, t, *flat),
                              bool(add_residual), *flat)


def fused_window_attention_ffn_layer(x: torch.Tensor, t: torch.Tensor,
                                     params: dict,
                                     mask: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Cross-attention + concat-FFN layer per window.

    Shapes as :func:`fused_window_attention_layer`; ``params`` also holds
    w0 [F, 2C], w2 [C, F], s2, b2. Returns
    ``x + LN2(gelu([x, msg] W0) W2)`` with ``msg`` the attention message.
    """
    flat = [params[k] for k in _CROSS_KEYS]
    return _WindowFFNLayer.apply(x, t, mask, cm.grad_wanted(x, t, *flat),
                                 *flat)
