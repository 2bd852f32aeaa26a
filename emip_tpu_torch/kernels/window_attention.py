"""Kernel B: one whole GMFlow swin TransformerBlock per window, forward and
backward.

Port of :func:`emip_tpu.ops.pallas.window_attention.
fused_window_attention_block`; the CUDA source is
``csrc/window_attention.cu``. Projection weights are in torch
``nn.Linear`` layout ([out, in]): ``self_params`` holds wq, wk, wv, wm
[C, C] and the LayerNorm s1, b1 [C]; ``cross_params`` holds the same plus
w0 [F, 2C], w2 [C, F] and s2, b2 [C]. :func:`fused_window_attention_block`
is one ``torch.autograd.Function``: CPU tensors take the plain version
(and its autograd backward), CUDA tensors the forward and backward
kernels, which compute only the grads that are asked for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_window_attention_block",
           "fused_window_attention_block_reference"]

_NAME = "fused_window_attention_block"
EPS = 1e-6  # flax LayerNorm epsilon, as in the JAX kernel
_WIDTHS = (128,)  # GMFlow width = pvt_v2_b5's /8 width
_SELF_KEYS = ("wq", "wk", "wv", "wm", "s1", "b1")
_CROSS_KEYS = _SELF_KEYS + ("w0", "w2", "s2", "b2")
# the parameters the backward kernel reads (biases of LayerNorms are not)
_BWD_READS = (0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14)


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


def fused_window_attention_block_reference(x, t, self_params, cross_params,
                                           mask=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_window_attention_block`."""
    c = x.shape[-1]
    x1 = x + _message(x, x, self_params, mask)
    msg = _message(x1, t, cross_params, mask)
    u = F.gelu(F.linear(torch.cat([x1, msg], dim=-1), cross_params["w0"]))
    z = F.linear(u, cross_params["w2"])
    return x1 + F.layer_norm(z, (c,), cross_params["s2"], cross_params["b2"],
                             EPS)


def _reference_flat(x, t, *rest):
    *params, mask = rest
    return fused_window_attention_block_reference(
        x, t, dict(zip(_SELF_KEYS, params[:6])),
        dict(zip(_CROSS_KEYS, params[6:])), mask)


def _check(x, t, params, mask) -> None:
    sp = dict(zip(_SELF_KEYS, params[:6]))
    cp = dict(zip(_CROSS_KEYS, params[6:]))
    cm.check_kernel_args(_NAME, x=x, t=t,
                         **{f"self_{k}": v for k, v in sp.items()},
                         **{f"cross_{k}": v for k, v in cp.items()})
    if x.dim() != 4:
        raise ValueError(f"{_NAME}: x must be [B, K2, T, C]")
    _, k2, tok, c = x.shape
    if c not in _WIDTHS:
        raise ValueError(f"{_NAME}: channel width {c} not in {_WIDTHS}")
    f = cp["w0"].shape[0]
    cm.check_shape(_NAME, "t", t, x.shape)
    for p in (sp, cp):
        for key in ("wq", "wk", "wv", "wm"):
            cm.check_shape(_NAME, key, p[key], (c, c))
        for key in ("s1", "b1"):
            cm.check_shape(_NAME, key, p[key], (c,))
    cm.check_shape(_NAME, "w0", cp["w0"], (f, 2 * c))
    cm.check_shape(_NAME, "w2", cp["w2"], (c, f))
    cm.check_shape(_NAME, "s2", cp["s2"], (c,))
    cm.check_shape(_NAME, "b2", cp["b2"], (c,))
    if mask is not None:
        cm.check_kernel_args(_NAME, mask=mask)
        cm.check_shape(_NAME, "mask", mask, (k2, tok, tok))


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
        rows = b * k2 * tok
        opts = dict(device=x.device, dtype=x.dtype)

        def buf(width):
            return torch.empty((rows, width), **opts)

        if keep:  # separate buffers per layer: what the backward reads
            qkv1, qkv2, o1, o2, m1, m2 = (buf(3 * c), buf(3 * c), buf(c),
                                          buf(c), buf(c), buf(c))
            h, z = buf(f), buf(c)
        else:  # one buffer per kind, reused by both layers
            qkv1 = qkv2 = buf(3 * c)
            o1 = o2 = buf(c)
            m1 = m2 = z = buf(c)
            h = None
        cat, u, out = buf(2 * c), buf(f), torch.empty_like(x)
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
        shapes = [(c, c)] * 4 + [(c,)] * 2 + [(c, c)] * 4 + [(c,)] * 2 + [
            (f, 2 * c), (c, f), (c,), (c,)]
        pgrads = [torch.empty(s, device=x.device, dtype=x.dtype) if nd
                  else None for nd, s in zip(needs_p, shapes)]
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
