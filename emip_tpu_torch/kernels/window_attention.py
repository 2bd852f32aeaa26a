"""Kernel B: one whole GMFlow swin TransformerBlock per window (forward).

Port of :func:`emip_tpu.ops.pallas.window_attention.
fused_window_attention_block`; the CUDA source is
``csrc/window_attention.cu``. Projection weights are in torch
``nn.Linear`` layout ([out, in]): ``self_params`` holds wq, wk, wv, wm
[C, C] and the LayerNorm s1, b1 [C]; ``cross_params`` holds the same plus
w0 [F, 2C], w2 [C, F] and s2, b2 [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_window_attention_block",
           "fused_window_attention_block_reference"]

EPS = 1e-6  # flax LayerNorm epsilon, as in the JAX kernel
_WIDTHS = (128,)  # GMFlow width = pvt_v2_b5's /8 width
_SELF_KEYS = ("wq", "wk", "wv", "wm", "s1", "b1")
_CROSS_KEYS = _SELF_KEYS + ("w0", "w2", "s2", "b2")


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


def fused_window_attention_block(x: torch.Tensor, t: torch.Tensor,
                                 self_params: dict, cross_params: dict,
                                 mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Self + cross attention + concat-FFN block per window.

    x, t: [B, K2, T, C] pre-split (and, if shifted, pre-rolled) windows;
    mask: [K2, T, T] additive shift mask or None, applied to both layers.
    """
    name = "fused_window_attention_block"
    sp = {k: self_params[k] for k in _SELF_KEYS}
    cp = {k: cross_params[k] for k in _CROSS_KEYS}
    tensors = [x, t, *sp.values(), *cp.values()]
    if mask is not None:
        tensors.append(mask)
    if cm.on_cpu(name, *tensors):
        return fused_window_attention_block_reference(x, t, sp, cp, mask)
    cm.check_kernel_args(name, x=x, t=t,
                         **{f"self_{k}": v for k, v in sp.items()},
                         **{f"cross_{k}": v for k, v in cp.items()})
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, K2, T, C]")
    b, k2, tok, c = x.shape
    if c not in _WIDTHS:
        raise ValueError(f"{name}: channel width {c} not in {_WIDTHS}")
    f = cp["w0"].shape[0]
    cm.check_shape(name, "t", t, x.shape)
    for p in (sp, cp):
        for key in ("wq", "wk", "wv", "wm"):
            cm.check_shape(name, key, p[key], (c, c))
        for key in ("s1", "b1"):
            cm.check_shape(name, key, p[key], (c,))
    cm.check_shape(name, "w0", cp["w0"], (f, 2 * c))
    cm.check_shape(name, "w2", cp["w2"], (c, f))
    cm.check_shape(name, "s2", cp["s2"], (c,))
    cm.check_shape(name, "b2", cp["b2"], (c,))
    mask_ptr = 0
    if mask is not None:
        cm.check_kernel_args(name, mask=mask)
        cm.check_shape(name, "mask", mask, (k2, tok, tok))
        mask_ptr = mask.data_ptr()

    lib = library()
    rows = b * k2 * tok
    opts = dict(device=x.device, dtype=x.dtype)
    qkv = torch.empty((rows, 3 * c), **opts)
    o = torch.empty((rows, c), **opts)
    m = torch.empty((rows, c), **opts)
    cat = torch.empty((rows, 2 * c), **opts)
    u = torch.empty((rows, f), **opts)
    out = torch.empty_like(x)
    rc = lib.emip_window_block(
        x.data_ptr(), t.data_ptr(),
        *(sp[k].data_ptr() for k in _SELF_KEYS),
        *(cp[k].data_ptr() for k in _CROSS_KEYS),
        mask_ptr, k2,
        qkv.data_ptr(), o.data_ptr(), m.data_ptr(), cat.data_ptr(),
        u.data_ptr(), out.data_ptr(),
        b * k2, tok, c, f, EPS, cm.stream_handle(x.device))
    cm.raise_on_error(name, rc)
    cm.LAUNCHES["window_attention_block"] += 1
    return out
