"""The forward attentions of kernels A, B, C, G and H, called alone.

On the model's paths the attention runs inside the entry points of
``csrc/sr_attention.cu`` (A), ``csrc/window_attention.cu`` (B, G, H) and
``csrc/flow_attention.cu`` (C); :func:`attention` exposes the fp32 device
code (``attention_fwd_tc`` of ``csrc/mma_tf32.cuh`` at the tilings of
``csrc/attention.cu``) and :func:`attention_bf16` the bf16 one of C, G and
B's self layer (``csrc/attention_bf16.cu``), so that ``chip_smoke.py`` and
the ``cuda`` tests can hold them against the fp64 product and time them
beside ``scaled_dot_product_attention`` at the shapes those kernels give
them. CPU tensors take the plain versions.
"""

from __future__ import annotations

import functools

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["attention", "attention_reference", "attention_bf16",
           "attention_bf16_reference", "forward_workspace",
           "mask_zero_tiles", "mask_rows16"]

_NAME = "attention"
_WIDTHS = {False: (32, 64), True: (64, 128)}  # A's heads; the windows'


def _heads(x, heads: int):
    """[B, N, H * W] -> [B, H, N, W]."""
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2)


def _scores(q, k, heads, mask):
    qh, kh = _heads(q, heads), _heads(k, heads)
    s = qh @ kh.transpose(-1, -2) / qh.shape[-1] ** 0.5
    if mask is not None:
        windows = torch.arange(q.shape[0], device=mask.device) % mask.shape[0]
        s = s + mask[windows][:, None]
    return s


def attention_reference(q, k, v, heads: int = 1, mask=None,
                        keep_stats: bool = False):
    """Plain PyTorch version of :func:`attention`."""
    s = _scores(q, k, heads, mask)
    out = torch.softmax(s, -1) @ _heads(v, heads)
    out = out.transpose(1, 2).reshape(q.shape[0], q.shape[1], -1)
    if not keep_stats:
        return out
    row_max = s.max(-1).values
    row_sum = torch.exp(s - row_max[..., None]).sum(-1)
    return out, torch.stack([row_max, row_sum]).reshape(2, -1, q.shape[1])


def _check(q, k, v, heads, mask, windows) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{_NAME}: {name} must be float32")
        if t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"{_NAME}: {name} must be [B, N, H * D] with "
                             f"unit stride along the last axis")
    b, nq, c = q.shape
    nk = k.shape[1]
    if c % heads or c // heads not in _WIDTHS[windows]:
        raise ValueError(f"{_NAME}: head width {c}/{heads} not in "
                         f"{_WIDTHS[windows]}")
    cm.check_shape(_NAME, "k", k, (b, nk, c))
    cm.check_shape(_NAME, "v", v, (b, nk, c))
    if windows and (heads != 1 or nq != nk):
        raise ValueError(f"{_NAME}: windows take one head and Nq == Nk")
    if mask is not None:
        if not windows:
            raise ValueError(f"{_NAME}: only the window kernels take a mask")
        cm.check_kernel_args(_NAME, mask=mask)
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (nq, nk):
            raise ValueError(f"{_NAME}: mask must be [nw, {nq}, {nk}]")


def forward_workspace(device: torch.device, b: int, heads: int, nq: int,
                      nk: int, width: int,
                      windows: bool) -> torch.Tensor | None:
    """Scratch for the key-split partials of the forward attention over
    ``b`` batch rows of ``heads`` heads of ``width`` (A's instantiation, or
    with ``windows`` that of B, G and H): as much as its key splits take at
    this shape, or None where it takes one split."""
    floats = _workspace_floats(b, heads, nq, nk, width, windows)
    return (torch.empty(floats, device=device, dtype=torch.float32)
            if floats else None)


@functools.lru_cache(maxsize=None)
def _workspace_floats(b, heads, nq, nk, width, windows) -> int:
    floats = library().emip_attention_fwd_workspace(b, heads, nq, nk, width,
                                                    int(windows))
    if floats < 0:
        raise ValueError(f"{_NAME}: no instantiation for width {width} "
                         f"(windows={windows})")
    return floats


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int = 1, mask: torch.Tensor | None = None,
              windows: bool = False, keep_stats: bool = False):
    """``softmax(q_h k_h^T / sqrt(D) (+ mask)) v_h`` per head -> [B, Nq, H * D].

    q: [B, Nq, H * D]; k, v: [B, Nk, H * D], each with unit stride along
    the last axis (views into one [k | v] buffer are read in place).
    ``windows`` runs the window kernels' instantiation (B, G, H: D 128 or
    64, one head, Nq == Nk, ``mask`` [nw, Nq, Nk] or None with batch row b
    reading mask[b % nw]); otherwise kernel A's (D 64 or 32, no mask). With
    ``keep_stats`` also the row max and row sum, [2, B * H, Nq], that a
    forward keeps for the backward. Not differentiable: a check of the
    kernels' attention, not a layer.
    """
    tensors = [q, k, v] + ([] if mask is None else [mask])
    if cm.on_cpu(_NAME, *tensors):
        return attention_reference(q, k, v, heads, mask, keep_stats)
    _check(q, k, v, heads, mask, windows)
    b, nq, c = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    stats = (torch.empty((2, b * heads, nq), device=q.device,
                         dtype=q.dtype) if keep_stats else None)
    ws = forward_workspace(q.device, b, heads, nq, nk, c // heads, windows)
    rc = library().emip_attention_fwd(
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0),
        k.stride(1), v.data_ptr(), v.stride(0), v.stride(1), cm.ptr(mask),
        1 if mask is None else mask.shape[0], out.data_ptr(), nq * c, c,
        cm.ptr(stats), cm.ptr(ws), cm.numel(ws), b, heads, nq, nk,
        c // heads, int(windows), cm.stream_handle(q.device))
    cm.raise_on_error(_NAME, rc)
    cm.LAUNCHES["attention"] += 1
    return (out, stats) if keep_stats else out


def attention_bf16_reference(q, k, v, mask=None):
    """Plain PyTorch version of :func:`attention_bf16`: the scores of the
    bf16 q and k in fp32 and their softmax in fp32; with bf16 v (B, G) the
    normalised P rounded to bf16, P v summed in fp32 and rounded to bf16,
    with fp32 v (C) P v in fp32."""
    s = q.float() @ k.float().transpose(-1, -2) / q.shape[-1] ** 0.5
    if mask is not None:
        windows = torch.arange(q.shape[0], device=mask.device) % mask.shape[0]
        s = s + mask[windows].float()
    p = torch.softmax(s, -1)
    if v.dtype == torch.bfloat16:
        return (p.to(torch.bfloat16).float() @ v.float()).to(torch.bfloat16)
    return p @ v.float()


def mask_zero_tiles(mask: torch.Tensor | None) -> torch.Tensor | None:
    """uint8 [nw, ceil(Nq / 128), ceil(Nk / 64)] for a mask [nw, Nq, Nk]
    (None for None): 1
    where the mask's tile of 128 query rows (a block of the bf16 attention)
    by 64 keys (a key tile) is all zero. The kernel neither loads nor adds
    such a tile; adding +0 changes no score, so the bits are the same.
    Made on the mask's device once and kept beside the mask until it
    changes (in place, or by moving), as :func:`emip_tpu_torch.dtypes.cast`
    keeps a weight's cast: the model's shift masks are made once per shape
    (:func:`emip_tpu_torch.ops.window.shifted_window_mask`)."""
    if mask is None:
        return None
    key = (mask.device, mask.data_ptr(),
           None if mask.is_inference() else mask._version)
    kept = getattr(mask, "_emip_zero_tiles", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    nw, nq, nk = mask.shape
    with torch.no_grad():
        tiles = torch.nn.functional.pad(
            mask, (0, -nk % 64, 0, -nq % 128)).view(
                nw, -(-nq // 128), 128, -(-nk // 64), 64)
        out = (tiles == 0).all(4).all(2).to(torch.uint8)
    mask._emip_zero_tiles = (key, out)
    return out


def mask_rows16(mask: torch.Tensor | None) -> tuple:
    """(mask, row stride in elements) as the bf16 attention reads it: its
    rows are TMA boxes, whose strides are whole 16 bytes. The mask itself
    where Nk is a multiple of 4; else a copy [nw, Nq, Nk rounded up to 4]
    with zeros past Nk (which the kernel reads as keys past Nk, set to
    -inf), made once and kept beside the mask as :func:`mask_zero_tiles`
    keeps its table: B's windows of 121 tokens (the fine scale of
    multi-scale GMFlow) take it. (None, 0) for None."""
    if mask is None:
        return None, 0
    nk = mask.shape[-1]
    if nk % 4 == 0:
        return mask, nk
    key = (mask.device, mask.data_ptr(),
           None if mask.is_inference() else mask._version)
    kept = getattr(mask, "_emip_rows16", None)
    if kept is None or kept[0] != key:
        with torch.no_grad():
            rows = torch.nn.functional.pad(mask, (0, -nk % 4)).contiguous()
        kept = (key, rows)
        mask._emip_rows16 = kept
    return kept[1], kept[1].shape[-1]


def attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D) (+ mask)) v`` per batch row, the bf16
    attention of C, G and B's self layer.

    q, k: [B, N, D] bf16 (D 128 or 64), unit stride along the last axis
    (views into one qkv buffer are read in place). v [B, Nk, D] bf16 with
    Nq == Nk (the windows of B and G; ``mask`` [nw, Nq, Nk] fp32 or None,
    batch row b reading mask[b % nw]) -> bf16 [B, Nq, D]; or v [B, Nk, 2]
    fp32 (C; no mask) -> fp32 [B, Nq, 2]. Not differentiable: a check of
    the kernels' attention, not a layer.

    Limits on the card (the kernel reads q, k, bf16 v and the mask as TMA
    boxes, whose strides are whole 16 bytes): the row and batch strides of
    q, k and v a multiple of 8 elements. A mask whose Nk is no multiple of
    4 is read from a copy with its rows padded (:func:`mask_rows16`). C's
    v is read a key at a time, so its Nk has no bound. A launch outside
    these raises.
    """
    tensors = [q, k, v] + ([] if mask is None else [mask])
    if cm.on_cpu(_NAME, *tensors):
        return attention_bf16_reference(q, k, v, mask)
    name = _NAME + " (bf16)"
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"{name}: {n} must be [B, N, D] with unit "
                             f"stride along the last axis")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"{name}: q and k must be bfloat16")
    b, nq, d = q.shape
    nk = k.shape[1]
    wide = v.dtype == torch.bfloat16
    if d not in _WIDTHS[True]:
        raise ValueError(f"{name}: width {d} not in {_WIDTHS[True]}")
    cm.check_shape(name, "k", k, (b, nk, d))
    cm.check_shape(name, "v", v, (b, nk, d if wide else 2))
    if not wide and (v.dtype != torch.float32 or mask is not None):
        raise ValueError(f"{name}: a 2-wide v is fp32 and takes no mask")
    if wide and nq != nk:
        raise ValueError(f"{name}: windows take Nq == Nk")
    if mask is not None:
        cm.check_kernel_args(name, mask=mask)
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (nq, nk):
            raise ValueError(f"{name}: mask must be [nw, {nq}, {nk}]")
    out = torch.empty((b, nq, d if wide else 2), device=q.device,
                      dtype=v.dtype)
    mask16, mask_sn = mask_rows16(mask)
    rc = library().emip_attention_fwd_bf16(
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), k.stride(0),
        k.stride(1), v.data_ptr(), v.stride(0), v.stride(1), cm.ptr(mask16),
        mask_sn, 1 if mask is None else mask.shape[0],
        cm.ptr(mask_zero_tiles(mask)), out.data_ptr(), out.stride(0),
        out.stride(1), b, nq, nk, d, v.shape[-1], int(wide),
        cm.stream_handle(q.device))
    cm.raise_on_error(name, rc)
    cm.LAUNCHES["attention_bf16"] += 1
    return out
