"""Swin-style window partitioning and the shifted-window additive mask.

Counterpart of :mod:`emip_tpu.ops.window`. Tensors are channel-last
([B, H, W, C]) exactly as in the JAX package, because the window kernel
takes the window-token layout [B, K*K, T, C].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "window_split",
    "window_merge",
    "window_split_tokens",
    "window_merge_tokens",
    "shifted_window_mask",
]


def window_split(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*K*K, H/K, W/K, C], row-major window order."""
    b, h, w, c = x.shape
    k = num_splits
    hs, ws = h // k, w // k
    x = x.reshape(b, k, hs, k, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, hs, ws, c)


def window_merge(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """Inverse of :func:`window_split`: [B*K*K, h, w, C] -> [B, K*h, K*w, C]."""
    bkk, hs, ws, c = x.shape
    k = num_splits
    b = bkk // (k * k)
    x = x.reshape(b, k, k, hs, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, k * hs, k * ws, c)


def window_split_tokens(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, K*K, T, C] window-token layout (contiguous)."""
    b, h, w, c = x.shape
    k = num_splits
    hs, ws = h // k, w // k
    x = x.reshape(b, k, hs, k, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, k * k, hs * ws, c).contiguous()


def window_merge_tokens(x: torch.Tensor, num_splits: int, h: int,
                        w: int) -> torch.Tensor:
    """Inverse of :func:`window_split_tokens`."""
    b, _, _, c = x.shape
    k = num_splits
    hs, ws = h // k, w // k
    x = x.reshape(b, k, k, hs, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def _shifted_window_mask_np(h: int, w: int, num_splits: int) -> np.ndarray:
    win_h, win_w = h // num_splits, w // num_splits
    shift_h, shift_w = win_h // 2, win_w // 2
    region = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    h_slices = (slice(0, -win_h), slice(-win_h, -shift_h), slice(-shift_h, None))
    w_slices = (slice(0, -win_w), slice(-win_w, -shift_w), slice(-shift_w, None))
    for hs in h_slices:
        for ws in w_slices:
            region[hs, ws] = cnt
            cnt += 1
    region = region.reshape(num_splits, win_h, num_splits, win_w)
    region = region.transpose(0, 2, 1, 3).reshape(
        num_splits * num_splits, win_h * win_w)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def shifted_window_mask(h: int, w: int, num_splits: int,
                        device=None) -> torch.Tensor:
    """Additive mask [K*K, T, T] for shifted windows (-100 across regions)."""
    return torch.from_numpy(_shifted_window_mask_np(h, w, num_splits)).to(device)
