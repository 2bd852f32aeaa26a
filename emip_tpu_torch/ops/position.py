"""Sine/cosine 2-D position embedding (DETR convention).

Counterpart of :mod:`emip_tpu.ops.position`: a static function of
(h, w, channels), computed once with numpy. Layout [H, W, C]; the first
half of the channels embeds y, the second half x.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["sine_position_embedding"]


@functools.lru_cache(maxsize=None)
def _sine_position_np(h: int, w: int, num_pos_feats: int, temperature: float,
                      normalize: bool) -> np.ndarray:
    scale = 2.0 * math.pi
    y_embed = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x_embed = np.ones((h, 1)) * np.arange(1, w + 1, dtype=np.float64)[None, :]
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=2).astype(np.float32)


def sine_position_embedding(h: int, w: int, channels: int,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            device=None) -> torch.Tensor:
    """[H, W, channels] sine position embedding (channels must be even)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    return torch.from_numpy(
        _sine_position_np(h, w, channels // 2, temperature, normalize)
    ).to(device)
