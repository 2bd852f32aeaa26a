"""Pixel-coordinate grids (counterpart of :mod:`emip_tpu.ops.geometry`).

Only ``coords_grid`` is on the ported path: ``flow_warp`` is not reached
at ``num_scales = 1``.
"""

from __future__ import annotations

import torch

__all__ = ["coords_grid"]


def coords_grid(h: int, w: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """[H, W, 2] pixel-coordinate grid, last axis = (x, y)."""
    y = torch.arange(h, device=device, dtype=dtype)
    x = torch.arange(w, device=device, dtype=dtype)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)
