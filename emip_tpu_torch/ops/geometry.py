"""Pixel grids and differentiable warping (counterpart of
:mod:`emip_tpu.ops.geometry`).

Layout is the JAX package's: NHWC images, flow fields [N, H, W, 2] with
the last axis (x, y) in pixels. ``bilinear_sample`` is torch's
``grid_sample(align_corners=True)`` after normalising the pixel
coordinates, as in the reference; the JAX package's corner-packed gather
is a TPU layout trick and is not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["coords_grid", "bilinear_sample", "flow_warp"]


def coords_grid(h: int, w: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """[H, W, 2] pixel-coordinate grid, last axis = (x, y)."""
    y = torch.arange(h, device=device, dtype=dtype)
    x = torch.arange(w, device=device, dtype=dtype)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """Sample NHWC ``img`` at pixel ``coords`` [N, H', W', 2] (x, y).

    Bilinear with align_corners=True: x in [0, W-1] and y in [0, H-1] are
    inside; ``padding_mode`` is 'zeros' or 'border'.
    """
    _, h, w, _ = img.shape
    grid = torch.stack([coords[..., 0] * (2.0 / (w - 1)) - 1.0,
                        coords[..., 1] * (2.0 / (h - 1)) - 1.0], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def flow_warp(feature: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Backward-warp NHWC ``feature`` by flow [N, H, W, 2] (x, y) in pixels."""
    _, h, w, _ = feature.shape
    grid = coords_grid(h, w, device=flow.device, dtype=flow.dtype)[None]
    return bilinear_sample(feature, grid + flow, padding_mode)
