"""Kernel E: forward bilinear splat density.

Port of :func:`emip_tpu.ops.pallas.splat.splat_density_pallas`; the CUDA
source is ``csrc/splat.cu``. Forward only: its one consumer thresholds the
density into the occlusion mask, which carries no gradient
(:func:`emip_tpu_torch.ops.warp.occlusion_mask_backward`).
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["splat_density", "splat_density_reference"]

_NAME = "splat_density"


def splat_density_reference(coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`splat_density`: a ``scatter_add_``
    of the four bilinear corners, out-of-range corners dropped."""
    n, h, w, _ = coords.shape
    x = coords[..., 0].reshape(n, -1).float()
    y = coords[..., 1].reshape(n, -1).float()
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    out = torch.zeros((n, h * w), dtype=torch.float32, device=coords.device)
    for cx, cy, wt in ((x0, y0, (1 - wx1) * (1 - wy1)),
                       (x0 + 1, y0, wx1 * (1 - wy1)),
                       (x0, y0 + 1, (1 - wx1) * wy1),
                       (x0 + 1, y0 + 1, wx1 * wy1)):
        valid = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
        out.scatter_add_(1, idx, torch.where(valid, wt, torch.zeros_like(wt)))
    return out.reshape(n, h, w)


def splat_density(coords: torch.Tensor) -> torch.Tensor:
    """coords [N, H, W, 2] of (x, y) targets -> [N, H, W] fp32 density."""
    if cm.on_cpu(_NAME, coords):
        return splat_density_reference(coords)
    cm.check_kernel_args(_NAME, coords=coords)
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"{_NAME}: coords must be [N, H, W, 2]")
    n, h, w, _ = coords.shape
    out = torch.empty((n, h, w), device=coords.device, dtype=torch.float32)
    rc = library().emip_splat_density(coords.data_ptr(), out.data_ptr(), n,
                                      h, w, cm.stream_handle(coords.device))
    cm.raise_on_error(_NAME, rc)
    cm.LAUNCHES["splat_density"] += 1
    return out
