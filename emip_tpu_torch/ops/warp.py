"""Loss-side warping and occlusion (counterpart of :mod:`emip_tpu.ops.warp`).

NHWC layout. The occlusion mask thresholds the forward-splat density of
the backward flow, which is kernel E
(:func:`emip_tpu_torch.kernels.splat_density`) on the card.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import splat_density
from emip_tpu_torch.ops.geometry import bilinear_sample, coords_grid

__all__ = ["flow_warp_loss", "forward_splat_density",
           "occlusion_mask_backward", "occlusion_mask_bidirection"]


def flow_warp_loss(x: torch.Tensor, flow12: torch.Tensor,
                   pad: str = "border") -> torch.Tensor:
    """Backward-warp NHWC ``x`` by ``flow12`` [N, H, W, 2]; border padding
    by default (reference loss/warp_utils.py:83-93)."""
    _, h, w, _ = x.shape
    grid = coords_grid(h, w, device=flow12.device, dtype=flow12.dtype)[None]
    return bilinear_sample(x, grid + flow12, padding_mode=pad)


def forward_splat_density(coords: torch.Tensor) -> torch.Tensor:
    """[N, H, W] density of a unit mass splatted bilinearly from every
    pixel to its target ``coords`` [N, H, W, 2] (x, y); out-of-range
    corners dropped (reference loss/warp_utils.py:26-80)."""
    return splat_density(coords.contiguous())


def occlusion_mask_backward(flow21: torch.Tensor,
                            th: float = 0.2) -> torch.Tensor:
    """Occlusion mask from backward-flow splat density (< th => occluded).

    Returns float [N, H, W, 1]; it carries no gradient (a hard threshold),
    so the density is computed from the detached flow.
    """
    _, h, w, _ = flow21.shape
    grid = coords_grid(h, w, device=flow21.device, dtype=flow21.dtype)[None]
    density = forward_splat_density(grid + flow21.detach())
    return (torch.clamp(density, 0.0, 1.0) < th).float()[..., None]


def occlusion_mask_bidirection(flow12: torch.Tensor, flow21: torch.Tensor,
                               scale: float = 0.01,
                               bias: float = 0.5) -> torch.Tensor:
    """Forward-backward consistency occlusion mask, float [N, H, W, 1]:
    occluded where |flow12 + warped flow21|^2 > scale * (|flow12|^2 +
    |warped flow21|^2) + bias (reference loss/warp_utils.py:96-103)."""
    flow21_warped = flow_warp_loss(flow21, flow12, pad="zeros")
    diff = flow12 + flow21_warped
    mag = ((flow12 * flow12).sum(-1, keepdim=True)
           + (flow21_warped * flow21_warped).sum(-1, keepdim=True))
    occ = (diff * diff).sum(-1, keepdim=True) > scale * mag + bias
    return occ.float()
