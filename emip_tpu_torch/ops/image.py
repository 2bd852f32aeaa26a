"""Image resizing and normalization (counterpart of :mod:`emip_tpu.ops.image`).

The JAX package writes its resizes as separable matmuls for the TPU's
matrix unit; here they are ``F.interpolate`` in the modes those matmuls
emulate. Layout is NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "resize_area", "resize_nearest",
           "normalize_imagenet", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw``."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def resize_area(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Area (adaptive-average) resize of an NCHW tensor."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="area")


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor (source floor(i*in/out))."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="nearest")


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """Normalize [0, 1] RGB NCHW images by ImageNet statistics."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]
