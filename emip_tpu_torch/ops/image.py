"""Image resizing and normalization (counterpart of :mod:`emip_tpu.ops.image`).

The JAX package writes its resizes as separable matmuls for the TPU's
matrix unit; here they are ``F.interpolate`` in the modes those matmuls
emulate. Layout is NCHW. The host-side resize of variable-shape maps
(logits to a GT's native size, a prediction to its GT's size) is numpy:
:func:`linear_weights_np` and :func:`resize_bilinear_np`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "resize_bilinear_antialias", "resize_area", "resize_nearest",
           "normalize_imagenet", "linear_weights_np", "resize_bilinear_np",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw``."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def resize_bilinear_antialias(x: torch.Tensor, out_hw: tuple[int, int]
                              ) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor that low-pass filters where it
    shrinks: ``jax.image.resize(..., "bilinear")``, whose ``antialias`` is
    on by default (a triangle kernel widened by the shrink factor, its
    weights normalised). ``F.interpolate`` filters so only with
    ``antialias=True``."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=True)


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


@functools.lru_cache(maxsize=64)
def linear_weights_np(in_size: int, out_size: int,
                      align_corners: bool = False) -> np.ndarray:
    """[out, in] float32 matrix of 1-D linear resampling (torch's rule for
    either ``align_corners``). Cached: callers must not write to it."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = (np.arange(out_size, dtype=np.float64) * (in_size - 1)
                   / (out_size - 1))
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (
            in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w


def resize_bilinear_np(x: np.ndarray, out_hw: tuple[int, int],
                       align_corners: bool = False) -> np.ndarray:
    """Bilinear resize of a [H, W] or [H, W, C] numpy array, in float32
    (counterpart of :func:`emip_tpu.ops.image.resize_bilinear_np`)."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    wh = linear_weights_np(x.shape[0], int(out_hw[0]), align_corners)
    ww = linear_weights_np(x.shape[1], int(out_hw[1]), align_corners)
    out = np.einsum("ph,hwc->pwc", wh, x.astype(np.float32))
    out = np.einsum("qw,pwc->pqc", ww, out)
    return out[..., 0] if squeeze else out
