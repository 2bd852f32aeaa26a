"""Padding and mask-overlay helpers of the long-model pipeline.

Counterparts of :mod:`emip_tpu.utils.overlay` (the reference's
``model/EMIP_long/helpers.py:33-77``): :func:`pad_divide_by` pads NCHW
tensors up to a multiple of ``d`` (centred, with ``F.pad``'s (lw, uw, lh,
uh) convention) for frames at native resolution, and :func:`overlay_davis`
renders a DAVIS-style coloured mask overlay with its contours (host
numpy).
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

__all__ = ["pad_divide_by", "overlay_davis"]


def pad_divide_by(tensors, d: int, in_size: tuple[int, int]):
    """Zero-pad NCHW ``tensors`` so H and W are multiples of ``d``.

    Returns (padded list, (lw, uw, lh, uh)), the pad tuple of the
    reference, from which a caller crops back.
    """
    h, w = in_size
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh, uh = (new_h - h) // 2, (new_h - h) - (new_h - h) // 2
    lw, uw = (new_w - w) // 2, (new_w - w) - (new_w - w) // 2
    pad = (lw, uw, lh, uh)
    return [F.pad(t, pad) for t in tensors], pad


def _binary_dilation_cross(mask: np.ndarray) -> np.ndarray:
    """Binary dilation by the 3x3 cross (scipy's default element)."""
    m = mask.astype(bool)
    out = m.copy()
    out[1:, :] |= m[:-1, :]
    out[:-1, :] |= m[1:, :]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    return out


def overlay_davis(image: np.ndarray, mask: np.ndarray,
                  colors=(255, 0, 0), cscale: int = 2,
                  alpha: float = 0.4) -> np.ndarray:
    """DAVIS-style overlay (reference helpers.py:54-77): ``image`` [H, W,
    3], ``mask`` [H, W] of object ids (0 is background); each object's
    pixels blended with its colour, its one-pixel outer contour black."""
    colors = np.atleast_2d(np.reshape(colors, (-1, 3))) * cscale
    im_overlay = image.copy()
    for object_id in np.unique(mask)[1:]:
        color = colors[int(object_id) % len(colors)]
        foreground = image * alpha + np.ones(image.shape) * (1 - alpha) * color
        binary_mask = mask == object_id
        im_overlay[binary_mask] = foreground[binary_mask]
        contours = _binary_dilation_cross(binary_mask) ^ binary_mask
        im_overlay[contours, :] = 0
    return im_overlay.astype(image.dtype)
