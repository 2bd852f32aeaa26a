"""Bilinear flow upsampling (counterpart of
:func:`emip_tpu.ops.upsample.upsample_flow_bilinear`).

The convex upsampler is kernel D (:mod:`emip_tpu_torch.kernels`). Layout
is NHWC, flow last axis (x, y).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["upsample_flow_bilinear"]


def upsample_flow_bilinear(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear (align_corners=True) x ``factor`` upsample of a flow
    [B, h, w, 2], values scaled by ``factor``."""
    _, h, w, _ = flow.shape
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=(h * factor, w * factor),
                       mode="bilinear", align_corners=True)
    return up.permute(0, 2, 3, 1) * factor
