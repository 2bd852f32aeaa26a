"""Global correlation matching: flow as a softmax expectation.

Counterpart of :mod:`emip_tpu.models.gmflow.matching`. The one
materialised correlation volume is the motion prompt's input, a plain
large product outside any kernel (``torch.matmul``). The expectation over
the pixel grid takes one of two paths, as in the JAX package:

- ``qk_fused`` (the default, flash matching): kernel C
  (:func:`emip_tpu_torch.kernels.fused_flow_attention`) recomputes the
  q k^T correlation inside, so the expectation reads no [B, HW, HW] array;
- otherwise (read-corr): kernel I
  (:func:`emip_tpu_torch.kernels.softmax_expectation`) reads the stored
  volume, and for the backward flow a contiguous transpose of it (one more
  read and write of the volume by ``torch``; the kernel reads rows only).
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import fused_flow_attention, softmax_expectation
from emip_tpu_torch.ops.geometry import coords_grid

__all__ = ["global_correlation_softmax"]


def global_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor,
                               pred_bidir_flow: bool = False,
                               qk_fused: bool = True):
    """feature0, feature1: [B, H, W, C] (channel-last, as in the JAX code).

    Returns (flow [B', H, W, 2], corr [B, H, W, HW]) with B' = 2B when
    bidirectional (forward then backward stacked on the batch axis).
    """
    b, h, w, c = feature0.shape
    f0 = feature0.reshape(b, h * w, c).contiguous()
    f1 = feature1.reshape(b, h * w, c).contiguous()
    corr = torch.matmul(f0, f1.transpose(1, 2)) / c**0.5  # [B, HW, HW]
    grid = coords_grid(h, w, device=f0.device).reshape(h * w, 2)
    if qk_fused:
        gridb = grid.expand(b, h * w, 2).contiguous()
        corres = [fused_flow_attention(f0, f1, gridb)]
        if pred_bidir_flow:
            corres.append(fused_flow_attention(f1, f0, gridb))
    else:
        corres = [softmax_expectation(corr, grid)]
        if pred_bidir_flow:
            corres.append(softmax_expectation(
                corr.transpose(1, 2).contiguous(), grid))
    flow = (torch.cat(corres, 0) - grid).reshape(-1, h, w, 2)
    return flow, corr.reshape(b, h, w, h * w)
