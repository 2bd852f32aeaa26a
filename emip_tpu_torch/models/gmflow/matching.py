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

Local matching (:func:`local_correlation_softmax`, the finer scales of
multi-scale GMFlow) has no TPU kernel and is plain tensor code.

The correlation volume is fp32 whatever the features' dtype: with bf16
features (the bf16 band) it is their exact products summed in fp32, as the
JAX package's ``einsum(..., preferred_element_type=float32)``, and kernel C
takes the bf16 features with the fp32 pixel grid; under read-corr matching
kernel I reads that fp32 volume in both bands, as the JAX kernel does. The
volume's gradient reaches the bf16 features through ``.float()``, rounded
to bf16 once, where the JAX einsum's transpose rounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import fused_flow_attention, softmax_expectation
from emip_tpu_torch.ops.geometry import coords_grid

__all__ = ["global_correlation_softmax", "local_correlation_softmax"]


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
    corr = torch.matmul(f0.float(), f1.float().transpose(1, 2)) / c**0.5
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


def local_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor,
                              local_radius: int):
    """Matching within a (2R+1)^2 window around each pixel, as
    :func:`emip_tpu.models.gmflow.matching.local_correlation_softmax`.

    feature0, feature1: [B, H, W, C]. The window's sample points are
    integer offsets, so sampling feature1 there (bilinear, zeros outside)
    is an exact shifted read of it, zero-padded by R; the correlation of
    each offset is one dot product over C in fp32, divided by sqrt(C);
    offsets outside the image score -1e9. Offsets run row by row (dy, then
    dx), as JAX's window axis. Returns (flow [B, H, W, 2] fp32, prob [B, H,
    W, (2R+1)^2]): the softmax's expected sample point minus the pixel.
    """
    b, h, w, c = feature0.shape
    r = local_radius
    k = 2 * r + 1
    f0 = feature0.float()
    f1 = F.pad(feature1.float(), (0, 0, r, r, r, r))
    corr = torch.stack([(f0 * f1[:, dy:dy + h, dx:dx + w]).sum(-1)
                        for dy in range(k) for dx in range(k)],
                       dim=-1) / c**0.5  # [B, H, W, K2]
    grid = coords_grid(h, w, device=f0.device)  # [H, W, 2]
    d = torch.arange(-r, r + 1, device=f0.device, dtype=torch.float32)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    offsets = torch.stack([dx, dy], dim=-1).reshape(-1, 2)  # [K2, 2]
    sample = grid[:, :, None] + offsets  # [H, W, K2, 2]
    valid = ((sample[..., 0] >= 0) & (sample[..., 0] < w)
             & (sample[..., 1] >= 0) & (sample[..., 1] < h))
    corr = torch.where(valid, corr, torch.full_like(corr, -1e9))
    prob = torch.softmax(corr, dim=-1)
    flow = torch.einsum("bhwk,hwkc->bhwc", prob, sample) - grid
    return flow, prob
