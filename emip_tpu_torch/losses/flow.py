"""Unsupervised (photometric) optical-flow loss, UnFlow style.

Counterpart of :mod:`emip_tpu.losses.flow` (reference
``loss/loss_flow.py:16-138``): per pyramid level, each image is
backward-warped by the opposite flow, occluded pixels are masked by the
backward-flow splat density (kernel E), and a 0.15 L1 + 0.85 SSIM
photometric distance is averaged over both directions. As in the
reference, the smoothness term is not part of the loss, occlusion masks
come from level 0 only (nearest-resized for the other levels), and the
photometric terms are normalised by the mean occlusion mask (over the
whole batch: under data parallelism, over every rank's masks).

Flows are a list of (flow_fw, flow_bw) NHWC pairs [B, H, W, 2]; images
are NHWC [B, H, W, 3], as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from emip_tpu_torch.ops.image import resize_area, resize_nearest
from emip_tpu_torch.parallel import all_reduce_mean
from emip_tpu_torch.ops.warp import flow_warp_loss, occlusion_mask_backward

__all__ = ["UnsupFlowLossConfig", "unsup_flow_loss",
           "unsup_flow_loss_decay", "ssim_distance"]


@dataclasses.dataclass(frozen=True)
class UnsupFlowLossConfig:
    w_l1: float = 0.15
    w_ssim: float = 0.85
    ssim_window: int = 1  # radius; patch = 2r+1
    occ_threshold: float = 0.2
    w_scales: tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 0.0)
    warp_pad: str = "border"
    with_back: bool = True


def _nchw_resize(fn, x: torch.Tensor, hw) -> torch.Tensor:
    return fn(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


def _avg_pool_valid(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Valid-padding mean pooling over the NHWC spatial dims, stride 1."""
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), patch, stride=1)
    return y.permute(0, 2, 3, 1)


def ssim_distance(x: torch.Tensor, y: torch.Tensor,
                  radius: int = 1) -> torch.Tensor:
    """(1 - SSIM) / 2 per pixel (valid window), clamped to [0, 1]
    (reference loss/loss_blocks.py:46-65)."""
    patch = 2 * radius + 1
    c1, c2 = 0.01**2, 0.03**2
    mu_x = _avg_pool_valid(x, patch)
    mu_y = _avg_pool_valid(y, patch)
    sigma_x = _avg_pool_valid(x * x, patch) - mu_x * mu_x
    sigma_y = _avg_pool_valid(y * y, patch) - mu_y * mu_y
    sigma_xy = _avg_pool_valid(x * y, patch) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1.0 - num / den) / 2.0, 0.0, 1.0)


def _photometric(cfg: UnsupFlowLossConfig, im_target, im_recons, occ_mask):
    terms = []
    if cfg.w_l1 > 0:
        terms.append(torch.mean(cfg.w_l1 * (im_target - im_recons).abs()
                                * occ_mask))
    if cfg.w_ssim > 0:
        terms.append(torch.mean(cfg.w_ssim * ssim_distance(
            im_recons * occ_mask, im_target * occ_mask, cfg.ssim_window)))
    # JAX's mean runs over the global batch: with data parallelism the
    # normaliser is the mean over every rank's masks, with gradient
    return sum(terms) / all_reduce_mean(torch.mean(occ_mask))


def unsup_flow_loss(flows: Sequence[tuple[torch.Tensor, torch.Tensor]],
                    im1: torch.Tensor, im2: torch.Tensor,
                    cfg: UnsupFlowLossConfig = UnsupFlowLossConfig()):
    """Returns (total_loss, warp_loss, mean_abs_flow_level0)."""
    im1 = im1.float()
    im2 = im2.float()
    occ1_l0 = occ2_l0 = None
    warp_losses = []
    for i, (flow_fw, flow_bw) in enumerate(flows):
        if i >= len(cfg.w_scales) or cfg.w_scales[i] == 0.0:
            continue
        _, h, w, _ = flow_fw.shape
        im1_s = _nchw_resize(resize_area, im1, (h, w))
        im2_s = _nchw_resize(resize_area, im2, (h, w))
        im1_recons = flow_warp_loss(im2_s, flow_fw, pad=cfg.warp_pad)
        im2_recons = flow_warp_loss(im1_s, flow_bw, pad=cfg.warp_pad)
        if i == 0:
            occ1_l0 = occ1 = 1.0 - occlusion_mask_backward(
                flow_bw, th=cfg.occ_threshold)
            occ2_l0 = occ2 = 1.0 - occlusion_mask_backward(
                flow_fw, th=cfg.occ_threshold)
        else:
            occ1 = _nchw_resize(resize_nearest, occ1_l0, (h, w))
            occ2 = _nchw_resize(resize_nearest, occ2_l0, (h, w))
        loss_warp = _photometric(cfg, im1_s, im1_recons, occ1)
        if cfg.with_back:
            loss_warp = (loss_warp
                         + _photometric(cfg, im2_s, im2_recons, occ2)) / 2.0
        warp_losses.append(cfg.w_scales[i] * loss_warp)
    warp_loss = sum(warp_losses)
    mean_abs = torch.mean(torch.cat([flows[0][0], flows[0][1]], dim=-1).abs())
    return warp_loss, warp_loss, mean_abs


def unsup_flow_loss_decay(flows: Sequence[tuple[torch.Tensor, torch.Tensor]],
                          im1: torch.Tensor, im2: torch.Tensor,
                          gamma: float = 0.8,
                          cfg: UnsupFlowLossConfig = UnsupFlowLossConfig()):
    """RAFT-style variant: prediction i of n weighs gamma^(n-1-i), so later
    predictions weigh more (the reference's unused ``unFlowLoss_decay``,
    loss/loss_flow.py:144-276). Returns what :func:`unsup_flow_loss`
    does."""
    n = len(flows)
    decayed = dataclasses.replace(cfg, w_scales=tuple(
        gamma ** (n - 1 - i) * s for i, s in zip(range(n), cfg.w_scales)))
    return unsup_flow_loss(flows, im1, im2, decayed)
