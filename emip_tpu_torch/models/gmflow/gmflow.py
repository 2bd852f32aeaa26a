"""GMFlow assembly (counterpart of emip_tpu GMFlow), one scale or several.

Takes already extracted (and prompt-injected) NCHW feature lists, one a
scale from coarse to fine, as the reference's modified GMFlow does; the
CNN encoder is owned here but called by the enclosing two-stream model.
Returns (flow_fw_list, flow_bw_list, corr) with NCHW flows [B, 2, H, W]
and the raw correlation volume [B, H, W, HW] of the last scale that
matched globally. With ``training`` the lists hold, at each scale, the
bilinearly upsampled flow before propagation and (but at the last scale)
after it, then the final one, as in the JAX package; the flow entering
propagation is detached in both modes, so kernel C's propagation backward
yields dq and dk only. At a scale after the first both directions ride the
batch axis, the previous flow is upsampled x2 and detached, and feature1 is
warped by it before the transformer; matching and propagation are global
(kernel C) where the scale's radius is -1, else over a local window
(plain tensor code), and the flow found is added to the previous one. With
a bf16 compute dtype (:mod:`emip_tpu_torch.dtypes`) the features are bf16
from the encoder to the upsampler's convs (the position embedding added in
bf16, the warp sampled in fp32 and rounded), the flows fp32 (matching and
propagation write fp32), and D reads the upsampler's bf16 mask logits, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from emip_tpu_torch.dtypes import Conv2d
from emip_tpu_torch.kernels import convex_upsample
from emip_tpu_torch.models.gmflow.encoder import CNNEncoder
from emip_tpu_torch.models.gmflow.matching import (
    global_correlation_softmax,
    local_correlation_softmax,
)
from emip_tpu_torch.models.gmflow.transformer import (
    FeatureFlowAttention,
    FeatureTransformer,
)
from emip_tpu_torch.ops.geometry import flow_warp
from emip_tpu_torch.ops.position import sine_position_embedding
from emip_tpu_torch.ops.upsample import upsample_flow_bilinear
from emip_tpu_torch.ops.window import window_merge, window_split

__all__ = ["GMFlowConfig", "GMFlow"]


@dataclasses.dataclass(frozen=True)
class GMFlowConfig:
    """Mirror of :class:`emip_tpu.models.gmflow.GMFlowConfig`'s defaults."""

    num_scales: int = 1
    upsample_factor: int = 8
    feature_channels: int = 128
    num_transformer_layers: int = 6
    ffn_dim_expansion: int = 4
    attn_splits_list: tuple[int, ...] = (2,)
    corr_radius_list: tuple[int, ...] = (-1,)
    prop_radius_list: tuple[int, ...] = (-1,)
    pred_bidir_flow: bool = True
    # global matching: True recomputes q k^T inside kernel C (flash
    # matching); False reads the stored correlation through kernel I
    global_match_qk_fused: bool = True
    # windows of more tokens than this run as two layer kernels (G, H)
    # instead of the whole-block kernel B
    fused_block_max_t: int = 784


def _add_position(feature0, feature1, attn_splits: int, channels: int):
    """Sine position embedding per attention window (features [B,H,W,C])."""
    if attn_splits > 1:
        f0 = window_split(feature0, attn_splits)
        f1 = window_split(feature1, attn_splits)
        pos = sine_position_embedding(f0.shape[1], f0.shape[2], channels,
                                      device=f0.device)
        pos = pos.to(f0.dtype)
        return (window_merge(f0 + pos, attn_splits),
                window_merge(f1 + pos, attn_splits))
    pos = sine_position_embedding(feature0.shape[1], feature0.shape[2],
                                  channels,
                                  device=feature0.device).to(feature0.dtype)
    return feature0 + pos, feature1 + pos


class GMFlow(nn.Module):
    def __init__(self, config: GMFlowConfig = GMFlowConfig()):
        super().__init__()
        cfg = config
        if not (len(cfg.attn_splits_list) == len(cfg.corr_radius_list)
                == len(cfg.prop_radius_list) == cfg.num_scales):
            raise ValueError(
                f"GMFlow: attn_splits_list, corr_radius_list and "
                f"prop_radius_list need one entry for each of the "
                f"{cfg.num_scales} scales")
        self.config = cfg
        c = cfg.feature_channels
        self.backbone = CNNEncoder(output_dim=c)
        self.transformer = FeatureTransformer(
            cfg.num_transformer_layers, c, cfg.ffn_dim_expansion,
            cfg.fused_block_max_t)
        self.feature_flow_attn = FeatureFlowAttention(c)
        self.upsampler = nn.Sequential(
            Conv2d(2 + c, 256, 3, padding=1), nn.ReLU(inplace=True),
            Conv2d(256, cfg.upsample_factor**2 * 9, 1))

    def encode(self, image):
        """CNN features of one frame (called by the host model)."""
        return self.backbone(image)

    def _upsample_mask(self, flow, feature):
        """flow [B,H,W,2], feature [B,H,W,C] -> mask logits [B,H,W,9K^2]
        (in the features' dtype)."""
        concat = torch.cat([flow.to(feature.dtype), feature],
                           dim=-1).permute(0, 3, 1, 2)
        return self.upsampler(concat).permute(0, 2, 3, 1).contiguous()

    def forward(self, feature0_list, feature1_list, training: bool = False):
        cfg = self.config
        bidir = cfg.pred_bidir_flow
        flow, corr, preds = None, None, []
        for scale in range(cfg.num_scales):
            # channel-last inside the flow engine, as in the JAX code
            feature0 = feature0_list[scale].permute(0, 2, 3, 1)
            feature1 = feature1_list[scale].permute(0, 2, 3, 1)
            if bidir and scale > 0:
                feature0, feature1 = (torch.cat([feature0, feature1], 0),
                                      torch.cat([feature1, feature0], 0))
            factor = cfg.upsample_factor * 2**(cfg.num_scales - 1 - scale)
            if flow is not None:
                flow = upsample_flow_bilinear(flow, 2).detach()
                feature1 = flow_warp(feature1, flow)
            splits = cfg.attn_splits_list[scale]
            corr_radius = cfg.corr_radius_list[scale]
            prop_radius = cfg.prop_radius_list[scale]
            feature0, feature1 = _add_position(feature0, feature1, splits,
                                               cfg.feature_channels)
            feature0, feature1 = self.transformer(feature0, feature1, splits)
            if corr_radius == -1:
                flow_pred, corr = global_correlation_softmax(
                    feature0, feature1, bidir, cfg.global_match_qk_fused)
            else:
                flow_pred, _ = local_correlation_softmax(feature0, feature1,
                                                         corr_radius)
            flow = flow_pred if flow is None else flow + flow_pred
            if training:  # intermediate supervision before propagation
                preds.append(upsample_flow_bilinear(flow, factor))
            if bidir and scale == 0:
                feature0 = torch.cat([feature0, feature1], dim=0)
            flow = self.feature_flow_attn(feature0, flow.detach(),
                                          prop_radius > 0, prop_radius)
            if training and scale < cfg.num_scales - 1:
                preds.append(upsample_flow_bilinear(flow, factor))
        mask = self._upsample_mask(flow, feature0)
        preds.append(convex_upsample(flow.contiguous(), mask,
                                     cfg.upsample_factor))
        fws, bws = [], []
        for up in preds:
            up = up.permute(0, 3, 1, 2)
            fw, bw = up.chunk(2, dim=0) if bidir else (up, None)
            fws.append(fw)
            bws.append(bw)
        return fws, bws, corr
