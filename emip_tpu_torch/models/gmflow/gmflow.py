"""GMFlow assembly at num_scales = 1 (counterpart of emip_tpu GMFlow).

Takes already extracted (and prompt-injected) NCHW feature lists, as the
reference's modified GMFlow does; the CNN encoder is owned here but
called by the enclosing two-stream model. Returns
(flow_fw_list, flow_bw_list, corr) with NCHW flows [B, 2, H, W] and the
raw correlation volume [B, H, W, HW]. With ``training`` the lists hold the
bilinearly upsampled pre-propagation flow before the final one, as in the
JAX package; the flow entering propagation is detached in both modes, so
kernel C's propagation backward yields dq and dk only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from emip_tpu_torch.kernels import convex_upsample
from emip_tpu_torch.models.gmflow.encoder import CNNEncoder
from emip_tpu_torch.models.gmflow.matching import global_correlation_softmax
from emip_tpu_torch.models.gmflow.transformer import (
    FeatureFlowAttention,
    FeatureTransformer,
)
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
        return (window_merge(f0 + pos, attn_splits),
                window_merge(f1 + pos, attn_splits))
    pos = sine_position_embedding(feature0.shape[1], feature0.shape[2],
                                  channels, device=feature0.device)
    return feature0 + pos, feature1 + pos


class GMFlow(nn.Module):
    def __init__(self, config: GMFlowConfig = GMFlowConfig()):
        super().__init__()
        cfg = config
        if (cfg.num_scales != 1 or cfg.corr_radius_list != (-1,)
                or cfg.prop_radius_list != (-1,)):
            raise NotImplementedError(
                "the port runs GMFlow at num_scales=1 with global matching "
                "and global propagation only")
        self.config = cfg
        c = cfg.feature_channels
        self.backbone = CNNEncoder(output_dim=c)
        self.transformer = FeatureTransformer(
            cfg.num_transformer_layers, c, cfg.ffn_dim_expansion,
            cfg.fused_block_max_t)
        self.feature_flow_attn = FeatureFlowAttention(c)
        self.upsampler = nn.Sequential(
            nn.Conv2d(2 + c, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, cfg.upsample_factor**2 * 9, 1))

    def encode(self, image):
        """CNN features of one frame (called by the host model)."""
        return self.backbone(image)

    def _upsample_mask(self, flow, feature):
        """flow [B,H,W,2], feature [B,H,W,C] -> mask logits [B,H,W,9K^2]."""
        concat = torch.cat([flow, feature], dim=-1).permute(0, 3, 1, 2)
        return self.upsampler(concat).permute(0, 2, 3, 1).contiguous()

    def forward(self, feature0_list, feature1_list, training: bool = False):
        cfg = self.config
        splits = cfg.attn_splits_list[0]
        # channel-last inside the flow engine, as in the JAX code
        feature0 = feature0_list[0].permute(0, 2, 3, 1)
        feature1 = feature1_list[0].permute(0, 2, 3, 1)
        feature0, feature1 = _add_position(feature0, feature1, splits,
                                           cfg.feature_channels)
        feature0, feature1 = self.transformer(feature0, feature1, splits)
        flow, corr = global_correlation_softmax(
            feature0, feature1, cfg.pred_bidir_flow,
            cfg.global_match_qk_fused)
        preds = []
        if training:  # intermediate supervision before propagation
            preds.append(upsample_flow_bilinear(flow, cfg.upsample_factor))
        if cfg.pred_bidir_flow:
            feature0 = torch.cat([feature0, feature1], dim=0)
        flow = self.feature_flow_attn(feature0, flow.detach())
        mask = self._upsample_mask(flow, feature0)
        preds.append(convex_upsample(flow.contiguous(), mask,
                                     cfg.upsample_factor))
        fws, bws = [], []
        for up in preds:
            up = up.permute(0, 3, 1, 2)
            fw, bw = up.chunk(2, dim=0) if cfg.pred_bidir_flow else (up, None)
            fws.append(fw)
            bws.append(bw)
        return fws, bws, corr
