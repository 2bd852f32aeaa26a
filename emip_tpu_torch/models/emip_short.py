"""EMIP short-term model: the two-stream co-updater, NCHW.

Counterpart of :mod:`emip_tpu.models.emip_short` (reference
``model/EMIP_short/model.py`` ``CoUpdater``): PVTv2 segmentation features
and GMFlow CNN features for both frames; the camouflage feeder
(``injector``) injects segmentation features into the motion stream; the
flow engine matches the injected features and returns bidirectional flow
plus the raw correlation volume; ``conv_corr`` embeds the volume and the
motion collector (``injector1``) injects it into frame 1's features; a
3-level dimensional reduction and the NCD decode full-resolution logits.

The module tree and ``state_dict`` keys are the reference's, including
the modules it checkpoints but never runs (``dr2_new``, ``dr3_new``,
``downscaling1``, ``upscaling3/4``). In train mode (``model.train()``) the
PVT backbone takes stochastic depth from the ``generator`` passed to
:meth:`EMIPShort.forward`, BatchNorm uses batch statistics, and the flow
engine also returns its pre-propagation flow.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from emip_tpu_torch.models.backbones import create_backbone
from emip_tpu_torch.models.common import (
    DimensionalReduction,
    LayerNorm2d,
    NeighborConnectionDecoder,
)
from emip_tpu_torch.models.gmflow import GMFlow, GMFlowConfig
from emip_tpu_torch.models.prompt import Injector
from emip_tpu_torch.models.pvt_v2 import PVTv2Config

__all__ = ["EMIPShortConfig", "EMIPShort"]


@dataclasses.dataclass(frozen=True)
class EMIPShortConfig:
    """Mirror of the JAX ``EMIPShortConfig``; ``backbone_name`` may also be
    a :class:`PVTv2Config` (reduced depths)."""

    backbone_name: str | PVTv2Config = "pvt_v2_b5"
    channel: int = 32
    inp_size: int = 352
    gmflow: GMFlowConfig = GMFlowConfig()
    include_dead_modules: bool = True
    # MixFFN kernel switches of the backbone's :class:`PVTv2Config`
    # (``fused_ffn``: "never" | "always"; ``ffn_dwconv``: "conv" |
    # "bwd_fused"); None leaves what the backbone's configuration says
    fused_ffn: str | None = None
    ffn_dwconv: str | None = None


class _FeatNet(nn.Module):
    def __init__(self, pvt: nn.Module):
        super().__init__()
        self.pvtv2_en = pvt


class _SegBackbone(nn.Module):
    """``backbone.feat_net.pvtv2_en`` in the reference's key space."""

    def __init__(self, pvt: nn.Module):
        super().__init__()
        self.feat_net = _FeatNet(pvt)

    def forward(self, x, generator=None):
        return self.feat_net.pvtv2_en(x, generator)


class EMIPShort(nn.Module):
    def __init__(self, config: EMIPShortConfig = EMIPShortConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        pvt, ch = create_backbone(cfg.backbone_name, fused_ffn=cfg.fused_ffn,
                                  ffn_dwconv=cfg.ffn_dwconv)
        self.backbone = _SegBackbone(pvt)
        fdim = cfg.gmflow.feature_channels
        if ch[1] != fdim:
            raise ValueError(f"GMFlow feature_channels ({fdim}) must equal "
                             f"the backbone's /8 width ({ch[1]})")
        self.GMFlow = GMFlow(cfg.gmflow)
        self.injector = Injector(dim=fdim)
        self.injector1 = Injector(dim=fdim)
        # correlation embedding HW -> HW/2 -> feature width
        hw = (cfg.inp_size // 8) ** 2
        self.conv_corr = nn.Sequential(
            nn.Conv2d(hw, hw // 2, 3, padding=1), nn.BatchNorm2d(hw // 2),
            nn.ReLU(inplace=True), nn.Conv2d(hw // 2, fdim, 3, padding=1))
        self.dr1 = DimensionalReduction(fdim, cfg.channel)
        self.dr2 = DimensionalReduction(ch[2], cfg.channel)
        self.dr3 = DimensionalReduction(ch[3], cfg.channel)
        self.decoder = NeighborConnectionDecoder(cfg.channel)
        if cfg.include_dead_modules:
            # reference model.py:53-84, never on the forward path
            self.dr2_new = nn.Conv2d(128, 32, 3, stride=2, padding=1)
            self.dr3_new = nn.Sequential(
                nn.Conv2d(128, 64, 3, stride=2, padding=1),
                nn.BatchNorm2d(64), nn.ReLU(inplace=True),
                nn.Conv2d(64, 32, 3, stride=2, padding=1), nn.BatchNorm2d(32))
            self.downscaling1 = nn.Sequential(
                nn.Conv2d(64, 128, 2, stride=2), LayerNorm2d(128))
            self.upscaling4 = nn.Sequential(
                nn.ConvTranspose2d(512, 256, 2, stride=2), LayerNorm2d(256),
                nn.GELU(), nn.ConvTranspose2d(256, 128, 2, stride=2))
            self.upscaling3 = nn.Sequential(
                nn.ConvTranspose2d(320, 128, 2, stride=2), LayerNorm2d(128))

    def encode_frame(self, image: torch.Tensor, generator=None) -> dict:
        """Everything that depends on one frame: backbone stages /8, /16,
        /32, CNN flow features and the camouflage-feeder injection."""
        size = self.config.inp_size
        if tuple(image.shape[-2:]) != (size, size):
            # conv_corr's input width is (inp_size / 8)^2
            raise ValueError(f"frames are {tuple(image.shape[-2:])}, the "
                             f"model was built for inp_size {size}")
        stages = self.backbone(image, generator)
        fea = (stages[-3], stages[-2], stages[-1])
        gm = self.GMFlow.encode(image)[0]
        return dict(fea=fea, inj=self.injector(gm, fea[0]))

    def conv_corr_embed(self, corr: torch.Tensor) -> torch.Tensor:
        """[B, H, W, HW] correlation -> [B, fdim, H, W] embedding."""
        return self.conv_corr(corr.permute(0, 3, 1, 2))

    def pair_from_encodings(self, enc1: dict, enc2: dict,
                            with_decode: bool = True) -> dict:
        """Flow engine, correlation embedding and (unless ``with_decode``
        is off, as the long model's streaming step asks) the
        motion-collector decode of frame 1."""
        flow_fw, flow_bw, corr = self.GMFlow([enc1["inj"]], [enc2["inj"]],
                                             training=self.training)
        corr_emb = self.conv_corr_embed(corr)
        mask = fea_new = None
        if with_decode:
            fea8, fea16, fea32 = enc1["fea"]
            fea_new = self.injector1(fea8, corr_emb)
            mask = self.decoder(self.dr3(fea32), self.dr2(fea16),
                                self.dr1(fea_new))
        return dict(mask=mask, flow_fw=flow_fw, flow_bw=flow_bw, corr=corr,
                    corr_emb=corr_emb, fea_1=enc1["fea"], fea_2=enc2["fea"],
                    fea_new=fea_new)

    def forward_full(self, image1: torch.Tensor, image2: torch.Tensor,
                     generator=None) -> dict:
        """Full two-stream forward on NCHW frames; dict of intermediates."""
        return self.pair_from_encodings(self.encode_frame(image1, generator),
                                        self.encode_frame(image2, generator))

    def forward(self, image1, image2, generator=None):
        out = self.forward_full(image1, image2, generator)
        return out["mask"], out["flow_fw"], out["flow_bw"]
