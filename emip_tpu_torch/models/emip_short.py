"""EMIP short-term model: the two-stream co-updater, NCHW.

Counterpart of :mod:`emip_tpu.models.emip_short` (reference
``model/EMIP_short/model.py`` ``CoUpdater``): segmentation features (PVTv2
b5 by default, or any backbone whose /8 stage is GMFlow's width: the linear
PVTv2 and PVT-v1) and GMFlow CNN features for both frames; the camouflage feeder
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

:class:`SegNetwork` is the segmentation stream alone (backbone, three
dimensional reductions, NCD), the model of static-image pretraining.

``EMIPShort(config, dtype=torch.bfloat16)`` is the bf16 band, for
inference and training, in every configuration: the JAX package's
``EMIPShort(dtype=bfloat16)`` (the published configuration's
``compute_dtype``), with kernels A-D in their bf16 forwards and backwards,
at 512^2 G and H in theirs, J in its under the fused MixFFN switches, and
kernel I on the fp32 correlation volume under read-corr matching (as in
the JAX package); it outputs fp32 mask logits and flows, as the JAX model
does. ``SegNetwork(..., dtype=torch.bfloat16)`` is the same band for
static pretraining (kernel A, and J under its switches).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from emip_tpu_torch.dtypes import BatchNorm2d, Conv2d, set_compute_dtype
from emip_tpu_torch.models.backbones import BackboneConfig, create_backbone
from emip_tpu_torch.models.common import (
    DimensionalReduction,
    LayerNorm2d,
    NeighborConnectionDecoder,
)
from emip_tpu_torch.models.gmflow import GMFlow, GMFlowConfig
from emip_tpu_torch.models.prompt import Injector

__all__ = ["EMIPShortConfig", "EMIPShort", "SegNetwork"]


@dataclasses.dataclass(frozen=True)
class EMIPShortConfig:
    """Mirror of the JAX ``EMIPShortConfig``; ``backbone_name`` may also be
    a backbone's configuration (reduced depths)."""

    backbone_name: str | BackboneConfig = "pvt_v2_b5"
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
    """The reference's ``FeatureExtraction``: the encoder under the
    attribute its family has there (``feat_net_key``: ``pvtv2_en``, ...)."""

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.key = encoder.feat_net_key
        setattr(self, self.key, encoder)

    def forward(self, x, generator=None):
        return getattr(self, self.key)(x, generator)


class _SegBackbone(nn.Module):
    """``backbone.feat_net.<encoder>`` in the reference's key space."""

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.feat_net = _FeatNet(encoder)

    def forward(self, x, generator=None):
        return self.feat_net(x, generator)


def _set_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Give ``module`` its compute dtype: fp32 or bf16, else it raises."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{type(module).__name__} computes in float32 or "
                         f"bfloat16, not {dtype}")
    set_compute_dtype(module, dtype)


class EMIPShort(nn.Module):
    """The two-stream model. ``dtype``: its compute dtype, fp32 or
    bfloat16 (:mod:`emip_tpu_torch.dtypes`); the parameters are fp32
    either way."""

    def __init__(self, config: EMIPShortConfig = EMIPShortConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        encoder, ch = create_backbone(cfg.backbone_name,
                                      fused_ffn=cfg.fused_ffn,
                                      ffn_dwconv=cfg.ffn_dwconv)
        self.backbone = _SegBackbone(encoder)
        fdim = cfg.gmflow.feature_channels
        if cfg.gmflow.num_scales != 1:
            # the flow encoder returns one scale (/8) of features in both
            # packages, so GMFlow runs one scale inside the two-stream model
            raise ValueError(f"EMIPShort runs GMFlow at num_scales=1: its "
                             f"flow encoder gives one scale of features, "
                             f"not {cfg.gmflow.num_scales}")
        if ch[1] != fdim:
            # the injectors add a fdim-wide attention output to the /8 map,
            # in the JAX package too: Res2Net (512) and EfficientNet (24 /
            # 32) cannot feed a 128-wide GMFlow
            raise ValueError(f"GMFlow feature_channels ({fdim}) must equal "
                             f"the backbone's /8 width ({ch[1]}): the "
                             f"injectors add GMFlow-wide features to that "
                             f"map")
        self.GMFlow = GMFlow(cfg.gmflow)
        self.injector = Injector(dim=fdim)
        self.injector1 = Injector(dim=fdim)
        # correlation embedding HW -> HW/2 -> feature width
        hw = (cfg.inp_size // 8) ** 2
        # convs in the compute dtype, the BatchNorm in fp32 (as the JAX
        # package's conv_corr_bn)
        self.conv_corr = nn.Sequential(
            Conv2d(hw, hw // 2, 3, padding=1), BatchNorm2d(hw // 2),
            nn.ReLU(inplace=True), Conv2d(hw // 2, fdim, 3, padding=1))
        self.dr1 = DimensionalReduction(fdim, cfg.channel)
        self.dr2 = DimensionalReduction(ch[2], cfg.channel)
        self.dr3 = DimensionalReduction(ch[3], cfg.channel)
        self.decoder = NeighborConnectionDecoder(cfg.channel)
        if cfg.include_dead_modules:
            # reference model.py:53-84, never on the forward path
            self.dr2_new = nn.Conv2d(128, 32, 3, stride=2, padding=1)
            self.dr3_new = nn.Sequential(
                nn.Conv2d(128, 64, 3, stride=2, padding=1),
                BatchNorm2d(64), nn.ReLU(inplace=True),
                nn.Conv2d(64, 32, 3, stride=2, padding=1), BatchNorm2d(32))
            self.downscaling1 = nn.Sequential(
                nn.Conv2d(64, 128, 2, stride=2), LayerNorm2d(128))
            self.upscaling4 = nn.Sequential(
                nn.ConvTranspose2d(512, 256, 2, stride=2), LayerNorm2d(256),
                nn.GELU(), nn.ConvTranspose2d(256, 128, 2, stride=2))
            self.upscaling3 = nn.Sequential(
                nn.ConvTranspose2d(320, 128, 2, stride=2), LayerNorm2d(128))
        _set_dtype(self, dtype)

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


class SegNetwork(nn.Module):
    """Static-image segmentation network: any registered backbone, one
    ``DimensionalReduction`` per stage at /8, /16, /32 (``dr1``, ``dr2``,
    ``dr3``) and the NCD (``decoder``), giving logits [B, 1, H, W] at the
    input size.

    Counterpart of :class:`emip_tpu.models.emip_short.SegNetwork`, the
    model of the reference's COD10K pretraining (its ``Network``,
    create_backbone.py:183-196), with the JAX package's two deliberate
    fixes: the decoder is fed through the reductions (the reference wires
    the raw 128 / 320 / 512-channel features into a 32-channel decoder,
    which cannot run), and ``Decoder.forward``'s extra x8 upsample (2816²
    outputs at 352²) is dropped. The keys are :class:`EMIPShort`'s
    (``backbone.feat_net.pvtv2_en``, ``dr1``-``dr3``, ``decoder``), so a
    pretrained checkpoint loads into the two-stream model through the
    config's ``load.path``. In train mode drop path draws from the
    ``generator`` passed to :meth:`forward`.

    ``dtype`` is the compute dtype, as :class:`EMIPShort`'s: bfloat16 is
    the JAX ``SegNetwork(dtype=bfloat16)`` of the published configuration,
    for inference and training (kernel A in bf16, fp32 parameters cast at
    each use, fp32 BatchNorms and norm statistics, fp32 logits); the
    ``state_dict`` is the fp32 one either way.
    """

    def __init__(self, backbone_name: str | BackboneConfig = "pvt_v2_b5",
                 channel: int = 32, fused_ffn: str | None = None,
                 ffn_dwconv: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        encoder, ch = create_backbone(backbone_name, fused_ffn=fused_ffn,
                                      ffn_dwconv=ffn_dwconv)
        self.backbone = _SegBackbone(encoder)
        self.dr1 = DimensionalReduction(ch[-3], channel)
        self.dr2 = DimensionalReduction(ch[-2], channel)
        self.dr3 = DimensionalReduction(ch[-1], channel)
        self.decoder = NeighborConnectionDecoder(channel)
        _set_dtype(self, dtype)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        stages = self.backbone(x, generator)
        return self.decoder(self.dr3(stages[-1]), self.dr2(stages[-2]),
                            self.dr1(stages[-3]))
