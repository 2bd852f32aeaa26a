"""DGNet: the gradient-induced camouflaged-object detector, NCHW
(counterpart of emip_tpu.models.dgnet).

The reference's ``lib/DGNet.py``, which no entry point builds: an
EfficientNet context encoder (``context_encoder``, B4 by default) whose
/8, /16 and /32 features are reduced to ``channel`` (``dr3``-``dr5``), a
shallow texture encoder (``texture_encoder``: three strided ConvBRs to a
32-wide /8 map and a 1-channel texture prediction), the gradient-induced
transition (``git``: the texture map, resized to /16 and /32 with
``align_corners=True``, channel-interleaved with each reduced feature in
M groups and mixed back to ``channel`` by the sum of three grouped 1x1
convs, added to the feature), and the NCD without its final upsample
(``ncd``). Both outputs, the context logits and the texture prediction,
are upsampled x8 (bilinear, ``align_corners=True``) in fp32. Convs run in
the compute dtype, BatchNorms in fp32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from emip_tpu_torch.dtypes import Conv2d
from emip_tpu_torch.models.backbones import create_backbone
from emip_tpu_torch.models.common import (
    ConvBR,
    DimensionalReduction,
    NeighborConnectionDecoder,
)
from emip_tpu_torch.models.emip_short import _set_dtype
from emip_tpu_torch.ops.image import resize_bilinear

__all__ = ["DGNet", "interleave_groups", "SoftGroupingStrategy",
           "GradientInducedTransition", "TextureEncoder"]

_TEXTURE = 32  # width of the texture encoder's /8 map
_M = (8, 8, 8)          # interleave groups at /8, /16, /32
_GROUPS = (4, 8, 16)    # group counts of the three soft-grouping convs


def interleave_groups(xr: torch.Tensor, xg: torch.Tensor,
                      m: int) -> torch.Tensor:
    """Channel-interleave two NCHW maps in ``m`` groups:
    [xr_g0, xg_g0, xr_g1, xg_g1, ...]."""
    b, c, h, w = xr.shape
    g = xg.shape[1]
    if c % m or g % m:
        raise ValueError(f"{c} and {g} channels do not split in {m} groups")
    return torch.cat([xr.reshape(b, m, c // m, h, w),
                      xg.reshape(b, m, g // m, h, w)], dim=2).reshape(
                          b, c + g, h, w)


class SoftGroupingStrategy(nn.Module):
    """Sum of three grouped 1x1 convs (no bias) with different group
    counts."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        for i, g in enumerate(_GROUPS):
            setattr(self, f"g_conv{i + 1}",
                    Conv2d(in_ch, out_ch, 1, groups=g, bias=False))

    def forward(self, q):
        return self.g_conv1(q) + self.g_conv2(q) + self.g_conv3(q)


class GradientInducedTransition(nn.Module):
    def __init__(self, channel: int = 32):
        super().__init__()
        for i in (3, 4, 5):
            setattr(self, f"sgs{i}", SoftGroupingStrategy(
                channel + _TEXTURE, channel))

    def forward(self, xr3, xr4, xr5, xg):
        h, w = xg.shape[2:]
        xg2 = resize_bilinear(xg, (h // 2, w // 2), align_corners=True)
        xg4 = resize_bilinear(xg, (h // 4, w // 4), align_corners=True)
        return tuple(
            xr + getattr(self, f"sgs{i + 3}")(interleave_groups(xr, g,
                                                                _M[i]))
            for i, (xr, g) in enumerate(((xr3, xg), (xr4, xg2), (xr5, xg4))))


class TextureEncoder(nn.Module):
    """Shallow spatial path: three strided ConvBRs to a 32-wide /8 map,
    and a 1x1 ConvBR to the 1-channel texture prediction."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBR(3, 64, 7, padding=3, stride=2)
        self.conv2 = ConvBR(64, 64, 3, padding=1, stride=2)
        self.conv3 = ConvBR(64, _TEXTURE, 3, padding=1, stride=2)
        self.conv_out = ConvBR(_TEXTURE, 1, 1, padding=0)

    def forward(self, x):
        xg = self.conv3(self.conv2(self.conv1(x)))
        return xg, self.conv_out(xg)


class DGNet(nn.Module):
    """``forward(x)`` -> (context logits, texture prediction), both
    [B, 1, H, W] fp32. ``dtype``: the compute dtype, fp32 or bfloat16."""

    def __init__(self, channel: int = 32, arc: str = "efficientnet_b4",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.context_encoder, ch = create_backbone(arc)
        self.dr3 = DimensionalReduction(ch[-3], channel)
        self.dr4 = DimensionalReduction(ch[-2], channel)
        self.dr5 = DimensionalReduction(ch[-1], channel)
        self.texture_encoder = TextureEncoder()
        self.git = GradientInducedTransition(channel)
        self.ncd = NeighborConnectionDecoder(channel, final_upsample=False)
        _set_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x3, x4, x5 = self.context_encoder(x)[-3:]
        xg, pg = self.texture_encoder(x)
        zt3, zt4, zt5 = self.git(self.dr3(x3), self.dr4(x4), self.dr5(x5),
                                 xg)
        pc = self.ncd(zt5, zt4, zt3)
        size = (8 * pg.shape[2], 8 * pg.shape[3])
        return (resize_bilinear(pc.float(), size, align_corners=True),
                resize_bilinear(pg.float(), size, align_corners=True))
