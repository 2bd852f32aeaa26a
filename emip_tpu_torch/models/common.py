"""Conv blocks and the neighbor-connection decoder (NCD), NCHW.

Counterpart of :mod:`emip_tpu.models.common` (reference
``create_backbone.py``). BatchNorm uses its running statistics in eval
mode, eps 1e-5, as in the JAX package. With a bf16 compute dtype
(:mod:`emip_tpu_torch.dtypes`) each conv runs in bf16 on its input cast to
bf16, and each BatchNorm computes and returns fp32 (flax's
``BatchNorm(dtype=float32)``), so the decoder's products between blocks
are fp32 and its logits come out fp32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import BatchNorm2d, Conv2d
from emip_tpu_torch.ops.image import resize_bilinear

__all__ = ["ConvBR", "BasicConv2d", "DimensionalReduction",
           "NeighborConnectionDecoder", "LayerNorm2d", "pixel_shuffle",
           "pixel_unshuffle", "PixelShuffleDownsample",
           "PixelShuffleUpsample"]


class ConvBR(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 1, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=padding, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm, then ReLU with ``with_relu``: the
    reference's two same-named blocks (create_backbone.py:7-19 without the
    ReLU, model.py:137-150 with it)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 with_relu: bool = False):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=padding, dilation=dilation, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=1e-5)
        self.with_relu = with_relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.with_relu else x


class DimensionalReduction(nn.Module):
    """Two stacked 3x3 ConvBRs (keys ``reduce.0``, ``reduce.1``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.reduce = nn.Sequential(ConvBR(in_ch, out_ch),
                                    ConvBR(out_ch, out_ch))

    def forward(self, x):
        return self.reduce(x)


def _up2(x):
    """2x bilinear upsample, align_corners=True (as the NCD's nn.Upsample)."""
    return resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]),
                           align_corners=True)


class NeighborConnectionDecoder(nn.Module):
    """Fuse (zt5 @ /32, zt4 @ /16, zt3 @ /8) into 1-channel logits at /1.

    The final x8 upsample is bilinear with align_corners=False, in fp32.
    ``final_upsample=False`` returns the /8 logits in the compute dtype (the
    DGNet variant, which upsamples them itself).
    """

    def __init__(self, channel: int = 32, final_upsample: bool = True):
        super().__init__()
        c = channel
        self.final_upsample = final_upsample
        self.conv_upsample1 = ConvBR(c, c)
        self.conv_upsample2 = ConvBR(c, c)
        self.conv_upsample3 = ConvBR(c, c)
        self.conv_upsample4 = ConvBR(c, c)
        self.conv_upsample5 = ConvBR(2 * c, 2 * c)
        self.conv_concat2 = ConvBR(2 * c, 2 * c)
        self.conv_concat3 = ConvBR(3 * c, 3 * c)
        self.conv4 = ConvBR(3 * c, 3 * c)
        self.conv5 = Conv2d(3 * c, 1, 1)

    def forward(self, zt5, zt4, zt3):
        zt4_1 = self.conv_upsample1(_up2(zt5)) * zt4
        zt3_1 = (self.conv_upsample2(_up2(zt4_1))
                 * self.conv_upsample3(_up2(zt4)) * zt3)
        zt4_2 = self.conv_concat2(
            torch.cat([zt4_1, self.conv_upsample4(_up2(zt5))], dim=1))
        zt3_2 = self.conv_concat3(
            torch.cat([zt3_1, self.conv_upsample5(_up2(zt4_2))], dim=1))
        logits = self.conv5(self.conv4(zt3_2))
        if not self.final_upsample:
            return logits
        logits = logits.float()
        h, w = logits.shape[2:]
        return resize_bilinear(logits, (8 * h, 8 * w), align_corners=False)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NCHW features (SAM-style), eps 1e-6."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = (x - mu).pow(2).mean(1, keepdim=True)
        x = (x - mu) / torch.sqrt(var + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW [B, C*r^2, H, W] -> [B, C, H*r, W*r] (``nn.PixelShuffle``)."""
    return F.pixel_shuffle(x, factor)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW [B, C, H*r, W*r] -> [B, C*r^2, H, W] (``nn.PixelUnshuffle``)."""
    return F.pixel_unshuffle(x, factor)


class PixelShuffleDownsample(nn.Module):
    """3x3 conv (C -> C/2, no bias) then pixel-unshuffle by 2: half the
    size, twice the channels. An alternate the reference defines and never
    builds (model.py:14-22)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.conv = nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False)

    def forward(self, x):
        return pixel_unshuffle(self.conv(x), 2)


class PixelShuffleUpsample(nn.Module):
    """3x3 conv (C -> 2C, no bias) then pixel-shuffle by 2: twice the
    size, half the channels (model.py:24-31, never built there either)."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.conv = nn.Conv2d(n_feat, 2 * n_feat, 3, padding=1, bias=False)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), 2)
