"""EfficientNet-B1 / B4 encoder, MBConv with squeeze-excitation
(counterpart of emip_tpu.models.efficientnet).

The compound-scaled EfficientNet of the JAX package (the reference's
option cannot run; the JAX package made it work): a stride-2 3x3 stem
with BatchNorm and SiLU, then the seven B0 stages, their widths and
repeats scaled and rounded as the JAX module rounds them. An MBConv block
expands 1x1 (unless its ratio is 1), runs a depthwise conv with symmetric
padding k // 2, squeezes and excites on a width sized on the block's
*input* channels, projects 1x1 and adds its input at stride 1 between
equal widths. Returns the features before each stride-2 stage from /4 on
and the last stage's (/4, /8, /16, /32), fp32 in either compute dtype:
every conv in the compute dtype, every BatchNorm in fp32 (eps 1e-3, torch
momentum 0.01, flax's 0.99). ``state_dict`` keys follow the
``efficientnet_pytorch`` layout of the reference's ``lib/EfficientNet.py``
(``_conv_stem``, ``_bn0``, ``_blocks.N._depthwise_conv``, ``_se_reduce``,
``_project_conv``, ``_bn0``-``_bn2``), the blocks numbered across stages.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import BatchNorm2d, Conv2d

__all__ = ["EfficientNetConfig", "EFFICIENTNET_VARIANTS",
           "EfficientNetBackbone", "MBConv"]

# (expand_ratio, channels, repeats, stride, kernel) of B0
B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
_SE_RATIO = 0.25  # the squeeze's width over the block's input channels


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    width_mult: float = 1.4
    depth_mult: float = 1.8


EFFICIENTNET_VARIANTS = {
    "efficientnet_b1": EfficientNetConfig(1.0, 1.1),
    "efficientnet_b4": EfficientNetConfig(1.4, 1.8),
}


def _round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-3, momentum=0.01)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int,
                 kernel: int):
        super().__init__()
        mid = in_ch * expand
        self.expand, self.stride = expand, stride
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self._expand_conv = Conv2d(in_ch, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv = Conv2d(mid, mid, kernel, stride=stride,
                                      padding=kernel // 2, groups=mid,
                                      bias=False)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(in_ch * _SE_RATIO))
        self._se_reduce = Conv2d(mid, se_ch, 1)
        self._se_expand = Conv2d(se_ch, mid, 1)
        self._project_conv = Conv2d(mid, out_ch, 1, bias=False)
        self._bn2 = _bn(out_ch)

    def forward(self, x):
        inp = x
        if self.expand != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        s = x.mean((2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        x = x * torch.sigmoid(s)
        x = self._bn2(self._project_conv(x))
        return x + inp if self.residual else x


class EfficientNetBackbone(nn.Module):
    feat_net_key = "backbone"

    def __init__(self, config: EfficientNetConfig = EfficientNetConfig()):
        super().__init__()
        self.config = config
        w, d = config.width_mult, config.depth_mult
        stem = _round_filters(32, w)
        self._conv_stem = Conv2d(3, stem, 3, stride=2, padding=1,
                                 bias=False)
        self._bn0 = _bn(stem)
        blocks, in_ch = [], stem
        for expand, ch, repeats, stride, kernel in B0_BLOCKS:
            out_ch = _round_filters(ch, w)
            for r in range(_round_repeats(repeats, d)):
                blocks.append(MBConv(in_ch, out_ch, expand,
                                     stride if r == 0 else 1, kernel))
                in_ch = out_ch
        self._blocks = nn.ModuleList(blocks)

    @property
    def stage_channels(self) -> tuple[int, ...]:
        """Channels at /4, /8, /16, /32."""
        chans = [_round_filters(c, self.config.width_mult)
                 for _, c, _, _, _ in B0_BLOCKS]
        return (chans[1], chans[2], chans[4], chans[6])

    def forward(self, x: torch.Tensor, generator=None
                ) -> tuple[torch.Tensor, ...]:
        x = F.silu(self._bn0(self._conv_stem(x)))
        endpoints = []
        for block in self._blocks:
            if block.stride == 2:
                endpoints.append(x)  # the feature before downsampling
            x = block(x)
        endpoints.append(x)
        return tuple(endpoints[1:])  # /4, /8, /16, /32
