"""Res2Net-50 v1b, 26w x 4s (counterpart of emip_tpu.models.res2net).

The reference's selectable CNN encoder (``lib/Res2Net_v1b.py``): a deep
stem of three 3x3 convs (32, 32, 64) with BatchNorm and ReLU and a 3x3 max
pool, then four stages of ``Bottle2neck`` blocks whose 3x3 convs run on
26-wide splits, 4 of them, each split after the first adding the previous
one's output (on the first block of a stage each split stands alone and
the last is average-pooled 3x3 at the block's stride, counting the
padding). The v1b shortcut is an s x s average pool, a 1x1 conv and
BatchNorm. Returns the four stages (256, 512, 1024, 2048 channels at /4,
/8, /16, /32), fp32 in either compute dtype: every conv runs in the
compute dtype, every BatchNorm in fp32 (eps 1e-5, torch momentum 0.1,
flax's 0.9). ``state_dict`` keys follow ``lib/Res2Net_v1b.py``
(``conv1.0`` ... ``conv1.6`` and ``bn1`` for the stem, ``layer1.0.convs.0``,
``layer1.0.downsample.1`` for the shortcut's conv).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import BatchNorm2d, Conv2d

__all__ = ["Res2NetConfig", "RES2NET_VARIANTS", "Res2Net50V1b",
           "Bottle2neck"]

BASE_WIDTH = 26  # channels of a split per 64 planes
SCALE = 4        # splits a block


@dataclasses.dataclass(frozen=True)
class Res2NetConfig:
    layers: tuple[int, ...] = (3, 4, 6, 3)


RES2NET_VARIANTS = {"res2net50_26w_4s": Res2NetConfig()}


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, first_of_stage: bool = False):
        super().__init__()
        width = int(planes * (BASE_WIDTH / 64.0))
        self.width, self.stride = width, stride
        self.first_of_stage = first_of_stage
        self.conv1 = Conv2d(inplanes, width * SCALE, 1, bias=False)
        self.bn1 = _bn(width * SCALE)
        self.convs = nn.ModuleList(
            Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
            for _ in range(SCALE - 1))
        self.bns = nn.ModuleList(_bn(width) for _ in range(SCALE - 1))
        self.conv3 = Conv2d(width * SCALE, planes * self.expansion, 1,
                            bias=False)
        self.bn3 = _bn(planes * self.expansion)
        if downsample:
            # index 0 is the reference's AvgPool2d, which holds no weights
            self.downsample = nn.ModuleDict({
                "1": Conv2d(inplanes, planes * self.expansion, 1,
                            bias=False),
                "2": _bn(planes * self.expansion)})
        else:
            self.downsample = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        outputs, prev = [], None
        for i in range(SCALE - 1):
            sp = splits[i] if self.first_of_stage or prev is None else (
                splits[i] + prev)
            prev = F.relu(self.bns[i](self.convs[i](sp)))
            outputs.append(prev)
        last = splits[-1]
        if self.first_of_stage and self.stride != 1:
            last = F.avg_pool2d(last, 3, self.stride, padding=1)
        outputs.append(last)
        out = self.bn3(self.conv3(torch.cat(outputs, dim=1)))
        sc = x
        if self.downsample is not None:
            if self.stride != 1:
                sc = F.avg_pool2d(sc, self.stride, self.stride)
            sc = self.downsample["2"](self.downsample["1"](sc))
        return F.relu(out + sc)


class Res2Net50V1b(nn.Module):
    """The encoder; ``config.layers`` gives the blocks per stage (reduced
    depths in tests)."""

    feat_net_key = "resnet"

    def __init__(self, config: Res2NetConfig = Res2NetConfig()):
        super().__init__()
        self.config = config
        # the reference's Sequential: conv, bn, relu, conv, bn, relu, conv;
        # the third conv's BatchNorm is bn1
        self.conv1 = nn.ModuleDict({
            "0": Conv2d(3, 32, 3, stride=2, padding=1, bias=False),
            "1": _bn(32),
            "3": Conv2d(32, 32, 3, padding=1, bias=False),
            "4": _bn(32),
            "6": Conv2d(32, 64, 3, padding=1, bias=False)})
        self.bn1 = _bn(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     config.layers)):
            layer = [Bottle2neck(inplanes, planes, 1 if stage == 0 else 2,
                                 True, first_of_stage=True)]
            inplanes = planes * Bottle2neck.expansion
            layer += [Bottle2neck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))

    @property
    def stage_channels(self) -> tuple[int, ...]:
        return (256, 512, 1024, 2048)

    def forward(self, x: torch.Tensor, generator=None
                ) -> tuple[torch.Tensor, ...]:
        stem = self.conv1
        x = F.relu(stem["1"](stem["0"](x)))
        x = F.relu(stem["4"](stem["3"](x)))
        x = F.relu(self.bn1(stem["6"](x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            outs.append(x)
        return tuple(outs)
