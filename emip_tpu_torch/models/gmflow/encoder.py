"""GMFlow CNN feature encoder at 1/8 resolution, instance-normalized.

Counterpart of :mod:`emip_tpu.models.gmflow.encoder` (reference
``gmflow/backbone.py``): 7x7 stem + three stages of two residual blocks
(64 -> 96 -> 128 channels) + 1x1 projection. The reference's adaptor
convs (``dwconv64/96/128``, ``dwconv_pre/dwconv/dwconv_post``) are
declared for the checkpoint's key space and never applied. With a bf16
compute dtype (:mod:`emip_tpu_torch.dtypes`) the convs and the residual
adds run in bf16 and each InstanceNorm takes fp32 statistics and returns
bf16, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import Conv2d

__all__ = ["instance_norm", "ResidualBlock", "CNNEncoder"]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W (no affine), with
    fp32 statistics, returned in ``x``'s dtype."""
    return F.instance_norm(x.float(), eps=eps).to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            # Sequential(conv, norm) in the reference: key downsample.0
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride))

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    def __init__(self, output_dim: int = 128):
        super().__init__()
        dims = (64, 96, 128)
        self.conv1 = Conv2d(3, dims[0], 7, stride=2, padding=3, bias=False)
        in_planes = dims[0]
        for i, (dim, stride) in enumerate(((dims[0], 1), (dims[1], 2),
                                           (dims[2], 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(in_planes, dim, stride),
                ResidualBlock(dim, dim, 1)))
            in_planes = dim
        self.conv2 = Conv2d(dims[2], output_dim, 1)
        # dead-but-checkpointed adaptor convs (never applied)
        hidden = 16
        self.dwconv64 = nn.Conv2d(64, 64, 3, padding=1, groups=64)
        self.dwconv96 = nn.Conv2d(96, 96, 3, padding=1, groups=96)
        self.dwconv128 = nn.Conv2d(128, 128, 3, padding=1, groups=128)
        self.dwconv_pre = nn.Conv2d(64, hidden, 3, padding=1, bias=False)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.dwconv_post = nn.Conv2d(hidden, 64, 3, padding=1, bias=False)

    def forward(self, x) -> list[torch.Tensor]:
        x = F.relu(instance_norm(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return [self.conv2(x)]
