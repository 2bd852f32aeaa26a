"""Seeded random initialisation of the port's models (no checkpoint yet)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ["seeded_init_"]


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Re-initialise every parameter from one ``torch.Generator``.

    Weights (>= 2 dims) get normals scaled by 1/sqrt(fan_in); norm scales
    and attention temperatures 1; biases 0. Values are drawn on the CPU,
    so a seed gives the same weights on every device.
    """
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            fan_in = p[0].numel()
            val = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        elif name.endswith("bias"):
            val = torch.zeros(p.shape)
        else:
            val = torch.ones(p.shape)
        p.copy_(val.to(p.device))
    return model
