"""Optimizer, learning-rate schedule and the GMFlow freeze rule.

Counterpart of :mod:`emip_tpu.train.state`. The JAX package partitions
the parameter tree and differentiates only the trainable part; here the
frozen GMFlow subtree gets ``requires_grad_(False)``, so autograd never
builds its weight grads (kernel B's backward is then asked for input
grads only) and the optimizer sees the trainable parameters only.

The optimizer is the reference's element-wise gradient clamp to +-clip
(``clip_gradient``, utils/utils.py:1-11, i.e. ``optax.clip``, not norm
clipping) followed by AdamW, whose decoupled weight decay and eps
placement are those of ``optax.adamw``. The LR schedule reproduces torch
CosineAnnealingLR stepped once per epoch before training (the
reference's quirk, train.py:384-386).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["freeze_gmflow", "ClampAdamW", "build_optimizer",
           "cosine_epoch_lr", "set_learning_rate"]


def freeze_gmflow(model: torch.nn.Module) -> torch.nn.Module:
    """Short-term training freezes the whole GMFlow subtree."""
    model.GMFlow.requires_grad_(False)
    return model


class ClampAdamW(torch.optim.AdamW):
    """Element-wise gradient clamp to [-clip, clip], then AdamW."""

    def __init__(self, params, lr: float, weight_decay: float, clip: float):
        super().__init__(params, lr=lr, weight_decay=weight_decay)
        self.clip = clip

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:  # two multi-tensor launches, not one per leaf
            torch._foreach_clamp_min_(grads, -self.clip)
            torch._foreach_clamp_max_(grads, self.clip)
        return super().step(closure)


def build_optimizer(model: torch.nn.Module, learning_rate: float = 1e-5,
                    weight_decay: float = 1e-7,
                    clip_value: float = 0.5) -> ClampAdamW:
    """Freeze GMFlow, then clamp + AdamW over the trainable parameters."""
    freeze_gmflow(model)
    return ClampAdamW([p for p in model.parameters() if p.requires_grad],
                      learning_rate, weight_decay, clip_value)


def cosine_epoch_lr(base_lr: float = 1e-5, eta_min: float = 1e-6,
                    t_max: int = 30) -> Callable[[int], float]:
    """Per-epoch LR with torch CosineAnnealingLR semantics (periodic past
    ``t_max``), stepped before the epoch: epoch e trains at the LR of
    cosine step e."""

    def lr(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * epoch / t_max)) / 2

    return lr


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
