"""Supervised segmentation loss: BCE + enhanced-alignment + soft IoU.

Counterpart of :func:`emip_tpu.losses.seg.hybrid_e_loss` (reference
``loss/loss_pred.py``). pred: [N, 1, H, W] logits; mask: [N, 1, H, W] in
[0, 1]. All reductions in fp32.
"""

from __future__ import annotations

import torch

__all__ = ["hybrid_e_loss"]


def hybrid_e_loss(pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    pred = pred.float()
    mask = mask.float()
    dims = (2, 3)

    # binary cross entropy with logits, mean over everything
    wbce = torch.mean(torch.clamp(pred, min=0.0) - pred * mask
                      + torch.log1p(torch.exp(-pred.abs())))

    p = torch.sigmoid(pred)
    # enhanced-alignment term: correlate de-meaned prediction and GT
    phi_fm = p - p.mean(dim=dims, keepdim=True)
    phi_gt = mask - mask.mean(dim=dims, keepdim=True)
    efm = (2.0 * phi_fm * phi_gt + 1e-8) / (phi_fm * phi_fm
                                            + phi_gt * phi_gt + 1e-8)
    qfm = (1.0 + efm) ** 2 / 4.0
    eloss = 1.0 - qfm.mean(dim=dims)

    # soft IoU
    inter = (p * mask).sum(dim=dims)
    union = (p + mask).sum(dim=dims)
    wiou = 1.0 - (inter + 1.0 + 1e-8) / (union - inter + 1.0 + 1e-8)

    return wbce + torch.mean(eloss + wiou)
