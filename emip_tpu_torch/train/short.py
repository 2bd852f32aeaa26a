"""Train and eval steps of the short-term two-stream model.

Counterpart of :mod:`emip_tpu.train.short`: forward in train mode (both
streams, flow estimation with its pre-propagation prediction, decode),
hybrid-E segmentation loss + unsupervised photometric flow loss, backward
over the trainable parameters (GMFlow frozen, see
:func:`emip_tpu_torch.train.state.build_optimizer`), element-wise clamp
and AdamW. On the card the backward runs through kernels A-D's backward
kernels and the occlusion mask through kernel E.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.losses.flow import unsup_flow_loss
from emip_tpu_torch.losses.seg import hybrid_e_loss

__all__ = ["short_losses", "short_train_step", "short_eval_step"]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def short_losses(model, batch: dict, generator=None) -> dict:
    """Forward and both losses; batch holds NCHW ``image1``, ``image2``
    (ImageNet-normalised) and ``gt`` [B, 1, H, W] in [0, 1]."""
    img1, img2 = batch["image1"], batch["image2"]
    mask, flow_fw, flow_bw = model(img1, img2, generator=generator)
    loss_pred = hybrid_e_loss(mask, batch["gt"])
    flows = [(_nhwc(f), _nhwc(b)) for f, b in zip(flow_fw, flow_bw)]
    loss_flow, _, mean_abs = unsup_flow_loss(flows, _nhwc(img1), _nhwc(img2))
    return dict(loss=loss_pred + loss_flow, loss_pred=loss_pred,
                loss_flow=loss_flow, mean_abs_flow=mean_abs)


def short_train_step(model, opt, batch: dict, generator=None) -> dict:
    """One optimisation step; returns the detached losses (no host sync)."""
    model.train()
    out = short_losses(model, batch, generator)
    opt.zero_grad(set_to_none=True)
    out["loss"].backward()
    opt.step()
    return {k: v.detach() for k, v in out.items()}


@torch.no_grad()
def short_eval_step(model, img1: torch.Tensor,
                    img2: torch.Tensor) -> torch.Tensor:
    """Eval-mode mask logits [B, 1, H, W] at the input resolution."""
    model.eval()
    mask, _, _ = model(img1, img2)
    return mask
