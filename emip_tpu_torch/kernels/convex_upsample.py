"""Kernel D: RAFT convex x K flow upsampling (forward).

Port of :func:`emip_tpu.ops.pallas.convex_upsample.convex_upsample_pallas`;
the CUDA source is ``csrc/convex_upsample.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["convex_upsample", "convex_upsample_reference"]


def convex_upsample_reference(flow, mask_logits, k: int = 8) -> torch.Tensor:
    """Plain PyTorch version of :func:`convex_upsample`."""
    b, h, w, _ = flow.shape
    pad = F.pad(flow * k, (0, 0, 1, 1, 1, 1))
    nb = torch.stack([pad[:, dy:dy + h, dx:dx + w, :]
                      for dy in range(3) for dx in range(3)], dim=3)
    weights = torch.softmax(mask_logits.reshape(b, h, w, 9, k, k), dim=3)
    up = torch.einsum("bhwnkl,bhwnc->bhwklc", weights, nb)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * k, w * k, 2)


def convex_upsample(flow: torch.Tensor, mask_logits: torch.Tensor,
                    k: int = 8) -> torch.Tensor:
    """Convex-combination flow upsample by ``k``.

    flow: [B, h, w, 2]; mask_logits: [B, h, w, 9*k*k] with channels ordered
    (neighbour, sub_row, sub_col). Returns [B, h*k, w*k, 2] (fp32).
    """
    name = "convex_upsample"
    if cm.on_cpu(name, flow, mask_logits):
        return convex_upsample_reference(flow, mask_logits, k)
    cm.check_kernel_args(name, flow=flow, mask_logits=mask_logits)
    if flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"{name}: flow must be [B, h, w, 2]")
    b, h, w, _ = flow.shape
    cm.check_shape(name, "mask_logits", mask_logits, (b, h, w, 9 * k * k))

    lib = library()
    out = torch.empty((b, h * k, w * k, 2), device=flow.device,
                      dtype=flow.dtype)
    rc = lib.emip_convex_upsample(
        flow.data_ptr(), mask_logits.data_ptr(), out.data_ptr(), b, h, w, k,
        cm.stream_handle(flow.device))
    cm.raise_on_error(name, rc)
    cm.LAUNCHES["convex_upsample"] += 1
    return out
