"""Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v (forward).

Port of :func:`emip_tpu.ops.pallas.corr_softmax.fused_flow_attention`; the
CUDA source is ``csrc/flow_attention.cu``.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_flow_attention", "fused_flow_attention_reference"]

_WIDTHS = (128,)  # GMFlow width = pvt_v2_b5's /8 width
_VALUE_WIDTH = 2


def fused_flow_attention_reference(q, k, v) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_flow_attention`."""
    c = q.shape[-1]
    scores = q @ k.transpose(-1, -2) / c**0.5
    return torch.softmax(scores, dim=-1) @ v


def fused_flow_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q, k: [B, L, C]; v: [B, L, 2]. Returns [B, L, 2] (fp32)."""
    name = "fused_flow_attention"
    if cm.on_cpu(name, q, k, v):
        return fused_flow_attention_reference(q, k, v)
    cm.check_kernel_args(name, q=q, k=k, v=v)
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [B, L, C]")
    b, l, c = q.shape
    if c not in _WIDTHS:
        raise ValueError(f"{name}: channel width {c} not in {_WIDTHS}")
    if l == 0:
        raise ValueError(f"{name}: empty token axis")
    cm.check_shape(name, "k", k, (b, l, c))
    cm.check_shape(name, "v", v, (b, l, _VALUE_WIDTH))

    lib = library()
    out = torch.empty((b, l, _VALUE_WIDTH), device=q.device, dtype=q.dtype)
    rc = lib.emip_flow_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, c,
        _VALUE_WIDTH, cm.stream_handle(q.device))
    cm.raise_on_error(name, rc)
    cm.LAUNCHES["flow_attention"] += 1
    return out
