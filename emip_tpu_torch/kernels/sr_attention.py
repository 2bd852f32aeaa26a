"""Kernel A: fused PVTv2 spatial-reduction attention (forward).

Port of :func:`emip_tpu.ops.pallas.sr_attention.fused_sr_attention`; the
CUDA source is ``csrc/sr_attention.cu``. Weights are in torch
``nn.Linear`` layout ([out, in]).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_sr_attention", "fused_sr_attention_reference"]

_HEAD_DIMS = (64,)  # pvt_v2_b5: 64-d heads at every stage


def fused_sr_attention_reference(x, kv_in, wq, bq, wkv, bkv, wp, bp,
                                 num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_sr_attention`."""
    b, n, c = x.shape
    m = kv_in.shape[1]
    ch = c // num_heads
    q = F.linear(x, wq, bq).reshape(b, n, num_heads, ch).transpose(1, 2)
    kv = F.linear(kv_in, wkv, bkv).reshape(b, m, 2, num_heads, ch)
    k = kv[:, :, 0].transpose(1, 2)
    v = kv[:, :, 1].transpose(1, 2)
    attn = torch.softmax(q @ k.transpose(-1, -2) * ch**-0.5, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(b, n, c)
    return F.linear(o, wp, bp)


def fused_sr_attention(x: torch.Tensor, kv_in: torch.Tensor,
                       wq: torch.Tensor, bq: torch.Tensor,
                       wkv: torch.Tensor, bkv: torch.Tensor,
                       wp: torch.Tensor, bp: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """proj(multi-head-attn(q(x), kv(kv_in))) -> [B, N, C].

    x: [B, N, C] normalized tokens; kv_in: [B, M, C] reduced tokens;
    wq, wp: [C, C]; wkv: [2C, C]; biases [C] / [2C].
    """
    name = "fused_sr_attention"
    args = dict(x=x, kv_in=kv_in, wq=wq, bq=bq, wkv=wkv, bkv=bkv, wp=wp,
                bp=bp)
    if cm.on_cpu(name, *args.values()):
        return fused_sr_attention_reference(x, kv_in, wq, bq, wkv, bkv, wp,
                                            bp, num_heads)
    cm.check_kernel_args(name, **args)
    if x.dim() != 3 or kv_in.dim() != 3:
        raise ValueError(f"{name}: x and kv_in must be [B, N, C] / [B, M, C]")
    b, n, c = x.shape
    m = kv_in.shape[1]
    if c % num_heads or c // num_heads not in _HEAD_DIMS:
        raise ValueError(f"{name}: head width {c}/{num_heads} not in "
                         f"{_HEAD_DIMS}")
    if n == 0 or m == 0:
        raise ValueError(f"{name}: empty token axis (N={n}, M={m})")
    cm.check_shape(name, "kv_in", kv_in, (b, m, c))
    cm.check_shape(name, "wq", wq, (c, c))
    cm.check_shape(name, "bq", bq, (c,))
    cm.check_shape(name, "wkv", wkv, (2 * c, c))
    cm.check_shape(name, "bkv", bkv, (2 * c,))
    cm.check_shape(name, "wp", wp, (c, c))
    cm.check_shape(name, "bp", bp, (c,))

    lib = library()
    q_buf = torch.empty_like(x)
    kv_buf = torch.empty((b, m, 2 * c), device=x.device, dtype=x.dtype)
    o_buf = torch.empty_like(x)
    out = torch.empty_like(x)
    rc = lib.emip_sr_attention(
        x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), bq.data_ptr(),
        wkv.data_ptr(), bkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        q_buf.data_ptr(), kv_buf.data_ptr(), o_buf.data_ptr(),
        out.data_ptr(), b, n, m, c, num_heads, cm.stream_handle(x.device))
    cm.raise_on_error(name, rc)
    cm.LAUNCHES["sr_attention"] += 1
    return out
