"""Long-term memory (LTM): the space-time-memory prompt buffer, NCHW.

Counterpart of :mod:`emip_tpu.models.ltm` (reference
``model/EMIP_long/LTM.py``): key / value maps are computed from the fused
(segmentation feature + correlation prompt) map of each past frame;
reading attends the query frame's key over all memory keys (softmax over
time x space, kernel F) and returns the weighted value sum concatenated
with the query value.

The rolling "last <= 5 frames" buffer is a fixed-shape ring with a
per-slot validity flag, slots ordered oldest to newest, as in the JAX
package. The feature maps are NCHW here, but the ring is stored
token-major, ``[B, T, H*W, C]``: flattened it is the ``[B, T*H*W, C]`` key
and value matrix of the read (slot-major, then row-major pixel), so a
frame's read needs no transpose of the ring.

With a bf16 compute dtype (:mod:`emip_tpu_torch.dtypes`) the key / value
heads and the fusion's convs run in bf16, its BatchNorm in fp32, as in the
JAX package; the ring stays fp32 (the bf16 keys and values are widened,
exactly, when pushed) and the read takes the bf16 query key against it
(kernel F's bf16 instantiation), its fp32 result cast to the query
value's dtype.

Module and ``state_dict`` names follow the reference:
``KV_M_r4.{Key,Value}``, ``KV_Q_r4.{Key,Value}``,
``fusion.conv1_fusion.{0,1,3}``. The reference's ``fusion.conv1_m`` branch
never runs and its shape is not recorded in this repository, so it is not
built.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from emip_tpu_torch.dtypes import BatchNorm2d, Conv2d
from emip_tpu_torch.kernels.memory_attention import masked_memory_attention

__all__ = ["MemoryState", "KeyValueHead", "FusePrompt", "memory_read", "LTM"]

MASKED = -1e9  # additive score of a key in an empty slot


def tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] feature map -> [B, H*W, C] tokens, row-major pixels."""
    return x.flatten(2).transpose(1, 2).contiguous()


class MemoryState(NamedTuple):
    """Fixed-shape rolling memory: slots ordered oldest -> newest."""

    keys: torch.Tensor    # [B, T_max, H*W, Ck]
    values: torch.Tensor  # [B, T_max, H*W, Cv]
    valid: torch.Tensor   # [B, T_max] bool

    @classmethod
    def zeros(cls, batch: int, t_max: int, h: int, w: int,
              key_dim: int = 128, val_dim: int = 128,
              dtype=torch.float32, device=None) -> "MemoryState":
        return cls(
            keys=torch.zeros(batch, t_max, h * w, key_dim, dtype=dtype,
                             device=device),
            values=torch.zeros(batch, t_max, h * w, val_dim, dtype=dtype,
                               device=device),
            valid=torch.zeros(batch, t_max, dtype=torch.bool, device=device))

    def push(self, key: torch.Tensor, value: torch.Tensor) -> "MemoryState":
        """Append a frame's token-major (key, value) [B, H*W, C] in the
        ring's dtype (a bf16 key is widened exactly, as the JAX ring's
        ``.at[].set`` casts it), evicting the oldest slot. Out of place:
        the old state stays whole."""
        newest = torch.ones_like(self.valid[:, :1])
        key, value = key.to(self.keys.dtype), value.to(self.values.dtype)
        return MemoryState(
            torch.cat([self.keys[:, 1:], key[:, None]], dim=1),
            torch.cat([self.values[:, 1:], value[:, None]], dim=1),
            torch.cat([self.valid[:, 1:], newest], dim=1))


class KeyValueHead(nn.Module):
    """Parallel 3x3 conv key / value heads (reference LTM.py:71-79)."""

    def __init__(self, in_dim: int, key_dim: int = 128, val_dim: int = 128):
        super().__init__()
        self.Key = Conv2d(in_dim, key_dim, 3, padding=1)
        self.Value = Conv2d(in_dim, val_dim, 3, padding=1)

    def forward(self, x):
        return self.Key(x), self.Value(x)


class FusePrompt(nn.Module):
    """Fuse seg feature + correlation prompt: add, then a conv bottleneck
    dim -> 512 -> 128 (reference LTM.py:26-41 ``fusion``); the convs in
    the compute dtype, the BatchNorm in fp32."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.conv1_fusion = nn.Sequential(
            Conv2d(dim, 512, 3, padding=1), BatchNorm2d(512),
            nn.ReLU(inplace=True), Conv2d(512, 128, 3, padding=1))

    def forward(self, feat, prompt):
        return self.conv1_fusion(feat + prompt)


def memory_read(state: MemoryState, q_key: torch.Tensor,
                q_value: torch.Tensor) -> torch.Tensor:
    """Attend the query key over all written memory slots; concat with the
    query value. q_key, q_value: [B, C, H, W]; returns [B, Cv + Cq, H, W]
    (reference LTM.py:44-68 ``Memory.forward``).

    CUDA tensors take kernel F, CPU tensors its plain version
    (:func:`masked_memory_attention`): the [B, H*W, T*H*W] scores never
    reach device memory. The bias stays fp32 and the read fp32 whatever
    the query's dtype; the result takes the query value's (JAX
    ``ltm.py:memory_read``)."""
    b, t, hw, ck = state.keys.shape
    cv = state.values.shape[-1]
    h, w = q_key.shape[2:]
    bias = torch.where(state.valid, 0.0, MASKED).to(torch.float32)
    bias = bias[:, :, None].expand(b, t, hw).reshape(b, t * hw)
    mem = masked_memory_attention(
        tokens(q_key), state.keys.reshape(b, t * hw, ck),
        state.values.reshape(b, t * hw, cv), bias)
    mem = mem.transpose(1, 2).reshape(b, cv, h, w)
    return torch.cat([mem.to(q_value.dtype), q_value], dim=1)


class LTM(nn.Module):
    """Key / value heads + fusion of the space-time-memory prompt buffer."""

    def __init__(self, dim: int = 128, key_dim: int = 128,
                 val_dim: int = 128):
        super().__init__()
        self.KV_M_r4 = KeyValueHead(128, key_dim, val_dim)
        self.KV_Q_r4 = KeyValueHead(dim, key_dim, val_dim)
        self.fusion = FusePrompt(dim)

    def memorize(self, feat8, corr_emb):
        """Token-major key / value maps [B, H*W, C] of a past frame
        (reference LTM.py:103-111)."""
        k, v = self.KV_M_r4(self.fusion(feat8, corr_emb))
        return tokens(k), tokens(v)

    def read(self, state: MemoryState, feat8):
        """Memory read for the query frame (reference LTM.py:122-132)."""
        q_key, q_value = self.KV_Q_r4(feat8)
        return memory_read(state, q_key, q_value)
