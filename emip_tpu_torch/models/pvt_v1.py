"""PVT-v1 pyramid vision transformer (counterpart of emip_tpu.models.pvt_v1).

The reference's selectable PVT-v1 encoder (``lib/pvt.py``): four stages of
non-overlapping patch embedding with LayerNorm, a learned position table
at the 224 grid (56², 28², 14², 7²; stage 4's has a cls slot in front that
the dense path skips) resized bilinearly (``align_corners=False``) where
the grid differs, then blocks of spatial-reduction attention and a plain
MLP with exact GELU. ``state_dict`` keys follow ``lib/pvt.py``
(``patch_embed1.proj``, ``pos_embed1`` [1, N, C], ``block1.0.attn.q``).

This attention is the JAX module's own XLA spelling, not kernel A's, and
runs as plain PyTorch on the card too: in bf16 its rounding points differ
from A's bf16 form. The LayerNorms compute and return fp32 whatever the
compute dtype (flax's ``LayerNorm(dtype=float32)``), so in the bf16 band
the residual stream, the keys' input and the attention probabilities stay
fp32; q, k, v and the linears' outputs are bf16, the scores are summed in
fp32 and P v in fp32 on v upcast, and ``proj`` casts o to bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import Conv2d, Linear
from emip_tpu_torch.models.pvt_v2 import drop_path
from emip_tpu_torch.ops.image import resize_bilinear

__all__ = ["PVTv1Config", "PVT_V1_VARIANTS", "PVTv1", "PVTv1Block"]

_LN_EPS = 1e-6
_PRETRAIN_SIZE = 224  # the image size of the position tables' grids


@dataclasses.dataclass(frozen=True)
class PVTv1Config:
    embed_dims: tuple[int, ...] = (64, 128, 320, 512)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    mlp_ratios: tuple[int, ...] = (8, 8, 4, 4)
    depths: tuple[int, ...] = (3, 4, 6, 3)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    drop_path_rate: float = 0.1


PVT_V1_VARIANTS = {
    "pvt_tiny": PVTv1Config(depths=(2, 2, 2, 2)),
    "pvt_small": PVTv1Config(depths=(3, 4, 6, 3)),
    "pvt_medium": PVTv1Config(depths=(3, 4, 18, 3)),
    "pvt_large": PVTv1Config(depths=(3, 8, 27, 3)),
}


class _LayerNorm32(nn.LayerNorm):
    """LayerNorm that computes and returns fp32 whatever its input."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class _Attention(nn.Module):
    """Spatial-reduction multi-head attention on tokens [B, N, C]."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = _LayerNorm32(dim, eps=_LN_EPS)

    def forward(self, y: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = y.shape
        heads = self.num_heads
        ch = c // heads
        q = self.q(y).reshape(b, n, heads, ch).transpose(1, 2)
        kv_in = y
        if self.sr_ratio > 1:
            kv_in = self.sr(y.transpose(1, 2).reshape(b, c, h, w))
            kv_in = self.norm(kv_in.flatten(2).transpose(1, 2))
        kv = self.kv(kv_in).reshape(b, -1, 2, heads, ch)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        attn = torch.softmax(q.float() @ k.float().transpose(-1, -2)
                             * ch**-0.5, dim=-1)
        o = attn @ v.float()
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class PVTv1Block(nn.Module):
    """Pre-norm SR-attention + plain MLP, stochastic depth in train mode."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 sr_ratio: int):
        super().__init__()
        self.norm1 = _LayerNorm32(dim, eps=_LN_EPS)
        self.attn = _Attention(dim, num_heads, sr_ratio)
        self.norm2 = _LayerNorm32(dim, eps=_LN_EPS)
        self.mlp = _Mlp(dim, dim * mlp_ratio)

    def forward(self, x, h, w, drop_rate: float = 0.0,
                generator: torch.Generator | None = None):
        if not self.training:
            drop_rate = 0.0
        x = x + drop_path(self.attn(self.norm1(x), h, w), drop_rate,
                          generator)
        return x + drop_path(self.mlp(self.norm2(x)), drop_rate, generator)


class _PatchEmbed(nn.Module):
    """Non-overlapping conv patch embedding + fp32 LayerNorm -> tokens."""

    def __init__(self, patch: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch, stride=patch)
        self.norm = _LayerNorm32(embed_dim, eps=_LN_EPS)

    def forward(self, x):
        x = self.proj(x)
        _, _, h, w = x.shape
        return self.norm(x.flatten(2).transpose(1, 2)), h, w


class PVTv1(nn.Module):
    """4-stage pyramid encoder; returns NCHW features at /4, /8, /16, /32
    (fp32 in either compute dtype)."""

    feat_net_key = "pvtv1_en"

    def __init__(self, config: PVTv1Config = PVTv1Config()):
        super().__init__()
        cfg = config
        self.config = cfg
        in_chans = 3
        for i in range(4):
            dim = cfg.embed_dims[i]
            grid = _PRETRAIN_SIZE // (4 * 2**i)
            setattr(self, f"patch_embed{i + 1}",
                    _PatchEmbed(4 if i == 0 else 2, in_chans, dim))
            setattr(self, f"pos_embed{i + 1}", nn.Parameter(torch.zeros(
                1, grid * grid + (1 if i == 3 else 0), dim)))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                PVTv1Block(dim, cfg.num_heads[i], cfg.mlp_ratios[i],
                           cfg.sr_ratios[i])
                for _ in range(cfg.depths[i])))
            in_chans = dim

    @property
    def stage_channels(self) -> tuple[int, ...]:
        return tuple(self.config.embed_dims)

    def _position(self, i: int, h: int, w: int) -> torch.Tensor:
        """Stage ``i``'s table on an h x w grid, [1, h*w, C]."""
        pos = getattr(self, f"pos_embed{i + 1}")[0]
        if i == 3:
            pos = pos[1:]  # the cls slot
        grid = _PRETRAIN_SIZE // (4 * 2**i)
        table = pos.reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
        table = resize_bilinear(table, (h, w), align_corners=False)
        return table.flatten(2).transpose(1, 2)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        cfg = self.config
        n_blocks = sum(cfg.depths)
        rates = [cfg.drop_path_rate * j / max(n_blocks - 1, 1)
                 for j in range(n_blocks)]  # np.linspace(0, rate, n)
        outs, cur = [], 0
        for i in range(4):
            x, h, w = getattr(self, f"patch_embed{i + 1}")(x)
            x = x + self._position(i, h, w)
            for blk in getattr(self, f"block{i + 1}"):
                x = blk(x, h, w, rates[cur], generator)
                cur += 1
            x = x.transpose(1, 2).reshape(x.shape[0], -1, h, w)
            outs.append(x)
        return tuple(outs)
