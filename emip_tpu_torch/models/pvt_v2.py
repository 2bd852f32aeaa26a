"""PVTv2 pyramid vision transformer (counterpart of emip_tpu.models.pvt_v2).

Four stages of overlapping patch embedding + spatial-reduction attention
blocks; b5 = dims (64, 128, 320, 512), heads (1, 2, 5, 8), depths
(3, 6, 40, 3), sr (8, 4, 2, 1). Module names and ``state_dict`` keys follow
the reference's ``lib/pvt_v2.py`` (``block1.0.attn.q.weight``, ...).
``linear=True`` (``pvt_v2_b2_li``) is the reference's linear variant: at
every stage the keys are the tokens area-pooled to 7 x 7, then a 1x1 conv
(``sr``), LayerNorm (``norm``) and exact GELU, so kernel A runs on 49 keys;
its MixFFN takes a ReLU after ``fc1``.

What the JAX package does for the TPU is not carried over: no ``nn.scan``
over stacked block params (a plain loop over blocks), no remat, and exact
GELU in the MixFFN (the JAX named variants default to a polynomial fit).
Everything from ``q`` onward in the attention runs in kernel A
(:func:`emip_tpu_torch.kernels.fused_sr_attention`), forward and backward.
The MixFFN's depthwise conv + bias + GELU is the library's by default;
``PVTv2Config.fused_ffn = "always"`` runs it as kernel J
(:func:`emip_tpu_torch.kernels.fused_dwconv_gelu`) forward and backward,
``ffn_dwconv = "bwd_fused"`` keeps the library's forward and takes J's
backward (the JAX package's two switches, with its defaults; as there,
``fused_ffn`` leaves a linear block's forward on the library's conv).
In train mode each block's two residual branches take stochastic depth at
a rate ramping linearly to ``drop_path_rate`` over all blocks; its random
bits come from the ``torch.Generator`` handed to :meth:`PVTv2.forward`.
With a bf16 compute dtype (:mod:`emip_tpu_torch.dtypes`) the convs, the
linears, the GELU and the residuals run in bf16 on weights cast to bf16;
the LayerNorms keep fp32 statistics and return bf16, and kernels A and J
run their bf16 instantiations, as the JAX package's PVTv2 with
``dtype=bfloat16``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import (
    Conv2d,
    LayerNorm,
    Linear,
    cast,
    compute_dtype,
)
from emip_tpu_torch.kernels import fused_dwconv_gelu, fused_sr_attention
from emip_tpu_torch.ops.image import resize_area
from emip_tpu_torch.parallel import world

__all__ = ["PVTv2Config", "PVT_V2_VARIANTS", "PVTv2", "PVTBlock",
           "SRAttention", "MixFFN", "OverlapPatchEmbed", "drop_path"]

_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class PVTv2Config:
    embed_dims: tuple[int, ...] = (64, 128, 320, 512)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    mlp_ratios: tuple[int, ...] = (4, 4, 4, 4)
    depths: tuple[int, ...] = (3, 6, 40, 3)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    # MixFFN dwconv + GELU as kernel J: "never" | "always"
    fused_ffn: str = "never"
    # "conv": the library's conv and GELU, forward and backward;
    # "bwd_fused": the library's forward, kernel J's backward
    ffn_dwconv: str = "conv"
    # the linear variant: 7x7 pooled keys at every stage, ReLU in the MixFFN
    linear: bool = False

    def __post_init__(self):
        if self.fused_ffn not in ("never", "always"):
            raise ValueError(f"fused_ffn must be 'never' or 'always', got "
                             f"{self.fused_ffn!r}")
        if self.ffn_dwconv not in ("conv", "bwd_fused"):
            raise ValueError(f"ffn_dwconv must be 'conv' or 'bwd_fused', "
                             f"got {self.ffn_dwconv!r}")


PVT_V2_VARIANTS = {
    "pvt_v2_b0": PVTv2Config((32, 64, 160, 256), (1, 2, 5, 8), (8, 8, 4, 4),
                             (2, 2, 2, 2), (8, 4, 2, 1)),
    "pvt_v2_b1": PVTv2Config((64, 128, 320, 512), (1, 2, 5, 8), (8, 8, 4, 4),
                             (2, 2, 2, 2), (8, 4, 2, 1)),
    "pvt_v2_b2": PVTv2Config((64, 128, 320, 512), (1, 2, 5, 8), (8, 8, 4, 4),
                             (3, 4, 6, 3), (8, 4, 2, 1)),
    "pvt_v2_b2_li": PVTv2Config((64, 128, 320, 512), (1, 2, 5, 8),
                                (8, 8, 4, 4), (3, 4, 6, 3), (8, 4, 2, 1),
                                linear=True),
    "pvt_v2_b3": PVTv2Config((64, 128, 320, 512), (1, 2, 5, 8), (8, 8, 4, 4),
                             (3, 4, 18, 3), (8, 4, 2, 1)),
    "pvt_v2_b4": PVTv2Config((64, 128, 320, 512), (1, 2, 5, 8), (8, 8, 4, 4),
                             (3, 8, 27, 3), (8, 4, 2, 1)),
    "pvt_v2_b5": PVTv2Config((64, 128, 320, 512), (1, 2, 5, 8), (4, 4, 4, 4),
                             (3, 6, 40, 3), (8, 4, 2, 1)),
}


class SRAttention(nn.Module):
    """Spatial-reduction multi-head attention on tokens [B, N, C].

    The sr conv + LayerNorm that reduce the keys stay in PyTorch; the
    q / kv / proj projections and the attention are kernel A. ``linear``:
    the keys come from the tokens area-pooled to 7 x 7 (in fp32, as the
    JAX package's resize), a 1x1 ``sr`` conv, ``norm`` and exact GELU.
    """

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 qkv_bias: bool = True, linear: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.linear = linear
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if linear:
            self.sr = Conv2d(dim, dim, 1)
            self.norm = LayerNorm(dim, eps=_LN_EPS)
        elif sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        dt = compute_dtype(self)
        b, n, c = x.shape
        if self.linear:
            maps = x.transpose(1, 2).reshape(b, c, h, w)
            pooled = resize_area(maps.float(), (7, 7)).to(x.dtype)
            kv_in = self.norm(self.sr(pooled).flatten(2).transpose(1, 2))
            kv_in = F.gelu(kv_in)
        elif self.sr_ratio > 1:
            kv_in = self.sr(x.transpose(1, 2).reshape(b, c, h, w))
            kv_in = self.norm(kv_in.flatten(2).transpose(1, 2))
        else:
            kv_in = x
        return fused_sr_attention(
            x.contiguous(), kv_in.contiguous(),
            cast(self.q.weight, dt), self.q.bias, cast(self.kv.weight, dt),
            self.kv.bias, cast(self.proj.weight, dt), self.proj.bias,
            self.num_heads,
        )


class _DWConv(nn.Module):
    """3x3 depthwise conv on tokens (reference ``DWConv``; key ``dwconv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, h, w):
        b, n, c = x.shape
        y = self.dwconv(x.transpose(1, 2).reshape(b, c, h, w))
        return y.flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    """Linear (-> ReLU with ``linear``) -> 3x3 depthwise conv -> exact
    GELU -> Linear.

    ``use_fused="always"`` runs conv + bias + GELU as kernel J, except in a
    linear block (the JAX package's gate); ``dwconv_impl="bwd_fused"`` runs
    the library's forward and J's backward. The parameters and their keys
    are the same either way.
    """

    def __init__(self, dim: int, hidden: int, use_fused: str = "never",
                 dwconv_impl: str = "conv", linear: bool = False):
        super().__init__()
        self.use_fused = use_fused
        self.dwconv_impl = dwconv_impl
        self.linear = linear
        self.fc1 = Linear(dim, hidden)
        self.dwconv = _DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, h, w):
        y = self.fc1(x)
        if self.linear:
            y = F.relu(y)
        fused = self.use_fused == "always" and not self.linear
        if fused or self.dwconv_impl == "bwd_fused":
            conv = self.dwconv.dwconv
            # [F, 1, 3, 3] -> the kernel's [3, 3, F], in the compute dtype
            # (the JAX MixFFN casts the taps, so a bf16 tap grad is rounded
            # before the cast's backward widens it); the bias stays fp32
            taps = cast(conv.weight, compute_dtype(self))
            taps = taps[:, 0].permute(1, 2, 0).contiguous()
            y = fused_dwconv_gelu(
                y.contiguous(), taps, conv.bias, h, w,
                library_forward=not fused)
        else:
            y = F.gelu(self.dwconv(y, h, w))
        return self.fc2(y)


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample stochastic depth, scaled by 1/keep (timm convention, as
    the JAX package's ``_drop_path``).

    JAX draws the keep mask over the global batch. Under data parallelism
    every rank draws the ``world x B`` rows from its generator (seeded
    alike on every rank) and keeps its own ``B``, so the masks are those
    of the one-process step on the concatenated batch; with one process
    the draw is the ``B`` rows alone."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    device = generator.device if generator is not None else x.device
    rank, size = world()
    b = x.shape[0]
    u = torch.rand((size * b,) + (1,) * (x.dim() - 1), generator=generator,
                   device=device)[rank * b:(rank + 1) * b]
    return x * (torch.floor(keep + u).to(x.device, x.dtype) / keep)


class PVTBlock(nn.Module):
    """Pre-norm SR-attention + MixFFN block with stochastic depth."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 sr_ratio: int, qkv_bias: bool = True,
                 fused_ffn: str = "never", ffn_dwconv: str = "conv",
                 linear: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=_LN_EPS)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, linear)
        self.norm2 = LayerNorm(dim, eps=_LN_EPS)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), fused_ffn, ffn_dwconv,
                          linear)

    def forward(self, x, h, w, drop_rate: float = 0.0,
                generator: torch.Generator | None = None):
        if not self.training:
            drop_rate = 0.0
        x = x + drop_path(self.attn(self.norm1(x), h, w), drop_rate,
                          generator)
        return x + drop_path(self.mlp(self.norm2(x), h, w), drop_rate,
                             generator)


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv patch embedding + LayerNorm -> tokens."""

    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=stride,
                              padding=patch_size // 2)
        self.norm = LayerNorm(embed_dim, eps=_LN_EPS)

    def forward(self, x):
        x = self.proj(x)
        _, _, h, w = x.shape
        return self.norm(x.flatten(2).transpose(1, 2)), h, w


class PVTv2(nn.Module):
    """4-stage pyramid encoder; returns NCHW features at /4, /8, /16, /32."""

    feat_net_key = "pvtv2_en"

    def __init__(self, config: PVTv2Config = PVTv2Config()):
        super().__init__()
        cfg = config
        self.config = cfg
        in_chans = 3
        for i in range(len(cfg.depths)):
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(
                7 if i == 0 else 3, 4 if i == 0 else 2, in_chans,
                cfg.embed_dims[i]))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                PVTBlock(cfg.embed_dims[i], cfg.num_heads[i],
                         cfg.mlp_ratios[i], cfg.sr_ratios[i], cfg.qkv_bias,
                         cfg.fused_ffn, cfg.ffn_dwconv, cfg.linear)
                for _ in range(cfg.depths[i])))
            setattr(self, f"norm{i + 1}",
                    LayerNorm(cfg.embed_dims[i], eps=_LN_EPS))
            in_chans = cfg.embed_dims[i]

    @property
    def stage_channels(self) -> tuple[int, ...]:
        return tuple(self.config.embed_dims)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, ...]:
        cfg = self.config
        n_blocks = sum(cfg.depths)
        rates = [cfg.drop_path_rate * j / max(n_blocks - 1, 1)
                 for j in range(n_blocks)]  # np.linspace(0, rate, n)
        outs = []
        cur = 0
        for i in range(len(cfg.depths)):
            x, h, w = getattr(self, f"patch_embed{i + 1}")(x)
            for blk in getattr(self, f"block{i + 1}"):
                x = blk(x, h, w, rates[cur], generator)
                cur += 1
            x = getattr(self, f"norm{i + 1}")(x)
            x = x.transpose(1, 2).reshape(x.shape[0], -1, h, w)
            outs.append(x)
        return tuple(outs)
