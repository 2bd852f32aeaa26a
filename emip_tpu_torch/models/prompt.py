"""Prompt-interaction modules: the MDTA cross-attention Injector.

Counterpart of :mod:`emip_tpu.models.prompt` (reference
``motion/PromptInteract.py``: ``Injector`` wrapping ``TransformerBlock_MDTA``
under the key ``transformer``). NCHW layout; the attention runs over
channels, a [C/h, C/h] matrix per head, so it has no kernel of its own.
With a bf16 compute dtype (:mod:`emip_tpu_torch.dtypes`) the convs and the
GELU gate run in bf16, the channel LayerNorms and the L2 normalisation in
fp32 (rounded after), and the attention's two products accumulate in fp32
with its softmax, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import Conv2d, compute_dtype

__all__ = ["ChannelLayerNorm", "MDTAttention", "GatedDConvFFN", "Injector"]


class _WithBiasLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class ChannelLayerNorm(nn.Module):
    """WithBias LayerNorm over the channel axis of NCHW features, eps 1e-5.

    Parameters live under ``body`` as in the reference.
    """

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.body = _WithBiasLayerNorm(dim)

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1).float(), (x.shape[1],),
                         self.body.weight, self.body.bias, self.eps)
        return y.permute(0, 3, 1, 2).to(x.dtype)


def _dwconv(ch: int) -> Conv2d:
    return Conv2d(ch, ch, 3, padding=1, groups=ch, bias=False)


class MDTAttention(nn.Module):
    """Multi-dconv-head transposed (channel) cross-attention.

    q from ``x``; k, v from ``ctx``; q and k L2-normalized along pixels,
    a learned per-head temperature.
    """

    def __init__(self, dim: int, num_heads: int = 2):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.q = Conv2d(dim, dim, 1, bias=False)
        self.q_dwconv = _dwconv(dim)
        self.kv = Conv2d(dim, 2 * dim, 1, bias=False)
        self.kv_dwconv = _dwconv(2 * dim)
        self.project_out = Conv2d(dim, dim, 1, bias=False)

    def forward(self, x, ctx):
        dt = compute_dtype(self)
        b, c, h, w = x.shape
        heads = self.num_heads
        q = self.q_dwconv(self.q(x))
        k, v = self.kv_dwconv(self.kv(ctx)).chunk(2, dim=1)
        q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in (q, k, v))
        q = F.normalize(q.float(), dim=-1).to(dt)
        k = F.normalize(k.float(), dim=-1).to(dt)
        attn = torch.softmax(
            q.float() @ k.float().transpose(-1, -2) * self.temperature,
            dim=-1)
        out = (attn.to(dt).float() @ v.float()).to(dt).reshape(b, c, h, w)
        return self.project_out(out)


class GatedDConvFFN(nn.Module):
    """Gated-dconv feed-forward network (GDFN), exact GELU gate."""

    def __init__(self, dim: int, expansion: float = 2.66):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv2d(dim, 2 * hidden, 1, bias=False)
        self.dwconv = _dwconv(2 * hidden)
        self.project_out = Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x):
        y1, y2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(y1) * y2)


class _MDTABlock(nn.Module):
    def __init__(self, dim, num_heads, ffn_expansion):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.norm3 = ChannelLayerNorm(dim)
        self.attn = MDTAttention(dim, num_heads)
        self.ffn = GatedDConvFFN(dim, ffn_expansion)

    def forward(self, x, ctx):
        x = x + self.attn(self.norm1(x), self.norm2(ctx))
        return x + self.ffn(self.norm3(x))


class Injector(nn.Module):
    """One MDTA cross-attention block: inject ``ctx`` features into ``x``."""

    def __init__(self, dim: int = 128, num_heads: int = 2,
                 ffn_expansion: float = 2.66):
        super().__init__()
        self.transformer = _MDTABlock(dim, num_heads, ffn_expansion)

    def forward(self, x, ctx):
        return self.transformer(x, ctx)
