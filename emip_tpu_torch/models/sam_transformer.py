"""SAM-style two-way transformer, the engine of the SAM prompt heads.

Counterpart of :mod:`emip_tpu.models.sam_transformer` (the reference's
``model/EMIP_short/motion/transformer.py``, the Segment-Anything
mask-decoder transformer): attention in both directions between a few
query tokens and the image tokens, with downsampled attention heads and an
MLP block, then a last token -> image attention. The module tree and the
``state_dict`` keys are the reference's (``layers.{i}.self_attn.q_proj``,
``norm1``-``norm4``, ``mlp.lin1``, ``final_attn_token_to_image``,
``norm_final_attn``); the image embedding enters NCHW [B, C, H, W], the
tokens [B, N, C].

The JAX package computes the attention in XLA, not in a Pallas kernel, so
here it is plain ``matmul`` and ``softmax``: q kᵀ summed in fp32, the
softmax in fp32, P cast to the compute dtype before P v (summed in fp32),
as the JAX einsums with ``preferred_element_type=float32`` do. The
LayerNorms are flax's (epsilon 1e-6, not torch's 1e-5) with
``dtype=float32``: they compute and return fp32 whatever their input, so
the token and image streams are fp32 between the blocks, also in the bf16
band, where each ``Linear`` casts its input and weights to bf16
(:mod:`emip_tpu_torch.dtypes`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import Linear

__all__ = ["DownsampledAttention", "MLPBlock", "TwoWayAttentionBlock",
           "TwoWayTransformer", "LayerNorm32"]

LN_EPS = 1e-6  # flax's LayerNorm


class LayerNorm32(nn.LayerNorm):
    """flax's ``LayerNorm(dtype=float32)``: fp32 statistics and output
    whatever the input's dtype, epsilon 1e-6."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class DownsampledAttention(nn.Module):
    """Multi-head attention on ``embedding_dim / downsample_rate``
    channels (the reference's ``Attention``)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(embedding_dim, self.internal_dim)
        self.k_proj = Linear(embedding_dim, self.internal_dim)
        self.v_proj = Linear(embedding_dim, self.internal_dim)
        self.out_proj = Linear(self.internal_dim, embedding_dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.reshape(b, n, self.num_heads, -1).transpose(1, 2)

    def forward(self, q, k, v):
        q = self.q_proj(q)
        k, v = self._heads(self.k_proj(k)), self._heads(self.v_proj(v))
        dt, qh = q.dtype, self._heads(q)
        attn = torch.matmul(qh.float(), k.float().transpose(-1, -2)
                            ) / math.sqrt(qh.shape[-1])
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(dt).float(), v.float())
        b, _, n, _ = out.shape
        out = out.transpose(1, 2).reshape(b, n, self.internal_dim)
        return self.out_proj(out.to(dt))


class MLPBlock(nn.Module):
    """lin1 -> ReLU -> lin2."""

    def __init__(self, embedding_dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = Linear(embedding_dim, mlp_dim)
        self.lin2 = Linear(mlp_dim, embedding_dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    """Self-attention of the tokens, tokens -> image, the tokens' MLP,
    image -> tokens; a LayerNorm after each."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = DownsampledAttention(embedding_dim, num_heads)
        self.norm1 = LayerNorm32(embedding_dim)
        self.cross_attn_token_to_image = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm32(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim)
        self.norm3 = LayerNorm32(embedding_dim)
        self.norm4 = LayerNorm32(embedding_dim)
        self.cross_attn_image_to_token = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """``depth`` two-way blocks, then the final token -> image attention.

    ``forward(image_embedding, image_pe, point_embedding)``: the image and
    its positional encoding NCHW [B, C, H, W], the tokens [B, N, C];
    returns (queries [B, N, C], keys [B, H*W, C])."""

    def __init__(self, depth: int = 2, embedding_dim: int = 128,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = LayerNorm32(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
