"""Flow feature transformer and flow propagation.

Counterpart of :mod:`emip_tpu.models.gmflow.transformer` (reference
``gmflow/transformer.py``). Features are channel-last [B, H, W, C] inside
the transformer, as in the JAX code. Each ``TransformerBlock`` (a
self-attention layer and a cross-attention + FFN layer) runs as kernel B
(:func:`emip_tpu_torch.kernels.fused_window_attention_block`); the
shifted-window roll and the window split stay outside it. Flow
propagation is kernel C. LayerNorms use eps 1e-6, the JAX package's flax
default (the reference's torch modules use 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from emip_tpu_torch.kernels import (
    fused_flow_attention,
    fused_window_attention_block,
)
from emip_tpu_torch.ops.window import (
    shifted_window_mask,
    window_merge_tokens,
    window_split_tokens,
)

__all__ = ["TransformerLayer", "TransformerBlock", "FeatureTransformer",
           "FeatureFlowAttention"]

_LN_EPS = 1e-6


class TransformerLayer(nn.Module):
    """Parameters of one attention layer (reference key layout).

    The forward of the pair of layers is kernel B, driven by
    :class:`TransformerBlock`; ``adaptor_fc1/2`` are dead in the reference
    and only present for its checkpoints.
    """

    def __init__(self, d_model: int, no_ffn: bool = False,
                 ffn_dim_expansion: int = 4):
        super().__init__()
        c = d_model
        self.q_proj = nn.Linear(c, c, bias=False)
        self.k_proj = nn.Linear(c, c, bias=False)
        self.v_proj = nn.Linear(c, c, bias=False)
        self.merge = nn.Linear(c, c, bias=False)
        self.norm1 = nn.LayerNorm(c, eps=_LN_EPS)
        if not no_ffn:
            f = 2 * c * ffn_dim_expansion
            self.mlp = nn.Sequential(nn.Linear(2 * c, f, bias=False),
                                     nn.GELU(),
                                     nn.Linear(f, c, bias=False))
            self.norm2 = nn.LayerNorm(c, eps=_LN_EPS)
        self.adaptor_fc1 = nn.Linear(c, c // 4)
        self.adaptor_fc2 = nn.Linear(c // 4, c)

    def kernel_params(self) -> dict:
        p = dict(wq=self.q_proj.weight, wk=self.k_proj.weight,
                 wv=self.v_proj.weight, wm=self.merge.weight,
                 s1=self.norm1.weight, b1=self.norm1.bias)
        if hasattr(self, "mlp"):
            p.update(w0=self.mlp[0].weight, w2=self.mlp[2].weight,
                     s2=self.norm2.weight, b2=self.norm2.bias)
        return p


class TransformerBlock(nn.Module):
    """Self-attention (no FFN) + cross-attention (with FFN), kernel B."""

    def __init__(self, d_model: int, ffn_dim_expansion: int = 4,
                 with_shift: bool = False):
        super().__init__()
        self.with_shift = with_shift
        self.self_attn = TransformerLayer(d_model, no_ffn=True,
                                          ffn_dim_expansion=ffn_dim_expansion)
        self.cross_attn_ffn = TransformerLayer(
            d_model, no_ffn=False, ffn_dim_expansion=ffn_dim_expansion)

    def forward(self, source, target, attn_num_splits: int = 1):
        """source, target: [B, H, W, C] -> [B, H, W, C]."""
        _, h, w, _ = source.shape
        k_sp = max(attn_num_splits, 1)
        mask = None
        if self.with_shift and k_sp > 1:
            sh, sw = h // k_sp // 2, w // k_sp // 2
            source = torch.roll(source, shifts=(-sh, -sw), dims=(1, 2))
            target = torch.roll(target, shifts=(-sh, -sw), dims=(1, 2))
            mask = shifted_window_mask(h, w, k_sp, device=source.device)
        out = fused_window_attention_block(
            window_split_tokens(source, k_sp),
            window_split_tokens(target, k_sp),
            self.self_attn.kernel_params(),
            self.cross_attn_ffn.kernel_params(),
            mask,
        )
        out = window_merge_tokens(out, k_sp, h, w)
        if mask is not None:
            out = torch.roll(out, shifts=(sh, sw), dims=(1, 2))
        return out


class FeatureTransformer(nn.Module):
    """Alternating self/cross swin attention over the frame pair.

    Both flow directions share one 2B batch: (f0, f1) and (f1, f0).
    """

    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_dim_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion, with_shift=i % 2 == 1)
            for i in range(num_layers))

    def forward(self, feature0, feature1, attn_num_splits: int = 1):
        """feature0, feature1: [B, H, W, C]; returns the updated pair."""
        b = feature0.shape[0]
        concat0 = torch.cat([feature0, feature1], dim=0)
        concat1 = torch.cat([feature1, feature0], dim=0)
        for layer in self.layers:
            concat0 = layer(concat0, concat1, attn_num_splits)
            concat1 = torch.cat([concat0[b:], concat0[:b]], dim=0)
        return concat0[:b], concat0[b:]


class FeatureFlowAttention(nn.Module):
    """Flow propagation: pixel self-attention with the flow as values.

    Keeps the reference's quirk of projecting k from the already projected
    q (``k = k_proj(q_proj(x))``) so reference weights reproduce outputs.
    """

    def __init__(self, in_channels: int = 128):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0, flow):
        """feature0: [B, H, W, C]; flow: [B, H, W, 2] -> [B, H, W, 2]."""
        b, h, w, c = feature0.shape
        q = self.q_proj(feature0)
        k = self.k_proj(q)
        out = fused_flow_attention(
            q.reshape(b, h * w, c).contiguous(),
            k.reshape(b, h * w, c).contiguous(),
            flow.reshape(b, h * w, -1).contiguous(),
        )
        return out.reshape(b, h, w, flow.shape[-1])
