"""Flow feature transformer and flow propagation.

Counterpart of :mod:`emip_tpu.models.gmflow.transformer` (reference
``gmflow/transformer.py``). Features are channel-last [B, H, W, C] inside
the transformer, as in the JAX code. A ``TransformerBlock`` (a
self-attention layer and a cross-attention + FFN layer) runs as kernel B
(:func:`emip_tpu_torch.kernels.fused_window_attention_block`) while a
window has at most ``fused_block_max_t`` tokens, and above that as its two
``TransformerLayer``s, kernels G and H; the shifted-window roll and the
window split stay outside the kernels. Flow propagation is kernel C.
LayerNorms use eps 1e-6, the JAX package's flax default (the reference's
torch modules use 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from emip_tpu_torch.kernels import (
    fused_flow_attention,
    fused_window_attention_block,
    fused_window_attention_ffn_layer,
    fused_window_attention_layer,
)
from emip_tpu_torch.ops.window import (
    shifted_window_mask,
    window_merge_tokens,
    window_split_tokens,
)

__all__ = ["TransformerLayer", "TransformerBlock", "FeatureTransformer",
           "FeatureFlowAttention"]

_LN_EPS = 1e-6


def _windowed(fn, source, target, k_sp: int, with_shift: bool):
    """``fn(source windows, target windows, mask)`` on the (rolled, if
    shifted) window-token layout [B, K*K, T, C], merged and rolled back."""
    _, h, w, _ = source.shape
    mask = None
    if with_shift and k_sp > 1:
        sh, sw = h // k_sp // 2, w // k_sp // 2
        source = torch.roll(source, shifts=(-sh, -sw), dims=(1, 2))
        target = torch.roll(target, shifts=(-sh, -sw), dims=(1, 2))
        mask = shifted_window_mask(h, w, k_sp, device=source.device)
    out = fn(window_split_tokens(source, k_sp),
             window_split_tokens(target, k_sp), mask)
    out = window_merge_tokens(out, k_sp, h, w)
    if mask is not None:
        out = torch.roll(out, shifts=(sh, sw), dims=(1, 2))
    return out


class TransformerLayer(nn.Module):
    """One attention layer: q from ``source``, k and v from ``target``
    (reference key layout).

    ``no_ffn`` layers (self-attention) run as kernel G with the residual;
    the others (cross-attention) append the [source, message] FFN and run
    as kernel H. ``adaptor_fc1/2`` are dead in the reference and only
    present for its checkpoints.
    """

    def __init__(self, d_model: int, no_ffn: bool = False,
                 ffn_dim_expansion: int = 4, with_shift: bool = False):
        super().__init__()
        c = d_model
        self.no_ffn = no_ffn
        self.with_shift = with_shift
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
        if not self.no_ffn:
            p.update(w0=self.mlp[0].weight, w2=self.mlp[2].weight,
                     s2=self.norm2.weight, b2=self.norm2.bias)
        return p

    def forward(self, source, target, attn_num_splits: int = 1):
        """source, target: [B, H, W, C] -> [B, H, W, C]."""
        kernel = (fused_window_attention_layer if self.no_ffn
                  else fused_window_attention_ffn_layer)
        params = self.kernel_params()
        return _windowed(lambda x, t, mask: kernel(x, t, params, mask),
                         source, target, max(attn_num_splits, 1),
                         self.with_shift)


class TransformerBlock(nn.Module):
    """Self-attention (no FFN) + cross-attention (with FFN).

    Windows of at most ``fused_block_max_t`` tokens (484 at 352^2) take the
    whole block as kernel B; larger ones (1024 at 512^2) the two layers as
    kernels G and H, as the JAX ``TransformerBlock`` chooses.
    """

    def __init__(self, d_model: int, ffn_dim_expansion: int = 4,
                 with_shift: bool = False, fused_block_max_t: int = 784):
        super().__init__()
        self.with_shift = with_shift
        self.fused_block_max_t = fused_block_max_t
        self.self_attn = TransformerLayer(
            d_model, no_ffn=True, ffn_dim_expansion=ffn_dim_expansion,
            with_shift=with_shift)
        self.cross_attn_ffn = TransformerLayer(
            d_model, no_ffn=False, ffn_dim_expansion=ffn_dim_expansion,
            with_shift=with_shift)

    def forward(self, source, target, attn_num_splits: int = 1):
        """source, target: [B, H, W, C] -> [B, H, W, C]."""
        _, h, w, _ = source.shape
        k_sp = max(attn_num_splits, 1)
        if (h // k_sp) * (w // k_sp) > self.fused_block_max_t:
            source = self.self_attn(source, source, k_sp)
            return self.cross_attn_ffn(source, target, k_sp)
        sp = self.self_attn.kernel_params()
        cp = self.cross_attn_ffn.kernel_params()
        return _windowed(
            lambda x, t, mask: fused_window_attention_block(x, t, sp, cp,
                                                            mask),
            source, target, k_sp, self.with_shift)


class FeatureTransformer(nn.Module):
    """Alternating self/cross swin attention over the frame pair.

    Both flow directions share one 2B batch: (f0, f1) and (f1, f0).
    """

    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_dim_expansion: int = 4, fused_block_max_t: int = 784):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion,
                             with_shift=i % 2 == 1,
                             fused_block_max_t=fused_block_max_t)
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
