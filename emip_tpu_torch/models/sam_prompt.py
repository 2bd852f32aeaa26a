"""SAM-style prompt heads (dead alternates to the MDTA ``Injector``).

Counterpart of :mod:`emip_tpu.models.sam_prompt` (the reference's
``model/EMIP_short/motion/PromptInteract.py:12-301``): ``PromptInteract``,
a SAM mask-decoder head in which learned mask tokens and patch-embedded
flow tokens attend against the image embedding through a depth-2 two-way
transformer (:mod:`emip_tpu_torch.models.sam_transformer`), the image
embedding is upscaled x4 by transposed convolutions, combined with the
tokens' hypernetwork MLPs into masks, downscaled to a 1/16 feature and
resized back; ``Interact``, the depth-1 variant that returns the
transformer's image embedding; and their helpers ``MLP``,
``PositionEmbeddingRandom``, ``PatchEmbed``, ``FlowHead`` and
``PromptGenBlock``. No entry point runs them, in either package.

The module tree and the ``state_dict`` keys are the reference's, so
:func:`emip_tpu.convert.torch_import.convert_sam_prompt_state` maps the
port's weights into flax unchanged; :func:`emip_tpu_torch.convert.
state_dict_from_flax_sam` is its inverse. That includes the modules the
reference registers and never runs (``motion_tokens``, ``flow_head``, and
on ``Interact`` the mask tokens, upscaler, hypernetwork MLPs and mask
downscaler). Tensors are NCHW, tokens [B, N, C]. ``dtype`` is the compute
dtype under flax's rule (fp32 parameters cast at use; the LayerNorms and
the positional grid fp32): PromptInteract(dtype=jnp.bfloat16) of the JAX
package. The random positional matrix is a buffer, never trained, as JAX
holds it under ``stop_gradient``. The prompt bank of ``PromptGenBlock`` is
resized as ``jax.image.resize`` resizes it, with an antialiasing filter
when it shrinks.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.dtypes import (
    Conv2d,
    ConvTranspose2d,
    Linear,
    compute_dtype,
    set_compute_dtype,
)
from emip_tpu_torch.models.common import LayerNorm2d
from emip_tpu_torch.models.sam_transformer import TwoWayTransformer
from emip_tpu_torch.ops.image import resize_bilinear, resize_bilinear_antialias

__all__ = ["MLP", "PositionEmbeddingRandom", "PatchEmbed", "FlowHead",
           "PromptGenBlock", "PromptInteract", "Interact"]


class MLP(nn.Module):
    """MaskFormer-style MLP: ``num_layers`` linears, ReLU between them
    (reference PromptInteract.py:177-199)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, sigmoid_output: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            Linear(n, k) for n, k in zip(dims, dims[1:] + [output_dim]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional grid: pixel centres in [-1, 1], (x, y)
    order, times a fixed gaussian [2, num_pos_feats], then sin and cos
    (reference :202-236). Returns [2 * num_pos_feats, size, size] fp32."""

    def __init__(self, num_pos_feats: int = 64, scale: float = 1.0):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             scale * torch.randn((2, num_pos_feats)))

    def forward(self, size: int) -> torch.Tensor:
        gauss = self.positional_encoding_gaussian_matrix
        axis = (torch.arange(size, dtype=torch.float32, device=gauss.device)
                + 0.5) / size
        y, x = torch.meshgrid(axis, axis, indexing="ij")
        coords = (2.0 * torch.stack([x, y], dim=-1) - 1.0) @ gauss
        coords = 2.0 * math.pi * coords
        pe = torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)
        return pe.permute(2, 0, 1)


class PatchEmbed(nn.Module):
    """Strided-conv patch embedding, [B, C, H, W] -> [B, (H/p)(W/p),
    embed_dim] (reference :249-275)."""

    def __init__(self, patch_size: int = 8, in_chans: int = 128,
                 embed_dim: int = 128):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size,
                           stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class FlowHead(nn.Module):
    """3x3 conv -> ReLU -> 3x3 conv to 2 channels (reference :238-246,
    unused)."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = Conv2d(hidden_dim, 2, 3, padding=1)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class PromptGenBlock(nn.Module):
    """A learned bank of ``prompt_len`` prompts, weighted by a softmax of a
    linear layer on the input's global mean, resized to the input and
    mixed by a 3x3 conv (reference :281-301). The bank is the reference's
    [1, L, C, S, S]."""

    def __init__(self, prompt_dim: int = 128, prompt_len: int = 5,
                 prompt_size: int = 96, lin_dim: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.prompt_param = nn.Parameter(
            torch.rand(1, prompt_len, prompt_dim, prompt_size, prompt_size))
        self.linear_layer = Linear(lin_dim, prompt_len)
        self.conv3x3 = Conv2d(prompt_dim, prompt_dim, 3, padding=1,
                              bias=False)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        weights = torch.softmax(self.linear_layer(x.mean(dim=(2, 3))), dim=1)
        prompt = torch.einsum("bl,lchw->bchw", weights.float(),
                              self.prompt_param[0])
        prompt = resize_bilinear_antialias(prompt, x.shape[-2:])
        return self.conv3x3(prompt.to(x.dtype))


class _ChannelNorm(LayerNorm2d):
    """flax's ``LayerNorm(dtype=float32)`` over the channels of NCHW
    features, its output cast to the compute dtype (the JAX heads'
    ``ln(x).astype(dtype)`` before the GELU)."""

    def forward(self, x):
        return super().forward(x.float()).to(compute_dtype(self))


def _mask_downscaling(in_chans: int, mask_in_chans: int,
                      embed_dim: int) -> nn.Sequential:
    """conv / LayerNorm / GELU pyramid, /8 (reference :50-58)."""
    return nn.Sequential(
        Conv2d(in_chans, mask_in_chans // 4, 2, stride=2),
        _ChannelNorm(mask_in_chans // 4), nn.GELU(),
        Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
        _ChannelNorm(mask_in_chans), nn.GELU(),
        Conv2d(mask_in_chans, embed_dim, 2, stride=2))


def _output_upscaling(dim: int) -> nn.Sequential:
    """Transposed-conv x4 upscaler (reference :33-39)."""
    return nn.Sequential(
        ConvTranspose2d(dim, dim // 4, 2, stride=2), _ChannelNorm(dim // 4),
        nn.GELU(), ConvTranspose2d(dim // 4, dim // 8, 2, stride=2),
        nn.GELU())


class _SamHead(nn.Module):
    """What both heads build: the flow patch embedding, the positional
    grid, the two-way transformer and the modules of the reference's
    constructor (reference :12-60, :107-154)."""

    def __init__(self, depth: int, num_mask_tokens: int = 4,
                 transformer_dim: int = 128, prompt_embed_dim: int = 128,
                 mask_in_chans: int = 16, patch_size: int = 8,
                 inp_size: int = 352, flow_head_hidden_dim: int = 128,
                 flow_head_depth: int = 3, mask_chans: int = 4):
        super().__init__()
        self.num_mask_tokens = num_mask_tokens
        self.grid = inp_size // patch_size
        # the flow embedding is as wide as the tokens (128 in the reference)
        self.PatchEmbed = PatchEmbed(patch_size, transformer_dim,
                                     transformer_dim)
        self.pe_layer = PositionEmbeddingRandom(prompt_embed_dim // 2)
        self.transformer = TwoWayTransformer(depth, prompt_embed_dim, 8, 2048)
        self.mask_tokens = nn.Embedding(num_mask_tokens, transformer_dim)
        self.motion_tokens = nn.Parameter(torch.zeros(transformer_dim))
        self.output_upscaling = _output_upscaling(transformer_dim)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(transformer_dim, transformer_dim, transformer_dim // 8, 3)
            for _ in range(num_mask_tokens))
        self.flow_head = MLP(transformer_dim, flow_head_hidden_dim,
                             num_mask_tokens, flow_head_depth)
        self.mask_downscaling = _mask_downscaling(mask_chans, mask_in_chans,
                                                  prompt_embed_dim)

    def _transform(self, image_embeddings, tokens):
        """(queries, keys) of the transformer on the image and ``tokens``,
        the positional grid broadcast over the batch."""
        b = image_embeddings.shape[0]
        image_pe = self.pe_layer(self.grid)[None].to(image_embeddings.dtype)
        return self.transformer(image_embeddings,
                                image_pe.expand(b, -1, -1, -1), tokens)


class PromptInteract(_SamHead):
    """SAM mask-decoder prompt head (reference PromptInteract.py:12-104).

    ``forward(image_embeddings, flow)``: both [B, 128, 44, 44] at the
    published size (``inp_size`` 352); returns a [B, 128, 44, 44] prompt
    feature: masks predicted at x4 the input, downscaled /8, resized x2
    with ``align_corners=True``."""

    def __init__(self, num_mask_tokens: int = 4, transformer_dim: int = 128,
                 prompt_embed_dim: int = 128, mask_in_chans: int = 16,
                 patch_size: int = 8, inp_size: int = 352,
                 flow_head_hidden_dim: int = 128, flow_head_depth: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(2, num_mask_tokens, transformer_dim,
                         prompt_embed_dim, mask_in_chans, patch_size,
                         inp_size, flow_head_hidden_dim, flow_head_depth,
                         mask_chans=num_mask_tokens)
        set_compute_dtype(self, dtype)

    def forward(self, image_embeddings, flow):
        b, c, h, w = image_embeddings.shape
        flow_tokens = self.PatchEmbed(flow)
        tokens = torch.cat([
            self.mask_tokens.weight[None].to(flow_tokens.dtype).expand(
                b, -1, -1), flow_tokens], dim=1)
        hs, src = self._transform(image_embeddings, tokens)
        upscaled = self.output_upscaling(
            src.transpose(1, 2).reshape(b, c, h, w))
        hyper_in = torch.stack(
            [mlp(hs[:, i]) for i, mlp in
             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bchw->bnhw", hyper_in.float(),
                             upscaled.float()).to(upscaled.dtype)
        masks = self.mask_downscaling(masks)
        return resize_bilinear(masks.float(), (h, w),
                               align_corners=True).to(masks.dtype)


class Interact(_SamHead):
    """Depth-1 SAM interaction head (reference PromptInteract.py:107-173):
    the flow's patch tokens as the prompts; returns the transformer's image
    embedding [B, C, H, W]. ``flow_tokens``, the mask tokens, the upscaler,
    the hypernetwork MLPs, the flow head and the mask downscaler (on 2
    channels) are registered and never run, as in the reference."""

    def __init__(self, num_mask_tokens: int = 4, transformer_dim: int = 128,
                 prompt_embed_dim: int = 128, mask_in_chans: int = 16,
                 patch_size: int = 8, inp_size: int = 352,
                 flow_head_hidden_dim: int = 128, flow_head_depth: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(1, num_mask_tokens, transformer_dim,
                         prompt_embed_dim, mask_in_chans, patch_size,
                         inp_size, flow_head_hidden_dim, flow_head_depth,
                         mask_chans=2)
        self.flow_tokens = nn.Embedding(2, transformer_dim)
        set_compute_dtype(self, dtype)

    def forward(self, image_embeddings, flow):
        b, c, h, w = image_embeddings.shape
        _, src = self._transform(image_embeddings, self.PatchEmbed(flow))
        return src.transpose(1, 2).reshape(b, c, h, w)
