"""EMIP long-term model: frozen short-term net + space-time-memory prompt.

Counterpart of :mod:`emip_tpu.models.emip_long` (reference
``model/EMIP_long/model_long.py`` ``Model_long``): the whole short-term
two-stream network runs frozen; a rolling LTM buffer of the last <= 5
frames' key / value maps gives a historical-feature prompt that a fresh
motion collector (``injector1``) and decoder head turn into the mask.

The short-term net is frozen three ways: its parameters do not require
grad, it runs under ``torch.no_grad()``, and it is always in eval mode:
:meth:`EMIPLong.train` leaves it there, so ``model.train()`` neither
updates the BatchNorm statistics of ``conv_corr``, ``dr2``, ``dr3`` nor
switches the backbone's drop path on. ``LTM.fusion``'s BatchNorm,
``long_dr``, ``dr1`` and ``decoder`` follow the mode.

As in the JAX package, the reference's unused ``corr_bw`` is not
computed, and frame 0 (which the reference pairs with frame 1 and answers
with the short-term mask) is the caller's business. Streaming is a plain
Python loop (:meth:`EMIPLong.scan_video`).

``EMIPLong(config, memory_size, dtype=torch.bfloat16)`` is the JAX
``EMIPLong(dtype=bfloat16)`` of the published configuration: the
short-term net, the LTM heads, ``long_dr``, ``injector1``, ``dr1`` and
the decoder compute in bf16 under flax's rule (fp32 parameters cast at
use, fp32 BatchNorms and norm statistics), the memory ring stays fp32,
the read runs kernel F's bf16 instantiation (its backward in a train
step) and, at 512^2, the short-term net's windows take G and H in bf16;
the long masks come out fp32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from emip_tpu_torch.models.common import (
    DimensionalReduction,
    NeighborConnectionDecoder,
)
from emip_tpu_torch.models.emip_short import (
    EMIPShort,
    EMIPShortConfig,
    _set_dtype,
)
from emip_tpu_torch.models.ltm import LTM, MemoryState
from emip_tpu_torch.models.prompt import Injector

__all__ = ["EMIPLong"]


class EMIPLong(nn.Module):
    """``dtype``: the compute dtype, fp32 or bfloat16 (the parameters are
    fp32 either way), in every configuration of the short-term net."""

    def __init__(self, config: EMIPShortConfig = EMIPShortConfig(),
                 memory_size: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.memory_size = memory_size
        fdim = config.gmflow.feature_channels
        self.short_term = EMIPShort(config)
        self.short_term.requires_grad_(False)
        self.short_term.eval()
        self.LTM = LTM(dim=fdim, key_dim=fdim, val_dim=fdim)
        self.long_dr = DimensionalReduction(2 * fdim, fdim)
        self.injector1 = Injector(dim=fdim)
        self.decoder = NeighborConnectionDecoder(config.channel)
        self.dr1 = DimensionalReduction(fdim, config.channel)
        _set_dtype(self, dtype)

    def train(self, mode: bool = True):
        """Set the mode of the long heads; the short-term net stays in
        eval mode whatever ``mode`` is."""
        super().train(mode)
        self.short_term.eval()
        return self

    def init_memory(self, batch: int, dtype=torch.float32,
                    device=None) -> MemoryState:
        if device is None:
            device = next(self.parameters()).device
        h = w = self.config.inp_size // 8
        fdim = self.config.gmflow.feature_channels
        return MemoryState.zeros(batch, self.memory_size, h, w, fdim, fdim,
                                 dtype, device)

    @torch.no_grad()
    def short_forward(self, image1, image2) -> dict:
        """Frozen short-term forward (the mask of frame 0)."""
        return self.short_term.forward_full(image1, image2)

    @torch.no_grad()
    def encode_frame(self, image) -> dict:
        """Frozen per-frame short-term encoding (backbone, CNN flow
        features, camouflage injection). It depends on the frame alone, so
        streaming callers keep it: frame t's encoding is frame t+1's
        "prev"."""
        return self.short_term.encode_frame(image)

    def _long_head(self, s: dict, state: MemoryState):
        """Memorize frame t-1, read for frame t, decode. The read sees the
        fresh (key, value) with gradient; the state that is returned holds
        them detached (truncated backpropagation across frames)."""
        fea8, fea16, fea32 = s["fea_2"]
        k, v = self.LTM.memorize(s["fea_1"][0], s["corr_emb"])
        memory = self.long_dr(self.LTM.read(state.push(k, v), fea8))
        z3 = self.dr1(self.injector1(fea8, memory))
        with torch.no_grad():
            z4 = self.short_term.dr2(fea16)
            z5 = self.short_term.dr3(fea32)
        mask_long = self.decoder(z5, z4, z3)
        return mask_long, state.push(k.detach(), v.detach())

    def step_encoded(self, enc_prev: dict, enc_cur: dict,
                     state: MemoryState):
        """The step on two frames' encodings: (mask_long, new_state)."""
        with torch.no_grad():
            s = self.short_term.pair_from_encodings(enc_prev, enc_cur,
                                                    with_decode=False)
        return self._long_head(s, state)

    def step_cached(self, enc_prev: dict, image_cur, state: MemoryState):
        """:meth:`step` with the previous frame's encoding supplied.

        Returns (mask_long, enc_cur, new_state); hand ``enc_cur`` back as
        the next step's ``enc_prev``, so that each frame is encoded once.
        Same arithmetic as :meth:`step` without the short-term decode,
        whose mask streaming callers discard."""
        enc_cur = self.encode_frame(image_cur)
        mask_long, new_state = self.step_encoded(enc_prev, enc_cur, state)
        return mask_long, enc_cur, new_state

    def step(self, image_prev, image_cur, state: MemoryState):
        """One streaming step: memorize frame t-1, read for frame t,
        decode. Returns (mask_long, short_mask_prev, new_state). Only the
        LTM, ``long_dr``, ``injector1``, ``dr1`` and ``decoder`` heads get
        gradients."""
        s = self.short_forward(image_prev, image_cur)
        mask_long, new_state = self._long_head(s, state)
        return mask_long, s["mask"], new_state

    def forward(self, image_prev, image_cur, state: MemoryState):
        return self.step(image_prev, image_cur, state)

    def scan_video(self, frames: torch.Tensor) -> torch.Tensor:
        """Stream a clip [B, T, 3, H, W]; returns masks [B, T, 1, H, W].

        Frame 0's mask is the short-term prediction on (f0, f1), the
        reference protocol (test_long.py:29-37); frames 1..T-1 come from
        the memory-prompted long head. Each frame is encoded once."""
        enc_prev = self.encode_frame(frames[:, 0])
        enc = self.encode_frame(frames[:, 1])
        with torch.no_grad():
            mask0 = self.short_term.pair_from_encodings(enc_prev, enc)["mask"]
        mask, state = self.step_encoded(enc_prev, enc,
                                        self.init_memory(frames.shape[0]))
        masks = [mask0, mask]
        for t in range(2, frames.shape[1]):
            mask, enc, state = self.step_cached(enc, frames[:, t], state)
            masks.append(mask)
        return torch.stack(masks, dim=1)
