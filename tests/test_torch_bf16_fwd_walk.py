"""Kernel A's fused bf16 forward as its CUDA kernel computes it, on the CPU.

``emip_sr_attention_bf16`` runs the kv projection (the bf16 GEMM), then one
kernel in which a cluster of one block per head projects the head's q from
K tiles of 32, runs the online softmax over key tiles of 32 with P rounded
to bf16, rounds o, shares the heads' o and writes the head's output
columns. ``emip_tpu_torch/kernels/tf32.py:sr_attention_fwd_bf16_walk``
states that order in plain tensor code; the kernel is held against the
plain version on the card (``chip_smoke.py``). Here the walk is held, at
small shapes, against the plain bf16 version (``_reference_bf16``, which
rounds the normalised P) and against the JAX package's Pallas kernel on
bf16 inputs (interpret mode, as tests/test_torch_bf16.py runs it), each
within the bf16 band of that file (8e-3 of max|ref|: both sides round at
the same points, their sums run in another order). The cases cover 1, 2,
5 and 8 heads at head widths 32 (pvt_v2_b0) and 64 (b5), query counts no
multiple of the 64-row tile, key counts no multiple of the 32-key tile,
and 121 and 256 keys (352^2 and 512^2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch.kernels import sr_attention as sr
from emip_tpu_torch.kernels import tf32

BF16 = torch.bfloat16
BAND = 8e-3


def _rel(got, want) -> float:
    g = got.detach().double().numpy()
    w = (want.detach().double().numpy() if torch.is_tensor(want)
         else np.asarray(jnp.asarray(want, jnp.float32), np.float64))
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("n,m,c,heads", [
    (100, 121, 64, 1), (70, 121, 32, 1), (64, 121, 128, 2), (36, 25, 64, 2),
    (36, 121, 160, 5), (49, 250, 320, 5), (121, 121, 256, 8),
    (20, 256, 512, 8),
    # the linear PVTv2's 49 keys (one key tile and a ragged one); its stage
    # 4 at 352^2
    (100, 49, 64, 1), (121, 49, 512, 8)])
def test_sr_attention_fwd_bf16_walk(n, m, c, heads):
    """The walk against the plain bf16 version and the Pallas kernel in
    bf16, each within the bf16 band; bf16 out of [B, N, C]."""
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    rng = np.random.default_rng(300 + n + m + c + heads)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    x, kv_in = f(2, n, c), f(2, m, c)
    wq, wkv, wp = f(c, c) / c**0.5, f(c, 2 * c) / c**0.5, f(c, c) / c**0.5
    bq, bkv, bp = f(c) * 0.1, f(2 * c) * 0.1, f(c) * 0.1

    def tb(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)

    args = (tb(x), tb(kv_in), tb(wq.T), torch.from_numpy(bq), tb(wkv.T),
            torch.from_numpy(bkv), tb(wp.T), torch.from_numpy(bp), heads)
    walk = tf32.sr_attention_fwd_bf16_walk(*args)
    assert walk.dtype == BF16 and walk.shape == (2, n, c)
    assert _rel(walk, sr._reference_bf16(*args)) <= BAND

    def jb(a):
        return jnp.asarray(a, jnp.bfloat16)

    want = fused_sr_attention(jb(x), jb(kv_in), jb(wq), bq, jb(wkv), bkv,
                              jb(wp), bp, heads)
    assert str(want.dtype) == "bfloat16"
    assert _rel(walk, want) <= BAND
