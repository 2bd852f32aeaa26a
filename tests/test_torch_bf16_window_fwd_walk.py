"""Kernels B's and H's bf16 forwards as their CUDA kernels compute them, on
the CPU.

``emip_window_ffn_layer_bf16`` (H) and the cross layer and FFN of
``emip_window_block_bf16`` (B, after its bf16 self layer) run every product
on the wgmma product of ``csrc/gemm_wgmma.cuh``: K tiles of 32, each summed
on its own and folded into an fp32 running sum, two TF32 terms where A is
bf16 (x, t, B's x1) and three where it is fp32, W0 in JAX's two halves
(x's K tiles, then msg's), msg in Wm's LayerNorm epilogue and the output
in W2's (LN2 + the bf16 residual, rounded once).
``emip_tpu_torch/kernels/tf32.py`` states that order
(``wgmma_linear_walk``, ``window_ffn_bf16_walk``,
``window_block_fwd_bf16_walk``); the kernels are held against the plain
versions on the card (``chip_smoke.py``). Here:

- the product alone against fp64, within 1e-5 of max|ref| (the GEMM's
  tolerance on the card) at K = 256 (W0's two halves, bf16 then fp32) and
  K = 1024 (W2 with its LayerNorm);
- H's and B's walks against their plain bf16 versions
  (``_ffn_layer_reference_bf16``, ``_block_reference_bf16``) and against
  the JAX package's Pallas kernels in bf16 (``_ffn_kernel``,
  ``_block_kernel`` in interpret mode, as tests/test_torch_bf16.py and
  tests/test_torch_bf16_long.py run them), each within 8e-3 of max|ref|
  (two bf16 ulps: every side rounds at the same points and sums in another
  order), at widths C 32 and 64, F 128 and 256, windows of 16 and 49
  tokens (row counts no multiple of the kernel's 64-row tiles), with and
  without the shift mask.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch.kernels import tf32
from emip_tpu_torch.kernels import window_attention as wa

BF16 = torch.bfloat16
BAND = 8e-3
PRODUCT_TOL = 1e-5


def _rel(got, want) -> float:
    g = got.detach().double().numpy()
    w = (want.detach().double().numpy() if torch.is_tensor(want)
         else np.asarray(jnp.asarray(want, jnp.float32), np.float64))
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _layer(rng, c, f=None):
    """One layer's parameters in flax layout ([in, out] kernels)."""
    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    p = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
             s1=rng.uniform(0.7, 1.3, c).astype(np.float32),
             b1=rng.normal(0, 0.05, c).astype(np.float32))
    if f:
        p.update(w0=w(2 * c, f), w2=w(f, c),
                 s2=rng.uniform(0.7, 1.3, c).astype(np.float32),
                 b2=rng.normal(0, 0.05, c).astype(np.float32))
    return p


def _torch(p):
    """flax layout -> the port's (torch [out, in] weights)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v.T if v.ndim == 2
                                                     else v))
            for k, v in p.items()}


def _windows(rng, batch, tok, c, shifted):
    """bf16-rounded x, t [batch, 4, tok, c] (numpy fp32 and torch bf16) and
    the shift mask of the map whose 2 x 2 windows hold tok tokens."""
    from emip_tpu.ops.window import shifted_window_mask

    side = 2 * int(round(tok ** 0.5))
    x, t = (rng.standard_normal((batch, 4, tok, c)).astype(np.float32)
            for _ in range(2))
    xb, tb = (torch.from_numpy(a).to(BF16) for a in (x, t))
    mask = (np.array(shifted_window_mask(side, side, 2)) if shifted
            else None)
    return (xb.float().numpy(), tb.float().numpy(), xb, tb, mask)


@pytest.mark.parametrize("form", ["W0 halves gelu", "W2 layernorm",
                                  "qkv exact"])
def test_wgmma_product_matches_fp64(form):
    """The product alone (K tiles of 32 folded in order, exact-operand term
    counts, the epilogue) within 1e-5 of max|ref| of its fp64 evaluation on
    the same operands; rows and columns no multiple of a tile."""
    rng = np.random.default_rng(400 + len(form))

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    m, c = 200, 64
    if form == "W0 halves gelu":  # K = 2C = 256 over bf16 x, then fp32 msg
        c = 128
        x, msg, w = f(m, c).to(BF16), f(m, c), f(510, 2 * c) / 16
        got = tf32.wgmma_linear_walk([x, msg], w, "gelu")
        ref = torch.nn.functional.gelu(
            torch.cat([x.double(), msg.double()], -1) @ w.double().T)
    elif form == "W2 layernorm":  # K = 1024, fp32 u
        u, w = f(m, 1024), f(c, 1024) / 32
        gamma, beta = 1 + 0.1 * f(c), 0.1 * f(c)
        got = tf32.wgmma_linear_walk([u], w, "layernorm", gamma, beta)
        ref = torch.nn.functional.layer_norm(
            u.double() @ w.double().T, (c,), gamma.double(), beta.double(),
            1e-6)
    else:  # q from bf16 x: two terms, K = 64 in two tiles
        x, w = f(m, c).to(BF16), f(3 * c, c) / 8
        got = tf32.wgmma_linear_walk([x], w)
        ref = x.double() @ w.double().T
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= PRODUCT_TOL


@pytest.mark.parametrize("batch,tok,c,f,shifted", [
    (2, 16, 32, 128, False), (2, 16, 64, 256, True), (1, 49, 32, 256, True),
    (1, 49, 64, 128, False)])
def test_window_ffn_bf16_walk(batch, tok, c, f, shifted):
    """H's walk against the plain bf16 version and the Pallas kernel in
    bf16 (``_ffn_kernel``), each within the bf16 band; bf16 out."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_ffn_layer,
    )

    rng = np.random.default_rng(410 + tok + c + f + shifted)
    x, t, xb, tb, mask = _windows(rng, batch, tok, c, shifted)
    p = _layer(rng, c, f)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tf32.window_ffn_bf16_walk(xb, tb, _torch(p), tm)
    assert got.dtype == BF16 and got.shape == xb.shape
    assert _rel(got, wa._ffn_layer_reference_bf16(xb, tb, _torch(p),
                                                  tm)) <= BAND
    keys = ("wq", "wk", "wv", "wm", "s1", "b1", "w0", "w2", "s2", "b2")
    want = fused_window_attention_ffn_layer(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16),
        *(p[k] for k in keys), None if mask is None else jnp.asarray(mask))
    assert str(want.dtype) == "bfloat16"
    assert _rel(got, want) <= BAND


@pytest.mark.parametrize("tok,c,f,shifted", [
    (16, 64, 128, False), (16, 32, 256, True), (49, 64, 256, True)])
def test_window_block_fwd_bf16_walk(tok, c, f, shifted):
    """B's walk (the bf16 self layer, then H's walk on x1) against the plain
    bf16 version and the Pallas kernel in bf16 (``_block_kernel``), each
    within the bf16 band; bf16 out."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )

    rng = np.random.default_rng(430 + tok + c + f + shifted)
    x, t, xb, tb, mask = _windows(rng, 1, tok, c, shifted)
    sp, cp = _layer(rng, c), _layer(rng, c, f)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tf32.window_block_fwd_bf16_walk(xb, tb, _torch(sp), _torch(cp), tm)
    assert got.dtype == BF16 and got.shape == xb.shape
    assert _rel(got, wa._block_reference_bf16(xb, tb, _torch(sp), _torch(cp),
                                              tm)) <= BAND
    want = fused_window_attention_block(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16), sp, cp,
        None if mask is None else jnp.asarray(mask))
    assert str(want.dtype) == "bfloat16"
    assert _rel(got, want) <= BAND
