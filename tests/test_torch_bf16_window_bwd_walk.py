"""Kernels G's and H's bf16 backwards as their CUDA kernels compute them, on
the CPU.

``emip_window_layer_bwd_bf16`` (G) and ``emip_window_ffn_layer_bwd_bf16``
(H) read x, t and the gradient as bf16 where they lie, recompute the layer
in fp32 on the fp32 weights and run its products on the wgmma product of
``csrc/gemm_wgmma.cuh``: the recompute's x W^T (two TF32 terms where the
source is bf16), and the input grads dy W on the transposed weight, split
once a call (go = gm Wm, gt = bf16([gk | gv] [Wk; Wv]), H's [g + gh W0[:,
:C] | gh W0[:, C:]]); gx = bf16((g +) gq Wq), H's gh = (gz W2) gelu'(h),
the weight grads stay on the GEMM (the card ran the first two faster
there), and the attention stays 3xTF32.
``emip_tpu_torch/kernels/tf32.py`` states that order
(``window_layer_bwd_bf16_walk``, ``window_ffn_layer_bwd_bf16_walk``); the
kernels are held against the plain versions on the card
(``chip_smoke.py``). Here, at reduced sizes:

- each walk against the plain bf16 version's VJP (the fp32 plain version
  at the upcast inputs, gx and gt rounded) and against ``jax.vjp`` of the
  JAX package's Pallas kernel on bf16 windows (``_backward_pallas``,
  ``_ffn_backward_pallas`` in interpret mode), every grad within 8e-3 of
  max|ref| (two bf16 ulps: the tolerance of tests/test_torch_bf16_512.py's
  ``test_window_layer_bf16_vjp_matches_pallas``), at widths C 32 and 64, F
  128 and 256, windows of 16 and 49 tokens, with and without the shift
  mask, G with and without the residual; gx and gt alone equal to gx and
  gt beside every weight grad;
- the exact-operand products: on bf16 operands the two-term products (x
  Wq, t Wk, t Wv and the weight grads dY^T x) give the bits of the
  three-term ones, so reading bf16 in place changes no bit;
- the transposed split's product dy (W^T)^T alone, within 1e-5 of max|ref|
  of its fp64 evaluation (the GEMM's tolerance on the card).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels import tf32
from emip_tpu_torch.kernels import window_attention as wa

BF16 = torch.bfloat16
# two bf16 ulps of max|ref|: every side rounds gx and gt once, their sums
# run in another order
BAND = 8e-3
PRODUCT_TOL = 1e-5
_SELF = ("wq", "wk", "wv", "wm", "s1", "b1")
_CROSS = _SELF + ("w0", "w2", "s2", "b2")


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return {BF16: "bfloat16", torch.float32: "float32"}[x.dtype]
    return str(jnp.asarray(x).dtype)


@functools.lru_cache(maxsize=None)
def _case(layer: str, batch: int, tok: int, c: int, f: int, shifted: bool,
          residual: bool):
    """bf16 x, t and cotangent [batch, 4, tok, c], fp32 parameters in
    torch's layout, the mask (or None) and JAX's grads by name (gx, gt
    bf16; the parameter grads fp32, in torch's layout)."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_ffn_layer,
        fused_window_attention_layer,
    )
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(500 + tok + c + f + 2 * shifted + residual
                                + 7 * (layer == "H"))
    x, t, cot = (rng.standard_normal((batch, 4, tok, c)).astype(np.float32)
                 for _ in range(3))

    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    def ln():
        return (rng.uniform(0.7, 1.3, c).astype(np.float32),
                rng.normal(0, 0.05, c).astype(np.float32))

    p = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c))
    p["s1"], p["b1"] = ln()
    keys = _SELF
    if layer == "H":
        keys = _CROSS
        p.update(w0=w(2 * c, f), w2=w(f, c))
        p["s2"], p["b2"] = ln()
    side = 2 * int(round(tok ** 0.5))
    mask = np.asarray(shifted_window_mask(side, side, 2)) if shifted else None
    jmask = None if mask is None else jnp.asarray(mask)
    jb = functools.partial(jnp.asarray, dtype=jnp.bfloat16)
    if layer == "H":
        def jfn(x, t, *ps):
            return fused_window_attention_ffn_layer(x, t, *ps, jmask)
    else:
        def jfn(x, t, *ps):
            return fused_window_attention_layer(x, t, *ps, jmask, residual)
    _, vjp = jax.vjp(jfn, jb(x), jb(t), *(jnp.asarray(p[k]) for k in keys))
    want = dict(zip(("x", "t") + keys, vjp(jb(cot))))
    want = {k: v.T if v.ndim == 2 else v for k, v in want.items()}

    def tt(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True))

    tp = {k: tt(v.T if v.ndim == 2 else v) for k, v in p.items()}
    return (tt(x).to(BF16), tt(t).to(BF16), tt(cot).to(BF16), tp,
            None if mask is None else tt(mask), want)


def _walk(layer, x, t, p, g, mask, residual, weights):
    if layer == "H":
        return tf32.window_ffn_layer_bwd_bf16_walk(x, t, p, g, mask,
                                                   weights=weights)
    return tf32.window_layer_bwd_bf16_walk(x, t, p, g, mask, residual,
                                           weights=weights)


def _plain_grads(layer, x, t, p, g, mask, residual):
    """The plain bf16 version's VJP: the fp32 plain version at the upcast
    inputs, gx and gt rounded to bf16 (as the port's CPU path)."""
    keys = _CROSS if layer == "H" else _SELF
    if layer == "H":
        def plain(x, t, *ps):
            return wa.fused_window_attention_ffn_layer_reference(
                x, t, dict(zip(keys, ps)), mask)
    else:
        def plain(x, t, *ps):
            return wa.fused_window_attention_layer_reference(
                x, t, dict(zip(keys, ps)), mask, residual)
    got = cm.plain_vjp_fp32(plain, (x, t, *(p[k] for k in keys)),
                            [True] * (2 + len(keys)), g)
    return dict(zip(("x", "t") + keys, got))


@pytest.mark.parametrize("layer,batch,tok,c,f,shifted,residual", [
    ("G", 2, 16, 32, 0, False, True),
    ("G", 1, 49, 64, 0, True, True),
    ("G", 2, 16, 64, 0, True, False),
    ("H", 2, 16, 32, 128, False, True),
    ("H", 1, 49, 64, 256, True, True),
    ("H", 2, 16, 64, 256, True, True),
])
def test_window_layer_bwd_bf16_walk(layer, batch, tok, c, f, shifted,
                                    residual):
    """G's or H's bf16 backward walk: gx, gt bf16 and every parameter grad
    fp32, each within the bf16 band of the plain bf16 version's VJP and of
    the JAX kernel's VJP on bf16 windows, in JAX's dtype; gx and gt alone
    have the bits they have beside the weight grads."""
    x, t, g, p, mask, want_jax = _case(layer, batch, tok, c, f, shifted,
                                       residual)
    gx, gt, grads = _walk(layer, x, t, p, g, mask, residual, True)
    got = dict(x=gx, t=gt, **grads)
    want = _plain_grads(layer, x, t, p, g, mask, residual)
    assert got.keys() == want.keys() == want_jax.keys()
    for name, v in got.items():
        assert v.dtype == want[name].dtype, name
        assert _dtype_name(v) == _dtype_name(want_jax[name]), name
        assert _rel(v, want[name]) <= BAND, name
        assert _rel(v, want_jax[name]) <= BAND, name
    gx2, gt2, none = _walk(layer, x, t, p, g, mask, residual, False)
    assert not none
    assert torch.equal(gx2, gx) and torch.equal(gt2, gt)


@pytest.mark.parametrize("form", ["x W^T", "dY^T x"])
@pytest.mark.parametrize("c,rows", [(32, 98), (64, 256), (128, 200)])
def test_exact_operand_products_keep_the_bits(form, c, rows):
    """The products of x and t (bf16 values) and their weight grads: two
    TF32 terms give the bits of three, per K tile and over a walk of tiles
    of 32 split in three chunks (a weight grad's split-K), so the kernels'
    reading bf16 in place keeps the parent's bits."""
    g = torch.Generator().manual_seed(c + rows)
    x = torch.randn(rows, c, generator=g).to(BF16).float()
    w = torch.randn(c, c, generator=g) / c ** 0.5
    dy = torch.randn(rows, c, generator=g)
    if form == "x W^T":
        a, b, exact = x, w.T, dict(a_exact=True)
    else:
        a, b, exact = dy.T, x, dict(b_exact=True)
    assert torch.equal(tf32.matmul_3xtf32_exact(a, b, **exact),
                       tf32.matmul_3xtf32(a, b))
    two = functools.partial(tf32.matmul_3xtf32_exact, **exact)
    splits = 3 if form == "dY^T x" else 1
    assert torch.equal(tf32.gemm_tiled(a, b, splits=splits, matmul=two),
                       tf32.gemm_tiled(a, b, splits=splits,
                                       matmul=tf32.matmul_3xtf32))


@pytest.mark.parametrize("form", ["gm Wm", "gkv Wkv", "gz W2 gelu'",
                                  "gh W0", "ragged"])
def test_transposed_weight_product_matches_fp64(form):
    """dy W on the transposed weight (``wgmma_linear_walk`` on ``W.T``: K
    tiles of 32 folded in order, three TF32 terms) within 1e-5 of max|ref|
    of dy W in fp64, at the input grads' forms: K = C, K = 2C (gt's stacked
    [Wk; Wv]), K = F (gh W0), K = C times gelu'(h) (the product's
    epilogue that ``chip_smoke.py`` holds against the GEMM's at H's gh),
    and ragged rows, K and N."""
    rng = np.random.default_rng(600 + len(form))

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    m, c, f = 200, 64, 256
    aux = None
    if form == "gm Wm":
        dy, w = r(m, c), r(c, c) / 8
    elif form == "gkv Wkv":
        dy, w = r(m, 2 * c), r(2 * c, c) / 11
    elif form == "gz W2 gelu'":
        dy, w, aux = r(m, c), r(c, f) / 8, r(m, f)
    elif form == "gh W0":
        dy, w = r(m, f), r(f, 2 * c) / 16
    else:
        dy, w = r(99, 70), r(70, 90) / 8
    got = tf32.wgmma_linear_walk([dy], w.T, "gelu_grad" if aux is not None
                                 else None, aux=aux)
    ref = dy.double() @ w.double()
    if aux is not None:
        ref = ref * tf32._gelu_grad(aux.double())
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= PRODUCT_TOL
