"""The bf16 backwards of kernels C and A as their CUDA kernels compute them,
on the CPU.

The kernels read their bf16 operands as they are and count each product's
TF32 terms by its operands' exactness: a bf16 value is exact in TF32 (its
low half is zero), so a product with one bf16 operand takes two TF32
products and one of two bf16 operands takes one, where the fp32 kernels
take three. ``emip_tpu_torch/kernels/tf32.py`` states this arithmetic
(:func:`matmul_3xtf32_exact`) and the two bf16 backward walks. Here, at
reduced sizes:

- (a) each exact-operand product on bf16-valued operands is bit-equal to
  the three-term product (the terms left out add zeros);
- (b) C's walk is bit-equal to the composition that upcasts q and k, takes
  the row statistics (:func:`attention_row_stats`, or the fp32 forward's
  tiled pass), runs :func:`attention_bwd_tiled` at three-term products and
  rounds dq and dk (ragged L, one and two splits, widths 64 and 128); and
  within the bf16 band (8e-3 of max|ref|, as tests/test_torch_bf16_train.py
  holds the bf16 VJPs) of ``jax.vjp`` of the Pallas kernel on bf16 inputs
  (interpret mode), each grad in JAX's dtype;
- (c) A's walk the same, against the upcast fp32 walk of
  tests/test_torch_walks.py's tiling (heads 1, 2 and 5, M ragged against
  the key tiles) and ``jax.vjp`` of the Pallas kernel in bf16.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch import kernels as K
from emip_tpu_torch.kernels import tf32

BF16 = torch.bfloat16
# the bf16 band: two bf16 ulps of max|ref| (both sides round at the same
# points, their sums run in another order)
BAND = 8e-3


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _rel(got, want) -> float:
    g = got.detach().double().numpy() if torch.is_tensor(got) else None
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return {BF16: "bfloat16", torch.float32: "float32"}[x.dtype]
    return str(jnp.asarray(x).dtype)


# ------------------------------------------------- exact-operand products


@pytest.mark.parametrize("a_exact,b_exact", [(True, False), (False, True),
                                             (True, True)],
                         ids=["a", "b", "both"])
@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (48, 200, 40),
                                   (96, 128, 128), (128, 288, 64)])
def test_exact_products_equal_three_term_products(a_exact, b_exact, m, k, n):
    """On operands whose flagged side holds bf16 values, the product that
    leaves out that side's low-half terms equals matmul_3xtf32 bit for
    bit; on an fp32 operand flagged exact it does not (its low half is
    not zero). The last two shapes are those of the GEMM forms kernel B's
    bf16 backward adds: an exact A against an fp32 weight in a linear at
    K = C (x W^T with a bf16 x, x1 W^T with x1's bf16 values in fp32
    storage), and a weight grad over rows with an exact B (dy^T x1)."""
    rng = np.random.default_rng(m + k + n + 2 * a_exact + b_exact)
    a = _t(rng.standard_normal((m, k)) * 3)
    b = _t(rng.standard_normal((k, n)))
    a16 = a.to(BF16).float() if a_exact else a
    b16 = b.to(BF16).float() if b_exact else b
    got = tf32.matmul_3xtf32_exact(a16, b16, a_exact, b_exact)
    assert torch.equal(got, tf32.matmul_3xtf32(a16, b16))
    assert not torch.equal(
        tf32.matmul_3xtf32_exact(a, b, a_exact, b_exact),
        tf32.matmul_3xtf32(a, b))


# ---------------------------------------------------------------- kernel C


@functools.lru_cache(maxsize=None)
def _flow_case(l: int, c: int):
    """bf16 q, k, fp32 v and cotangent, the bf16 forward's output (plain
    version) and JAX's grads (dq, dk bf16, dv fp32)."""
    from emip_tpu.ops.pallas import fused_flow_attention

    rng = np.random.default_rng(500 + l + c)
    b = 2
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    cot = rng.standard_normal((b, l, 2)).astype(np.float32)
    _, vjp = jax.vjp(fused_flow_attention, jnp.asarray(q, jnp.bfloat16),
                     jnp.asarray(k, jnp.bfloat16), jnp.asarray(v))
    want_jax = vjp(jnp.asarray(cot))
    qb, kb = _t(q).to(BF16), _t(k).to(BF16)
    out = K.fused_flow_attention_reference(qb, kb, _t(v))
    return qb, kb, _t(v), out, _t(cot), want_jax


def _parent_flow(q, k, v, out, g, stats, splits):
    """The bf16 backward as the fp32 backward on upcast q and k: row
    statistics (``stats``, or the fp32 forward's tiled pass at three-term
    products), attention_bwd_tiled at three-term products, dq and dk
    rounded to bf16."""
    q32, k32 = q.float(), k.float()
    if stats is None:
        _, row_max, row_sum = tf32.attention_fwd_tiled(
            q32, k32, v, stream_rows=32, splits=splits,
            matmul=tf32.matmul_3xtf32, keep_stats=True)
    else:
        row_max, row_sum = stats
    dq, dk, dv = tf32.attention_bwd_tiled(
        q32, k32, v, None, out, row_max, row_sum, g, which=(0, 1, 2),
        res_rows=64, stream_rows=64, splits=splits,
        matmul=tf32.matmul_3xtf32)
    return dq.to(BF16), dk.to(BF16), dv


@pytest.mark.parametrize("l,c,splits", [(100, 128, 1), (100, 128, 2),
                                        (192, 128, 2), (192, 64, 1),
                                        (192, 64, 2), (100, 64, 2)])
def test_flow_attention_bwd_bf16_walk(l, c, splits):
    """C's bf16 backward walk: the same bits as the fp32 backward on the
    upcast q and k, rounded, whether the row statistics come from
    attention_row_stats or from the statistics pass (ragged L = 100
    against the tiles of 32 and 64; one and two splits of the streamed
    side and of the statistics pass; widths 128 and 64); within the bf16
    band of the JAX kernel's VJP on bf16 inputs."""
    q, k, v, out, g, want_jax = _flow_case(l, c)
    walk = functools.partial(tf32.flow_attention_bwd_bf16_walk, q, k, v, out,
                             g, which=(0, 1, 2), splits=splits,
                             stat_splits=splits)
    stats = tf32.attention_row_stats(q.float(), k.float())
    for source in (stats, None):
        got = walk(stats=source)
        want = _parent_flow(q, k, v, out, g, source, splits)
        for name, a, w in zip("qkv", got, want):
            assert a.dtype == w.dtype and torch.equal(a, w), name
    for name, a, w in zip("qkv", got, want_jax):
        assert _dtype_name(a) == _dtype_name(w), name
        assert _rel(a, w) <= BAND, name
    # only the grads asked for, with the same bits
    dq, dk, dv = walk(which=(0, 1))
    assert dv is None and torch.equal(dq, got[0]) and torch.equal(dk, got[1])


# ---------------------------------------------------------------- kernel A

# test_torch_walks.py's tiling of kernel A: 16 resident rows, streamed
# tiles of 8 (M = 9 and 25 ragged), the keys split in two, weight grads in
# three
_SR_TILES = dict(res_rows=16, stream_rows=8, key_splits=2, wgrad_splits=3)
_SR_NAMES = ("x", "kv_in", "wq", "bq", "wkv", "bkv", "wp", "bp")
_SR_BF16 = (0, 1, 2, 4, 6)  # x, kv_in and the weights


def _parent_sr(x, kv_in, wq, bq, wkv, bkv, wp, bp, heads, g):
    """A's bf16 backward as the fp32 backward on upcast inputs (the walk
    of emip_sr_attention and emip_sr_attention_bwd at three-term products,
    _SR_TILES), gx, g_kv_in and the weight grads rounded to bf16."""
    b, n, c = x.shape
    m = kv_in.shape[1]
    mm = tf32.matmul_3xtf32
    gemm = functools.partial(tf32.gemm_tiled, matmul=mm)
    wgrad = functools.partial(gemm, splits=_SR_TILES["wgrad_splits"])
    x2, kv2, g2 = (t.float().reshape(-1, c) for t in (x, kv_in, g))
    wq, wkv, wp = wq.float(), wkv.float(), wp.float()
    q = gemm(x2, wq.T, bq).reshape(b, n, c)
    kv = gemm(kv2, wkv.T, bkv).reshape(b, m, 2 * c)
    k, v = kv[..., :c], kv[..., c:]
    o, row_max, row_sum = tf32.attention_fwd_tiled(
        q, k, v, stream_rows=_SR_TILES["stream_rows"],
        splits=_SR_TILES["key_splits"], matmul=mm, keep_stats=True,
        heads=heads)
    o2 = o.reshape(-1, c)
    go = gemm(g2, wp).reshape(b, n, c)
    dq, dk, dv = tf32.attention_bwd_tiled(
        q, k, v, None, o, row_max, row_sum, go,
        res_rows=_SR_TILES["res_rows"], stream_rows=_SR_TILES["stream_rows"],
        matmul=mm, heads=heads)
    gq2 = dq.reshape(-1, c)
    gkv2 = torch.cat([dk, dv], -1).reshape(-1, 2 * c)
    return (gemm(gq2, wq).reshape(x.shape).to(BF16),
            gemm(gkv2, wkv).reshape(kv_in.shape).to(BF16),
            wgrad(gq2.T, x2).to(BF16), gq2.sum(0),
            wgrad(gkv2.T, kv2).to(BF16), gkv2.sum(0),
            wgrad(g2.T, o2).to(BF16), g2.sum(0))


@pytest.mark.parametrize("n,m,c,heads", [(36, 9, 32, 1), (64, 25, 64, 2),
                                         (36, 9, 40, 5),
                                         # the linear PVTv2's 49 keys; its
                                         # stage 3 at 352^2, one image
                                         (64, 49, 64, 2), (484, 49, 320, 5)])
def test_sr_attention_bwd_bf16_walk(n, m, c, heads):
    """A's bf16 backward walk: the same bits as the fp32 backward on the
    upcast inputs, rounded (heads of width 32 and 8, one, two and five
    heads, M ragged against the key tiles); within the bf16 band of the
    JAX kernel's VJP on bf16 inputs, each grad in JAX's dtype."""
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    rng = np.random.default_rng(600 + n + heads)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    jargs = (f(2, n, c), f(2, m, c), f(c, c) / c**0.5, f(c) * 0.1,
             f(c, 2 * c) / c**0.5, f(2 * c) * 0.1, f(c, c) / c**0.5,
             f(c) * 0.1)
    cot = f(2, n, c)
    jin = [jnp.asarray(a, jnp.bfloat16) if i in _SR_BF16 else jnp.asarray(a)
           for i, a in enumerate(jargs)]
    _, vjp = jax.vjp(lambda *a: fused_sr_attention(*a, heads), *jin)
    want_jax = vjp(jnp.asarray(cot, jnp.bfloat16))
    targs = [_t(a.T if a.ndim == 2 else a) for a in jargs]
    targs = [a.to(BF16) if i in _SR_BF16 else a for i, a in enumerate(targs)]
    g = _t(cot).to(BF16)
    got = tf32.sr_attention_bwd_bf16_walk(*targs, heads, g, **_SR_TILES)
    want = _parent_sr(*targs, heads, g)
    for name, a, w, wj in zip(_SR_NAMES, got, want, want_jax):
        assert a.dtype == w.dtype and torch.equal(a, w), name
        assert _dtype_name(a) == _dtype_name(wj), name
        assert _rel(a.T if a.dim() == 2 else a, wj) <= BAND, name
