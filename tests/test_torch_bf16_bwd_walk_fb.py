"""The bf16 backwards of kernels F and B as their CUDA kernels compute them,
on the CPU.

Both kernels read their bf16 operands as they are and count each
product's TF32 terms by its operands' exactness (a bf16 value is exact in
TF32: a product with one bf16 operand takes two TF32 products where the
fp32 kernels take three). ``emip_tpu_torch/kernels/tf32.py`` states that
arithmetic in :func:`memory_attention_bwd_bf16_walk` and
:func:`window_block_bwd_bf16_walk`. Here, at reduced sizes:

- (a) F's walk (bf16 q; q k^T in both passes and dS^T q two-term) is
  bit-equal to the composition that upcasts q, runs
  :func:`attention_bwd_tiled` at three-term products and rounds dq (ragged
  N against the tiles, a partly and a wholly empty ring, one and two
  splits of the streamed side, widths 64 and 128, dq alone and dq dk dv);
  and within the bf16 band (8e-3 of max|ref|, as
  tests/test_torch_bf16_long.py holds F's bf16 VJP) of ``jax.vjp`` of the
  Pallas kernel on a bf16 q (interpret mode), each grad in JAX's dtype;
- (b) B's walk (bf16 x, t and cotangent; x1 kept in fp32 as an exact
  operand; the products of x, t and x1 and their weight grads two-term) is
  bit-equal to tests/test_torch_walks.py's fp32 block walk on the upcast
  inputs with x1 rounded as the bf16 forward rounds it, gx and gt rounded
  (unshifted and with the shifted-window mask, T = 36 ragged against the
  tiles; gx gt alone and with all 16 parameter grads); and within the bf16
  band of ``jax.vjp`` of the Pallas block on bf16 x and t.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)
from tests.test_torch_walks import _BlockWalk, _window_params

from emip_tpu_torch import kernels as K
from emip_tpu_torch.kernels import tf32

BF16 = torch.bfloat16
# the bf16 band: two bf16 ulps of max|ref| (both sides round at the same
# points, their sums run in another order)
BAND = 8e-3


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _rel(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return {BF16: "bfloat16", torch.float32: "float32"}[x.dtype]
    return str(jnp.asarray(x).dtype)


def _equal(got, want, name):
    assert got.dtype == want.dtype, name
    assert torch.equal(got, want), name


# ---------------------------------------------------------------- kernel F

# the walk's tiling: 16 resident rows, streamed tiles of 16 (N = slots * M
# ragged against them where M is 20)
_F_TILES = dict(res_rows=16, stream_rows=16)


@functools.lru_cache(maxsize=None)
def _memory_case(b: int, m: int, slots: int, c: int, valid: tuple):
    """bf16 q, fp32 k, v, bias (the last ``valid[i]`` slots of clip i
    written, the rest at -1e9) and cotangent, the bf16 forward's output
    (plain version) and JAX's grads (dq bf16, dk and dv fp32)."""
    from emip_tpu.ops.pallas.memory_attention import masked_memory_attention

    rng = np.random.default_rng(700 + b + m + c + sum(valid))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ok = np.zeros((b, slots), bool)
    for i, n in enumerate(valid):
        ok[i, slots - n:] = True
    bias = np.where(np.repeat(ok, m, axis=1), 0.0, -1e9).astype(np.float32)
    q, k, v, cot = 2 * f(b, m, c), f(b, slots * m, c), f(b, slots * m, c), \
        f(b, m, c)
    _, vjp = jax.vjp(lambda q, k, v: masked_memory_attention(q, k, v, bias),
                     jnp.asarray(q, jnp.bfloat16), jnp.asarray(k),
                     jnp.asarray(v))
    want_jax = vjp(jnp.asarray(cot))
    qb = _t(q).to(BF16)
    out = K.masked_memory_attention_reference(qb, _t(k), _t(v), _t(bias))
    return qb, _t(k), _t(v), _t(bias), out, _t(cot), want_jax


@pytest.mark.parametrize("b,m,slots,c,valid,splits,which", [
    (2, 20, 3, 64, (1, 3), 1, (0, 1, 2)),
    (2, 20, 3, 64, (3, 2), 2, (0, 1, 2)),
    (1, 24, 5, 128, (2,), 1, (0,)),
    (3, 16, 2, 128, (2, 1, 0), 2, (0, 1, 2)),
    (2, 20, 3, 128, (3, 3), 2, (0,)),
])
def test_memory_attention_bwd_bf16_walk(b, m, slots, c, valid, splits,
                                        which):
    """F's bf16 backward walk: the same bits as the fp32 backward on the
    upcast q, dq rounded (N = slots x M ragged against the tiles of 16 at
    M = 20; slots partly and wholly empty; one and two splits; widths 64
    and 128; dq alone and dq dk dv); within the bf16 band of the JAX
    kernel's VJP on a bf16 q, each grad in JAX's dtype."""
    q, k, v, bias, out, g, want_jax = _memory_case(b, m, slots, c, valid)
    stats = tf32.attention_row_stats(q.float(), k, bias)
    got = tf32.memory_attention_bwd_bf16_walk(
        q, k, v, bias, out, g, which=which, splits=splits, stats=stats,
        **_F_TILES)
    dq, dk, dv = tf32.attention_bwd_tiled(
        q.float(), k, v, bias, out, *stats, g, which=which, splits=splits,
        matmul=tf32.matmul_3xtf32, **_F_TILES)
    want = (dq.to(BF16), dk, dv)
    for i, name in enumerate("qkv"):
        if i not in which:
            assert got[i] is None, name
            continue
        _equal(got[i], want[i], name)
        assert _dtype_name(got[i]) == _dtype_name(want_jax[i]), name
        assert _rel(got[i], want_jax[i]) <= BAND, name
    # the statistics recomputed by the walk itself: the same bits
    again = tf32.memory_attention_bwd_bf16_walk(
        q, k, v, bias, out, g, which=which, splits=splits, **_F_TILES)
    for a, w in zip(got, again):
        assert (a is None and w is None) or torch.equal(a, w)


# ---------------------------------------------------------------- kernel B

_B_NAMES = ("wq", "wk", "wv", "wm", "s1", "b1")
_B_CROSS = _B_NAMES + ("w0", "w2", "s2", "b2")


class _ParentBlockWalk(_BlockWalk):
    """The parent's bf16 block backward: tests/test_torch_walks.py's fp32
    block walk on fp32 inputs holding bf16 values, with x1 = bf16(x +
    bf16(LN1s(m1))) as the bf16 forward rounds it (its roundings passed
    straight through)."""

    def forward(self, x, t, sp, cp):
        c = x.shape[-1]

        def ln(a, s, b):
            return torch.nn.functional.layer_norm(a, (c,), s, b, 1e-6)

        f1 = self.message_fwd(x, x, sp)
        msg1 = ln(f1["m"], sp["s1"], sp["b1"]).to(BF16).float()
        x1 = (x + msg1).to(BF16).float()
        f2 = self.message_fwd(x1, t, cp)
        cat = torch.cat([x1, ln(f2["m"], cp["s1"], cp["b1"])], -1)
        u, h = self.gemm(cat, cp["w0"].T, epilogue="gelu")
        z = self.gemm(u, cp["w2"].T)
        out = x1 + ln(z, cp["s2"], cp["b2"])
        return out, f1, f2, dict(x1=x1, cat=cat, h=h, u=u, z=z)


@functools.lru_cache(maxsize=None)
def _block_case(shifted: bool):
    """bf16 x, t and cotangent [2, 4, 36, 32], fp32 parameters in torch's
    layout, the mask, and JAX's grads of the Pallas block on bf16 x and t
    (gx, gt bf16; the parameter grads fp32)."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(81 + shifted)
    b, k2, tok, c, f = 2, 4, 36, 32, 64
    x = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    t = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    cot = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    sp, cp = _window_params(rng, c, f)
    mask = np.asarray(shifted_window_mask(12, 12, 2)) if shifted else None
    jmask = None if mask is None else jnp.asarray(mask)
    jb = functools.partial(jnp.asarray, dtype=jnp.bfloat16)
    _, vjp = jax.vjp(
        lambda x, t, sp, cp: fused_window_attention_block(x, t, sp, cp,
                                                          jmask),
        jb(x), jb(t), sp, cp)
    want_jax = vjp(jb(cot))
    tsp = {k: _t(v.T if v.ndim == 2 else v) for k, v in sp.items()}
    tcp = {k: _t(v.T if v.ndim == 2 else v) for k, v in cp.items()}
    tmask = None if mask is None else _t(mask)
    return (_t(x).to(BF16), _t(t).to(BF16), _t(cot).to(BF16), tsp, tcp,
            tmask, want_jax)


@pytest.mark.parametrize("weights", [False, True],
                         ids=["gx gt", "all grads"])
@pytest.mark.parametrize("shifted", [False, True],
                         ids=["unshifted", "shifted"])
def test_window_block_bwd_bf16_walk(shifted, weights):
    """B's bf16 backward walk: the same bits as the fp32 block walk on the
    upcast inputs with x1 rounded, gx and gt rounded to bf16 (every one
    of the 16 parameter grads too, where asked for; gx gt alone the same
    bits as with them); within the bf16 band of the JAX kernel's VJP on
    bf16 x and t, each grad in JAX's dtype."""
    x, t, g, sp, cp, mask, (jgx, jgt, jsp, jcp) = _block_case(shifted)
    b, k2, tok, c = x.shape
    gx, gt, gsp, gcp = tf32.window_block_bwd_bf16_walk(
        x, t, sp, cp, g, mask, weights=weights)
    walk = _ParentBlockWalk(b * k2, tok, mask, tf32.matmul_3xtf32)
    flat = lambda a: a.float().reshape(-1, c)  # noqa: E731
    px, pt, psp, pcp = walk.grads(flat(x), flat(t), sp, cp, flat(g))
    _equal(gx, px.reshape(x.shape).to(BF16), "x")
    _equal(gt, pt.reshape(t.shape).to(BF16), "t")
    for name, a, w in (("x", gx, jgx), ("t", gt, jgt)):
        assert _dtype_name(a) == _dtype_name(w), name
        assert _rel(a, w) <= BAND, name
    if not weights:
        assert not gsp and not gcp
        return
    assert set(gsp) == set(_B_NAMES) and set(gcp) == set(_B_CROSS)
    for prefix, got, want, jtree in (("self", gsp, psp, jsp),
                                     ("cross", gcp, pcp, jcp)):
        for k, v in got.items():
            _equal(v, want[k], f"{prefix} {k}")
            assert v.dtype == torch.float32, f"{prefix} {k}"
            assert _rel(v.T if v.dim() == 2 else v, jtree[k]) <= BAND, \
                f"{prefix} {k}"
