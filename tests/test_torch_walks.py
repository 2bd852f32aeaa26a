"""The tensor-core GEMM and attention, forward and backward, of kernels A
and B, walked on the CPU.

``csrc/gemm_tf32.cuh`` (the 3xTF32 GEMM of kernels A, B, G, H) and
``attention_fwd_tc`` / ``attention_bwd_tc`` of ``csrc/mma_tf32.cuh`` (with
heads for A and the shifted-window mask for B) cannot run without a card.
Their arithmetic and algorithm are stated in plain PyTorch in
``emip_tpu_torch/kernels/tf32.py`` (:func:`gemm_tiled`,
:func:`attention_fwd_tiled`, :func:`attention_bwd_tiled`). Here the whole
forward and the whole backward of ``csrc/sr_attention.cu`` and of
``csrc/window_attention.cu``'s block are composed from those walks in the
kernels' order (the projections, the attention forward with its keys split
in chunks and the row statistics it keeps, LayerNorm and the FFN; split-K
weight gradients, input gradients, LayerNorm and GELU backward, the
attention backward from the kept statistics), with fp32 products and with
the kernels' three-term TF32 products, and held against the plain versions
(and ``torch.autograd.grad`` of them) and against the JAX entries (Pallas
in interpret mode, ``jax.vjp`` for the grads). Tolerance: 1e-5 of max|ref|
per output or gradient, as the existing walk tests of kernels C and F
(tests/test_torch_kernels.py, tests/test_torch_long.py); the plain version
and the JAX kernel differ from each other by up to 2e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch import kernels as K
from emip_tpu_torch.kernels import tf32

REL = 1e-5
EPS = 1e-6  # the window kernels' LayerNorm epsilon


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, copy=True)).requires_grad_(grad)


def _product(name):
    return tf32.matmul_3xtf32 if name == "3xtf32" else torch.matmul


def _close(got, want, name):
    want = torch.as_tensor(np.array(want))
    scale = want.abs().max().item()
    err = (got.detach() - want).abs().max().item()
    assert err <= REL * scale, f"{name}: {err} > {REL} * {scale}"


# ---------------------------------------------------------------- GEMM


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("m,k,n,splits", [(40, 96, 24, 1), (24, 300, 40, 4)],
                         ids=["ragged-K", "split-K"])
def test_gemm_walk_is_fp32_grade(m, k, n, splits, product):
    """K tiles of 32 (ragged at K = 96 + bias, split in four chunks at K =
    300) summed in order: within 2e-6 of max|ref| of the fp64 product; the
    GELU epilogue returns gelu(y) and y, the GELU-derivative one y *
    gelu'(aux), as torch's autograd of gelu gives it (within 1e-6 of
    max|ref|)."""
    rng = np.random.default_rng(m + k)
    a = _t(rng.standard_normal((m, k)).astype(np.float32))
    b = _t(rng.standard_normal((k, n)).astype(np.float32))
    bias = _t(rng.standard_normal(n).astype(np.float32))
    walk = functools.partial(tf32.gemm_tiled, splits=splits,
                             matmul=_product(product))
    ref = a.double() @ b.double()
    if splits == 1:
        ref = ref + bias.double()
    got = walk(a, b, bias if splits == 1 else None)
    assert ((got.double() - ref).abs().max() <= 2e-6 * ref.abs().max())
    u, pre = walk(a, b, epilogue="gelu")
    assert torch.equal(pre, walk(a, b))
    assert torch.equal(u, F.gelu(pre))
    aux = _t(rng.standard_normal((m, n)).astype(np.float32)).requires_grad_()
    (dgelu,) = torch.autograd.grad(F.gelu(aux).sum(), aux)
    want = walk(a, b) * dgelu
    got = walk(a, b, epilogue="gelu_grad", aux=aux.detach())
    # the derivative's fp32 formula against autograd's: a few ulps of the
    # largest output
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_gemm_wrapper_takes_the_plain_version_on_the_cpu():
    """kernels/gemm.py: CPU tensors (row-major or transposed views) take
    ``a @ b (+ bias)`` and launch nothing; a device that is neither the
    CPU nor CUDA raises."""
    from emip_tpu_torch.kernels.gemm import gemm

    rng = np.random.default_rng(5)
    a = _t(rng.standard_normal((7, 5)).astype(np.float32))
    w = _t(rng.standard_normal((3, 5)).astype(np.float32))
    bias = _t(rng.standard_normal(3).astype(np.float32))
    before = dict(K.LAUNCHES)
    assert torch.equal(gemm(a, w.T, bias), a @ w.T + bias)
    at = a.T.contiguous().T  # the transposed operand of a weight grad
    assert torch.equal(gemm(at, w.T, split_k=True), at @ w.T)
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        gemm(torch.empty((2, 2), device="meta"), torch.empty((2, 2)))


@pytest.mark.parametrize("heads,windows", [(2, False), (1, True)])
def test_attention_wrapper_takes_the_plain_version_on_the_cpu(heads,
                                                              windows):
    """kernels/attention.py: CPU tensors (k and v as views of one [k | v]
    buffer, with heads; or windows with the shift mask) take the plain
    version and launch nothing; it is the tiled walk's function within
    1e-5 of max|ref|, and its kept statistics [2, B * H, Nq] are
    attention_row_stats'."""
    from emip_tpu.ops.window import shifted_window_mask

    from emip_tpu_torch.kernels.attention import (
        attention,
        attention_reference,
    )

    rng = np.random.default_rng(11 + heads)
    b, n, c = 8, 36, 64
    q = _t(rng.standard_normal((b, n, c)).astype(np.float32))
    kv = _t(rng.standard_normal((b, n, 2 * c)).astype(np.float32))
    k, v = kv[..., :c], kv[..., c:]
    mask = _t(np.asarray(shifted_window_mask(12, 12, 2))) if windows else None
    before = dict(K.LAUNCHES)
    out, stats = attention(q, k, v, heads, mask, windows, keep_stats=True)
    assert K.LAUNCHES == before
    assert torch.equal(out, attention_reference(q, k, v, heads, mask))
    _close(out, tf32.attention_fwd_tiled(q, k, v, splits=2, heads=heads,
                                         mask=mask), "out")
    row_max, row_sum = tf32.attention_row_stats(q, k, heads=heads, mask=mask)
    torch.testing.assert_close(stats[0], row_max, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(stats[1], row_sum, rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        attention(torch.empty((2, 4, 32), device="meta"), q, q)


# ------------------------------------------------------------ kernel A


def _sr_fwd_walk(x, kv_in, wq, bq, wkv, bkv, wp, bp, heads, mm, splits=2):
    """fused_sr_attention as emip_sr_attention computes it: (out, q, k, v,
    o, row max, row sum). GEMMs K in tiles of 32; the attention per head
    (q and the halves of [k | v] read at the head's columns) with keys
    streamed in tiles of 8 (M = 9 and 25 ragged) and split in ``splits``
    chunks merged in order, keeping each row's max and sum."""
    b, n, c = x.shape
    m = kv_in.shape[1]
    gemm = functools.partial(tf32.gemm_tiled, matmul=mm)
    q = gemm(x.reshape(-1, c), wq.T, bq).reshape(b, n, c)
    kv = gemm(kv_in.reshape(-1, c), wkv.T, bkv).reshape(b, m, 2 * c)
    k, v = kv[..., :c], kv[..., c:]
    o, row_max, row_sum = tf32.attention_fwd_tiled(
        q, k, v, stream_rows=8, splits=splits, matmul=mm, keep_stats=True,
        heads=heads)
    out = gemm(o.reshape(-1, c), wp.T, bp).reshape(b, n, c)
    return out, q, k, v, o, row_max, row_sum


def _sr_walk(x, kv_in, wq, bq, wkv, bkv, wp, bp, heads, g, mm):
    """The 8 grads of fused_sr_attention as emip_sr_attention_bwd computes
    them (torch layout), the forward's products and statistics included.
    Tiles: GEMMs K in 32, weight grads split in 3; attention 16 resident
    rows, streamed tiles of 8 (M = 9 and 25 ragged)."""
    b, n, c = x.shape
    gemm = functools.partial(tf32.gemm_tiled, matmul=mm)
    wgrad = functools.partial(gemm, splits=3)
    x2, kv2, g2 = x.reshape(-1, c), kv_in.reshape(-1, c), g.reshape(-1, c)
    _, q, k, v, o, row_max, row_sum = _sr_fwd_walk(
        x, kv_in, wq, bq, wkv, bkv, wp, bp, heads, mm)
    o2 = o.reshape(-1, c)
    gwp, gbp = wgrad(g2.T, o2), g2.sum(0)
    go = gemm(g2, wp).reshape(b, n, c)
    dq, dk, dv = tf32.attention_bwd_tiled(
        q, k, v, None, o, row_max, row_sum, go, res_rows=16, stream_rows=8,
        matmul=mm, heads=heads)
    gq2 = dq.reshape(-1, c)
    gkv2 = torch.cat([dk, dv], -1).reshape(-1, 2 * c)
    return (gemm(gq2, wq).reshape(x.shape),
            gemm(gkv2, wkv).reshape(kv_in.shape), wgrad(gq2.T, x2),
            gq2.sum(0), wgrad(gkv2.T, kv2), gkv2.sum(0), gwp, gbp)


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("n,m,c,heads", [(36, 9, 32, 1), (64, 25, 64, 2),
                                         (36, 9, 64, 1), (64, 25, 128, 2),
                                         # the linear PVTv2's 49 keys; its
                                         # stage 4 at 352^2
                                         (64, 49, 64, 2), (121, 49, 512, 8)])
def test_sr_attention_fwd_walk(n, m, c, heads, product):
    """Kernel A's forward walk (head widths 32 and 64, one and two heads,
    read at their columns of the q and [k | v] buffers; M ragged against
    the key tiles of 8, the keys split in two chunks) against the plain
    version and the Pallas forward in interpret mode: 1e-5 of max|ref|.
    The kept row statistics are attention_row_stats' (what the backward
    reads), to fp32 rounding."""
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    rng = np.random.default_rng(300 + n + c + heads)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    jargs = (f(2, n, c), f(2, m, c), f(c, c) / c**0.5, f(c) * 0.1,
             f(c, 2 * c) / c**0.5, f(2 * c) * 0.1, f(c, c) / c**0.5,
             f(c) * 0.1)
    want_jax = np.asarray(fused_sr_attention(*jargs, heads))
    targs = [_t(a.T if a.ndim == 2 else a) for a in jargs]
    want = K.fused_sr_attention_reference(*targs, heads)
    out, q, k, _, _, row_max, row_sum = _sr_fwd_walk(*targs, heads,
                                                     _product(product))
    _close(out, want, "out")
    _close(out, want_jax, "out (jax)")
    ref_max, ref_sum = tf32.attention_row_stats(q, k, heads=heads)
    torch.testing.assert_close(row_max, ref_max, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(row_sum, ref_sum, rtol=1e-5, atol=0)


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("n,m,c,heads", [(36, 9, 32, 1), (64, 25, 64, 2),
                                         (36, 9, 40, 5),
                                         # the linear PVTv2's 49 keys; its
                                         # stage 3 at 352^2, one image
                                         (64, 49, 64, 2), (484, 49, 320, 5)])
def test_sr_attention_bwd_walk(n, m, c, heads, product):
    """Kernel A's backward walk (heads 1, 2, 5 read at their columns of the
    q and [k | v] buffers; M ragged) against torch.autograd.grad of the
    plain version and jax.vjp of the Pallas kernel: 1e-5 of max|ref|."""
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    rng = np.random.default_rng(400 + n + heads)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    jargs = (f(2, n, c), f(2, m, c), f(c, c) / c**0.5, f(c) * 0.1,
             f(c, 2 * c) / c**0.5, f(2 * c) * 0.1, f(c, c) / c**0.5,
             f(c) * 0.1)
    cot = f(2, n, c)
    _, vjp = jax.vjp(lambda *a: fused_sr_attention(*a, heads), *jargs)
    want_jax = vjp(jnp.asarray(cot))
    targs = [_t(a.T if a.ndim == 2 else a, True) for a in jargs]
    want = torch.autograd.grad(
        K.fused_sr_attention_reference(*targs, heads), targs, _t(cot))
    got = _sr_walk(*(a.detach() for a in targs), heads, _t(cot),
                   _product(product))
    for name, gw, w, wj in zip(("x", "kv_in", "wq", "bq", "wkv", "bkv", "wp",
                                "bp"), got, want, want_jax):
        _close(gw, w, name)
        _close(gw.T if gw.dim() == 2 else gw,
               np.asarray(wj), name + " (jax)")


# ------------------------------------------------------------ kernel B


def _ln_bwd(x, dy, gamma):
    """layernorm_bwd of primitives.cuh: dx, dgamma, dbeta."""
    mu = x.mean(-1, keepdim=True)
    inv = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + EPS)
    xh = (x - mu) * inv
    gg = dy * gamma
    dx = inv * (gg - gg.mean(-1, keepdim=True)
                - xh * (gg * xh).mean(-1, keepdim=True))
    return dx, (dy * xh).sum(0), dy.sum(0)


class _BlockWalk:
    """emip_window_block and emip_window_block_bwd of window_attention.cu,
    on [R, C] rows of windows of T tokens: GEMMs through gemm_tiled (K in
    32, weight grads split in 3, one product each; gt and the self
    layer's input grads each one product over stacked weights), the
    attention forward through attention_fwd_tiled with the mask (keys in
    tiles of 16, T = 36 ragged, split in two chunks merged in order; the
    row statistics it keeps), the attention backward through
    attention_bwd_tiled with the mask (16 resident rows, streamed tiles of
    16)."""

    def __init__(self, windows, tok, mask, mm):
        self.windows, self.tok, self.mask, self.mm = windows, tok, mask, mm
        self.gemm = functools.partial(tf32.gemm_tiled, matmul=mm)
        self.wgrad = functools.partial(self.gemm, splits=3)

    def win(self, x):
        return x.reshape(self.windows, self.tok, -1)

    def message_fwd(self, xq, t, p):
        c = xq.shape[-1]
        q, k, v = (self.gemm(a, p[w].T) for a, w in ((xq, "wq"), (t, "wk"),
                                                      (t, "wv")))
        o, row_max, row_sum = tf32.attention_fwd_tiled(
            self.win(q), self.win(k), self.win(v), stream_rows=16, splits=2,
            matmul=self.mm, keep_stats=True, mask=self.mask)
        o = o.reshape(-1, c)
        return dict(q=q, k=k, v=v, o=o, m=self.gemm(o, p["wm"].T),
                    stats=(row_max, row_sum))

    def forward(self, x, t, sp, cp):
        """(out, the self layer's message_fwd, the cross layer's, and x1,
        cat, h, u, z) for x, t [R, C]."""
        c = x.shape[-1]
        ln = lambda a, s, b: F.layer_norm(a, (c,), s, b, EPS)  # noqa: E731
        f1 = self.message_fwd(x, x, sp)
        x1 = x + ln(f1["m"], sp["s1"], sp["b1"])
        f2 = self.message_fwd(x1, t, cp)
        cat = torch.cat([x1, ln(f2["m"], cp["s1"], cp["b1"])], -1)
        u, h = self.gemm(cat, cp["w0"].T, epilogue="gelu")
        z = self.gemm(u, cp["w2"].T)
        out = x1 + ln(z, cp["s2"], cp["b2"])
        return out, f1, f2, dict(x1=x1, cat=cat, h=h, u=u, z=z)

    def message_bwd(self, xq, t, p, fw, gmsg, self_layer=False):
        """(gq Wq, gk Wk + gv Wv, weight grads); in the self layer (q, k
        and v all from xq = t) the sum of both as one product."""
        gm, gs1, gb1 = _ln_bwd(fw["m"], gmsg, p["s1"])
        go = self.gemm(gm, p["wm"])
        dq, dk, dv = tf32.attention_bwd_tiled(
            self.win(fw["q"]), self.win(fw["k"]), self.win(fw["v"]), None,
            self.win(fw["o"]), *fw["stats"], self.win(go), res_rows=16,
            stream_rows=16, matmul=self.mm, mask=self.mask)
        dq, dk, dv = (d.reshape(-1, d.shape[-1]) for d in (dq, dk, dv))
        grads = dict(wm=self.wgrad(gm.T, fw["o"]), s1=gs1, b1=gb1,
                     wq=self.wgrad(dq.T, xq), wk=self.wgrad(dk.T, t),
                     wv=self.wgrad(dv.T, t))
        # input grads that read one gradient block run over the stacked
        # weights
        if self_layer:
            dqkv = torch.cat([dq, dk, dv], -1)
            w = torch.cat([p["wq"], p["wk"], p["wv"]])
            return None, self.gemm(dqkv, w), grads
        dkv = torch.cat([dk, dv], -1)
        return (self.gemm(dq, p["wq"]),
                self.gemm(dkv, torch.cat([p["wk"], p["wv"]])), grads)

    def grads(self, x, t, sp, cp, g):
        """(gx, gt, self grads, cross grads) for the cotangent g [R, C]."""
        c = x.shape[-1]
        _, f1, f2, act = self.forward(x, t, sp, cp)
        x1, cat, h, u, z = (act[k] for k in ("x1", "cat", "h", "u", "z"))
        # out = x1 + LN2(z)
        gz, gs2, gb2 = _ln_bwd(z, g, cp["s2"])
        gh = self.gemm(gz, cp["w2"], epilogue="gelu_grad", aux=h)
        gcp = dict(w2=self.wgrad(gz.T, u), w0=self.wgrad(gh.T, cat),
                   s2=gs2, b2=gb2)
        gx1 = g + self.gemm(gh, cp["w0"][:, :c])
        gmsg = self.gemm(gh, cp["w0"][:, c:])
        # msg = LN1c(message(x1, t))
        gq, gt, grads = self.message_bwd(x1, t, cp, f2, gmsg)
        gcp.update(grads)
        gx1 = gx1 + gq
        # x1 = x + LN1s(message(x, x))
        _, gqkv, gsp = self.message_bwd(x, x, sp, f1, gx1, self_layer=True)
        return gx1 + gqkv, gt, gsp, gcp


def _window_params(rng, c, f):
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(  # noqa
        np.float32)
    ln = lambda: (rng.uniform(0.7, 1.3, c).astype(np.float32),  # noqa: E731
                  rng.normal(0, 0.05, c).astype(np.float32))
    sp = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c))
    sp["s1"], sp["b1"] = ln()
    cp = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
              w0=w(2 * c, f), w2=w(f, c))
    cp["s1"], cp["b1"] = ln()
    cp["s2"], cp["b2"] = ln()
    return sp, cp


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_block_fwd_walk(shifted, product):
    """Kernel B's forward walk at windows of T = 36 tokens (ragged against
    the key tiles of 16, the keys split in two chunks), unshifted and with
    the shifted-window mask, against the plain version and the Pallas
    forward in interpret mode: 1e-5 of max|ref|. Each layer's kept row
    statistics are attention_row_stats' with the mask (what the backward
    reads), to fp32 rounding."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(57 + shifted)
    b, k2, tok, c, f = 2, 4, 36, 32, 64
    x = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    t = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    sp, cp = _window_params(rng, c, f)
    mask = np.asarray(shifted_window_mask(12, 12, 2)) if shifted else None
    want_jax = np.asarray(fused_window_attention_block(
        x, t, sp, cp, None if mask is None else jnp.asarray(mask)))
    tsp = {k: _t(v.T if v.ndim == 2 else v) for k, v in sp.items()}
    tcp = {k: _t(v.T if v.ndim == 2 else v) for k, v in cp.items()}
    tmask = None if mask is None else _t(mask)
    want = K.fused_window_attention_block_reference(_t(x), _t(t), tsp, tcp,
                                                    tmask)
    walk = _BlockWalk(b * k2, tok, tmask, _product(product))
    flat = lambda a: _t(a).reshape(-1, c)  # noqa: E731
    out, f1, f2, act = walk.forward(flat(x), flat(t), tsp, tcp)
    _close(out, want.reshape(-1, c), "out")
    _close(out, want_jax.reshape(-1, c), "out (jax)")
    for fw in (f1, f2):
        ref_max, ref_sum = tf32.attention_row_stats(
            walk.win(fw["q"]), walk.win(fw["k"]), mask=tmask)
        torch.testing.assert_close(fw["stats"][0], ref_max, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(fw["stats"][1], ref_sum, rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_block_bwd_walk(shifted, product):
    """Kernel B's backward walk at windows of T = 36 tokens (ragged
    against the resident and the streamed tiles), unshifted and with the
    shifted-window mask (read transposed by the key-tiled pass), against
    torch.autograd.grad of the plain version and jax.vjp of the Pallas
    kernel: 1e-5 of max|ref| for gx, gt and all 18 parameter grads."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(27 + shifted)
    b, k2, tok, c, f = 2, 4, 36, 32, 64
    x = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    t = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    cot = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    sp, cp = _window_params(rng, c, f)
    mask = np.asarray(shifted_window_mask(12, 12, 2)) if shifted else None
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda x, t, sp, cp: fused_window_attention_block(x, t, sp, cp,
                                                          jmask),
        x, t, sp, cp)
    jgx, jgt, jsp, jcp = vjp(jnp.asarray(cot))

    tsp = {k: _t(v.T if v.ndim == 2 else v, True) for k, v in sp.items()}
    tcp = {k: _t(v.T if v.ndim == 2 else v, True) for k, v in cp.items()}
    tx, tt = _t(x, True), _t(t, True)
    tmask = None if mask is None else _t(mask)
    out = K.fused_window_attention_block_reference(tx, tt, tsp, tcp, tmask)
    leaves = [tx, tt, *tsp.values(), *tcp.values()]
    want = dict(zip(["x", "t"] + [f"self {k}" for k in tsp]
                    + [f"cross {k}" for k in tcp],
                    torch.autograd.grad(out, leaves, _t(cot))))

    walk = _BlockWalk(b * k2, tok, tmask, _product(product))
    flat = lambda a: _t(a).reshape(-1, c)  # noqa: E731
    gx, gt, gsp, gcp = walk.grads(
        flat(x), flat(t), {k: v.detach() for k, v in tsp.items()},
        {k: v.detach() for k, v in tcp.items()}, flat(cot))
    _close(gx, want["x"].reshape(-1, c), "x")
    _close(gt, want["t"].reshape(-1, c), "t")
    _close(gx, np.asarray(jgx).reshape(-1, c), "x (jax)")
    _close(gt, np.asarray(jgt).reshape(-1, c), "t (jax)")
    for prefix, got, jax_tree in (("self", gsp, jsp), ("cross", gcp, jcp)):
        for k, g in got.items():
            _close(g, want[f"{prefix} {k}"], f"{prefix} {k}")
            _close(g.T if g.dim() == 2 else g, np.asarray(jax_tree[k]),
                   f"{prefix} {k} (jax)")
