"""Kernels A-E of the PyTorch port against the JAX package's Pallas kernels
(G-J: tests/test_torch_layers.py; F: tests/test_torch_long.py).

On the CPU each port wrapper runs its plain PyTorch version; the JAX
functions run their Pallas kernels in interpret mode (as in
tests/test_pallas_kernels.py) and, where the JAX package has one, their
XLA reference. Inputs come from numpy seeds; everything is fp32.
Tolerance: 1e-4 absolute and relative unless stated. Both sides compute
the same fp32 formula with sums in another order, and the JAX window
kernel evaluates erf by a rational fit (|err| <= 1.5e-7). The backward
of A-D is held against ``jax.vjp`` in tests/test_torch_train.py. The
tensor-core forward and backward of C cannot run here: their TF32
arithmetic and their tiled algorithm, stated in plain PyTorch in
emip_tpu_torch/kernels/tf32.py, are held against fp64, the plain version,
torch.autograd.grad, the Pallas kernel and ``jax.vjp`` (F's in
tests/test_torch_long.py).

The ``cuda`` tests hold each CUDA kernel, forward and backward, against
its plain version at the slice's production shapes; they skip where no
GPU is present.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch import kernels as K
from emip_tpu_torch.kernels import _build

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ------------------------------------------------------------ kernel A


@pytest.mark.parametrize("n,m,c,heads", [(64, 16, 64, 2), (16, 16, 32, 1),
                                         (36, 9, 40, 5)])
def test_sr_attention_matches_pallas(n, m, c, heads):
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    rng = np.random.default_rng(100 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, kv_in = f(2, n, c), f(2, m, c)
    wq, wkv, wp = f(c, c) / c**0.5, f(c, 2 * c) / c**0.5, f(c, c) / c**0.5
    bq, bkv, bp = f(c) * 0.1, f(2 * c) * 0.1, f(c) * 0.1
    want = np.asarray(fused_sr_attention(x, kv_in, wq, bq, wkv, bkv, wp, bp,
                                         heads))
    before = dict(K.LAUNCHES)
    got = K.fused_sr_attention(_t(x), _t(kv_in), _t(wq.T), _t(bq),
                               _t(wkv.T), _t(bkv), _t(wp.T), _t(bp), heads)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert K.LAUNCHES == before  # the plain version launches nothing


# ------------------------------------------------------------ kernel B


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


def _torch_layout(p):
    """flax Dense kernels [in, out] -> torch Linear weights [out, in]."""
    return {k: _t(v.T if v.ndim == 2 else v) for k, v in p.items()}


@pytest.mark.parametrize("shifted", [False, True])
def test_window_block_matches_pallas(shifted):
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(7 + shifted)
    b, k2, tok, c, f = 2, 4, 16, 32, 64
    x = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    t = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    sp, cp = _window_params(rng, c, f)
    mask = np.asarray(shifted_window_mask(8, 8, 2)) if shifted else None
    want = np.asarray(fused_window_attention_block(
        x, t, sp, cp, None if mask is None else jnp.asarray(mask)))
    got = K.fused_window_attention_block(
        _t(x), _t(t), _torch_layout(sp), _torch_layout(cp),
        None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------ kernel C


@pytest.mark.parametrize("b,l,c", [(2, 64, 32), (3, 100, 64)])
def test_flow_attention_matches_pallas_and_xla(b, l, c):
    from emip_tpu.ops.pallas import fused_flow_attention

    rng = np.random.default_rng(l)
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    want = np.asarray(fused_flow_attention(q, k, v))
    s = np.einsum("blc,bmc->blm", q.astype(np.float64), k) / np.sqrt(c)
    p = np.exp(s - s.max(-1, keepdims=True))
    xla = np.einsum("blm,bmd->bld", p / p.sum(-1, keepdims=True), v)
    got = K.fused_flow_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


# ------------------------------- kernel C backward: arithmetic, algorithm


def test_tf32_round_is_cvt_rna():
    """10 mantissa bits kept, nearest, ties away from zero, either sign."""
    from emip_tpu_torch.kernels.tf32 import tf32_round

    x = torch.tensor([1 + 2.0**-11, 1 + 2.0**-11 + 2.0**-20, 1 + 2.0**-12,
                      -1 - 2.0**-11, 1 + 2.0**-10, 0.0, 3.0e-39])
    want = torch.tensor([1 + 2.0**-10, 1 + 2.0**-10, 1.0, -1 - 2.0**-10,
                         1 + 2.0**-10, 0.0, 3.0e-39])
    got = tf32_round(x)
    assert torch.equal(got[:6], want[:6])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    assert ((tf32_round(r) - r).abs() <= r.abs() * 2.0**-11).all()


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (64, 192, 128)],
                         ids=["scores", "grads"])
def test_three_tf32_products_are_fp32_grade(scale, m, k, n):
    """The kernels' product at the tile shapes of the scores (K = C = 128)
    and of a grad summed over three streamed tiles (K = 192), with
    operands at the scales the card check uses: against fp64 the
    three-term product errs by <= 2e-6 of max|ref| (per product 2^-21
    from the dropped lo.lo term and the rounding of lo, then the fp32 sum
    over K: measured 3.4e-7 to 5.0e-7, the plain fp32 product 3.0e-7 to
    4.6e-7), while one TF32 product errs by > 1e-4 (2^-11 per operand:
    measured 2.5e-4 to 3.0e-4)."""
    from emip_tpu_torch.kernels.tf32 import matmul_3xtf32, matmul_tf32

    rng = np.random.default_rng(k + int(scale))
    a = _t((rng.standard_normal((m, k)) * scale).astype(np.float32))
    b = _t(rng.standard_normal((k, n)).astype(np.float32))
    ref = a.double() @ b.double()
    err = lambda x: ((x.double() - ref).abs().max() / ref.abs().max()  # noqa
                     ).item()
    assert err(matmul_3xtf32(a, b)) <= 2e-6
    assert err(matmul_tf32(a, b)) > 1e-4


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("l,splits", [(100, 1), (192, 1), (192, 2)])
def test_flow_attention_bwd_tiled_walk(l, splits, product):
    """The algorithm of the CUDA backward (statistics from the forward,
    query-tiled dq, key-tiled dk / dv on transposed tiles of 64, a ragged
    last tile at L = 100, the streamed side in two chunks) against
    torch.autograd.grad of the plain version and against the JAX VJP
    (Pallas in interpret mode). relmax <= 1e-5: the same fp32 formula
    summed tile by tile, with fp32 or three-term TF32 products (measured
    <= 2e-6)."""
    from emip_tpu.ops.pallas import fused_flow_attention
    from emip_tpu_torch.kernels import tf32

    rng = np.random.default_rng(70 + l)
    b, c = 2, 128
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    cot = rng.standard_normal((b, l, 2)).astype(np.float32)
    _, vjp = jax.vjp(fused_flow_attention, q, k, v)
    want_jax = vjp(jnp.asarray(cot))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = K.fused_flow_attention_reference(*leaves)
    want = torch.autograd.grad(out, leaves, _t(cot))
    row_max, row_sum = tf32.attention_row_stats(_t(q), _t(k))
    walk = functools.partial(
        tf32.attention_bwd_tiled, _t(q), _t(k), _t(v), None, out.detach(),
        row_max, row_sum, _t(cot), splits=splits,
        matmul=tf32.matmul_3xtf32 if product == "3xtf32" else torch.matmul)
    got = walk()
    for name, a, w, wj in zip("qkv", got, want, want_jax):
        scale = w.abs().max().item()
        assert (a - w).abs().max().item() <= 1e-5 * scale, name
        assert np.abs(a.numpy() - np.asarray(wj)).max() <= 1e-5 * scale, name
    # only the grads asked for
    dq, dk, dv = walk(which=(0, 1))
    assert dv is None
    assert torch.equal(dq, got[0]) and torch.equal(dk, got[1])


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("l,c,splits", [(100, 128, 1), (192, 128, 1),
                                        (192, 128, 3), (100, 64, 2)])
def test_flow_attention_fwd_tiled_walk(l, c, splits, product):
    """The algorithm of the CUDA forward (streamed key tiles of 32 with
    the online max and sum, a ragged last tile at L = 100, the keys split in chunks merged in order; channel
    widths 128 and pvt_v2_b0's 64) against the plain version and the JAX
    Pallas kernel in interpret mode: within 4e-6 of max|ref| (the same
    fp32 formula summed tile by tile; measured <= 1.8e-6, where the plain
    version and the JAX kernel differ from each other by up to 6e-7). Its
    row max and row sum equal attention_row_stats' to fp32 rounding, and
    fed to the tiled backward they give the grads of
    torch.autograd.grad."""
    from emip_tpu.ops.pallas import fused_flow_attention
    from emip_tpu_torch.kernels import tf32

    rng = np.random.default_rng(90 + l + c)
    b = 2
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    cot = rng.standard_normal((b, l, 2)).astype(np.float32)
    want_jax = np.asarray(fused_flow_attention(q, k, v))
    want = K.fused_flow_attention_reference(_t(q), _t(k), _t(v))
    got, row_max, row_sum = tf32.attention_fwd_tiled(
        _t(q), _t(k), _t(v), splits=splits, keep_stats=True,
        matmul=tf32.matmul_3xtf32 if product == "3xtf32" else torch.matmul)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 4e-6 * scale
    assert np.abs(got.numpy() - want_jax).max() <= 4e-6 * scale
    assert torch.equal(got, tf32.attention_fwd_tiled(
        _t(q), _t(k), _t(v), splits=splits,
        matmul=tf32.matmul_3xtf32 if product == "3xtf32" else torch.matmul))
    ref_max, ref_sum = tf32.attention_row_stats(_t(q), _t(k))
    torch.testing.assert_close(row_max, ref_max, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(row_sum, ref_sum, rtol=1e-5, atol=0)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    grads = torch.autograd.grad(K.fused_flow_attention_reference(*leaves),
                                leaves, _t(cot))
    walk = tf32.attention_bwd_tiled(_t(q), _t(k), _t(v), None, got, row_max,
                                    row_sum, _t(cot))
    for name, a, w in zip("qkv", walk, grads):
        assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item(), name


# ------------------------------------------------------------ kernel D


@pytest.mark.parametrize("k", [4, 8])
def test_convex_upsample_matches_pallas_and_xla(k):
    from emip_tpu.ops.pallas.convex_upsample import (
        _xla_reference,
        convex_upsample_pallas,
    )

    rng = np.random.default_rng(k)
    flow = (rng.standard_normal((2, 6, 5, 2)) * 3).astype(np.float32)
    mask = rng.standard_normal((2, 6, 5, 9 * k * k)).astype(np.float32)
    got = K.convex_upsample(_t(flow), _t(mask), k).numpy()
    np.testing.assert_allclose(
        got, np.asarray(convex_upsample_pallas(flow, mask, k)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(_xla_reference(flow, mask, k)), **TOL)


# ------------------------------------------------------------ kernel E


def _splat_coords(case):
    rng = np.random.default_rng(60)
    n, h, w = 2, 8, 12
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xx, yy], -1)[None].astype(np.float32)
    if case == "random":
        return grid + (rng.standard_normal((n, h, w, 2)) * 3).astype(
            np.float32)
    if case == "integer":  # corners of weight exactly 0 and 1
        return grid + rng.integers(-3, 4, (n, h, w, 2)).astype(np.float32)
    # negative, on and past every edge
    vals = np.array([-1.5, -1.0, -0.5, 0.0, 0.25, w - 1.0, w - 0.5, w,
                     w + 0.7, h - 1.0, h - 0.5, h], np.float32)
    return rng.choice(vals, (n, h, w, 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "integer", "edges"])
def test_splat_density_matches_pallas_and_xla(case):
    from emip_tpu.ops.pallas.splat import _xla_reference, splat_density_pallas

    coords = _splat_coords(case)
    before = dict(K.LAUNCHES)
    got = K.splat_density(_t(coords)).numpy()
    assert K.LAUNCHES == before  # the plain version launches nothing
    np.testing.assert_array_equal(got, K.splat_density_reference(
        _t(coords)).numpy())
    # a sum of at most ~9 products of hat weights per pixel
    np.testing.assert_allclose(
        got, np.asarray(splat_density_pallas(coords)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(_xla_reference(coords)), rtol=0, atol=1e-5)


# ------------------------------------------------------ wrapper rules


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device raises instead of taking the plain version."""
    q = torch.empty((1, 8, 32), device="meta")
    v = torch.empty((1, 8, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        K.fused_flow_attention(q, q, v)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        K.convex_upsample(torch.empty((1, 2, 2, 2), device="meta"),
                          torch.empty((1, 2, 2, 576)))


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc the loader raises a clear error and builds nothing."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "build").exists()


def test_build_key_covers_every_source():
    """The build directory is keyed by all .cu/.cuh sources and flags."""
    names = {p.name for p in _build._sources()}
    assert {"primitives.cuh", "mma_tf32.cuh", "attention_fwd.cuh",
            "attention.cu", "sr_attention.cu", "window_attention.cu",
            "flow_attention.cu", "convex_upsample.cu", "splat.cu",
            "memory_attention.cu", "softmax_expectation.cu",
            "dwconv_gelu.cu"} <= names
    assert len(_build._digest()) == 16


# ------------------------------------------------ on the card (skips here)


def _with_mask(fn, mask):
    """fn with the window mask as its last argument, moved to the device
    of x (the mask takes no gradient)."""
    return lambda x, *a: fn(x, *a, mask.to(x.device))


def _window_weights(r, c, f):
    sp = dict(wq=r(c, c) / c**0.5, wk=r(c, c) / c**0.5, wv=r(c, c) / c**0.5,
              wm=r(c, c) / c**0.5, s1=1 + 0.1 * r(c), b1=0.1 * r(c))
    cp = dict(sp, w0=r(f, 2 * c) / (2 * c)**0.5, w2=r(c, f) / f**0.5,
              s2=1 + 0.1 * r(c), b2=0.1 * r(c))
    return sp, cp


def _gpu_cases():
    from emip_tpu_torch.ops.window import shifted_window_mask

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    cases = []
    # kernel A at head widths 64 (heads 1 and 5) and 32 (pvt_v2_b0's)
    for n, m, c, heads in [(7744, 121, 64, 1), (484, 121, 320, 5),
                           (1936, 121, 64, 2)]:
        cases.append(("sr_attention", K.fused_sr_attention,
                      K.fused_sr_attention_reference,
                      (r(2, n, c), r(2, m, c), r(c, c) / c**0.5, r(c),
                       r(2 * c, c) / c**0.5, r(2 * c), r(c, c) / c**0.5,
                       r(c), heads)))
    c, f = 128, 1024
    sp, cp = _window_weights(r, c, f)
    mask44 = shifted_window_mask(44, 44, 2)
    cases.append(("window_attention_block", K.fused_window_attention_block,
                  K.fused_window_attention_block_reference,
                  (r(2, 4, 484, c), r(2, 4, 484, c), sp, cp)))
    # B with the shifted-window mask, at width 128 and at b0's 64
    cases.append(("window_attention_block",
                  _with_mask(K.fused_window_attention_block, mask44),
                  _with_mask(K.fused_window_attention_block_reference,
                             mask44),
                  (r(2, 4, 484, c), r(2, 4, 484, c), sp, cp)))
    sp64, cp64 = _window_weights(r, 64, 256)
    cases.append(("window_attention_block",
                  _with_mask(K.fused_window_attention_block, mask44),
                  _with_mask(K.fused_window_attention_block_reference,
                             mask44),
                  (r(2, 4, 484, 64), r(2, 4, 484, 64), sp64, cp64)))
    # G and H at a ragged window (T = 484) and at whole tiles (T = 1024),
    # the latter with the mask too
    for tok in (484, 1024):
        cases.append(("window_attention_layer",
                      K.fused_window_attention_layer,
                      K.fused_window_attention_layer_reference,
                      (r(2, 4, tok, c), r(2, 4, tok, c), sp)))
        cases.append(("window_attention_ffn_layer",
                      K.fused_window_attention_ffn_layer,
                      K.fused_window_attention_ffn_layer_reference,
                      (r(2, 4, tok, c), r(2, 4, tok, c), cp)))
    mask64 = shifted_window_mask(64, 64, 2)
    cases.append(("window_attention_layer",
                  _with_mask(K.fused_window_attention_layer, mask64),
                  _with_mask(K.fused_window_attention_layer_reference,
                             mask64),
                  (r(2, 4, 1024, c), r(2, 4, 1024, c), sp)))
    cases.append(("window_attention_ffn_layer",
                  _with_mask(K.fused_window_attention_ffn_layer, mask64),
                  _with_mask(K.fused_window_attention_ffn_layer_reference,
                             mask64),
                  (r(2, 4, 1024, c), r(2, 4, 1024, c), cp)))
    cases.append(("softmax_expectation", K.softmax_expectation,
                  K.softmax_expectation_reference,
                  (3 * r(2, 1936, 1936), 5 * r(1936, 2))))
    cases.append(("dwconv_gelu", K.fused_dwconv_gelu,
                  K.fused_dwconv_gelu_reference,
                  (r(2, 22 * 22, 1280), 0.3 * r(3, 3, 1280), 0.1 * r(1280),
                   22, 22)))
    # kernel C at the forward shapes of chip_smoke.py: the 352^2 and 512^2
    # propagation, and a ragged token count (1000 = 31 key tiles of 32 + 8)
    # at both channel widths (pvt_v2_b5's 128, b0's 64)
    for b, l, c in ((16, 1936, 128), (8, 4096, 128), (2, 1000, 128),
                    (2, 1000, 64)):
        cases.append(("flow_attention", K.fused_flow_attention,
                      K.fused_flow_attention_reference,
                      (r(b, l, c), r(b, l, c), r(b, l, 2))))
    cases.append(("convex_upsample", K.convex_upsample,
                  K.convex_upsample_reference,
                  (r(2, 44, 44, 2), r(2, 44, 44, 576), 8)))
    # kernel J also at stage 1 of 512^2, on a non-square map and at a hidden
    # width that is no multiple of 4 (the scalar instantiation)
    for b, h, w, f in ((2, 128, 128, 256), (2, 7, 13, 256), (2, 11, 11, 18)):
        cases.append(("dwconv_gelu", K.fused_dwconv_gelu,
                      K.fused_dwconv_gelu_reference,
                      (r(b, h * w, f), 0.3 * r(3, 3, f), 0.1 * r(f), h, w)))
    return cases


def _on_card(a, grad):
    if torch.is_tensor(a):
        return a.cuda().requires_grad_(grad)
    if isinstance(a, dict):
        return {k: _on_card(v, grad) for k, v in a.items()}
    return a


def _leaves(args):
    for a in args:
        if torch.is_tensor(a):
            yield a
        elif isinstance(a, dict):
            yield from a.values()


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Every CUDA kernel, forward and backward, against its plain version;
    an output that depends on a tensor requiring grad carries a grad_fn."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, fn, ref, args in _gpu_cases():
        dev = [_on_card(a, True) for a in args]
        before = dict(K.LAUNCHES)
        got = fn(*dev)
        assert got.requires_grad and got.grad_fn is not None, name
        cot = torch.randn_like(got)
        wrt = list(_leaves(dev))
        g_got = torch.autograd.grad(got, wrt, cot, retain_graph=True)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before[name] + 1, name
        assert K.LAUNCHES[name + "_bwd"] == before[name + "_bwd"] + 1, name
        if name in ("flow_attention", "sr_attention",
                    "window_attention_block", "window_attention_layer",
                    "window_attention_ffn_layer", "dwconv_gelu"):
            # no atomics: a second forward and backward give the same bits
            assert torch.equal(fn(*dev), got), name
            for a, b in zip(g_got, torch.autograd.grad(got, wrt, cot)):
                assert torch.equal(a, b), name
            assert K.LAUNCHES[name] == before[name] + 2
            assert K.LAUNCHES[name + "_bwd"] == before[name + "_bwd"] + 2
        want = ref(*dev)
        g_want = torch.autograd.grad(want, wrt, cot)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=name)
        for a, b in zip(g_got, g_want):
            # weight grads sum over ~10^4 rows: scale-relative tolerance
            err = (a - b).abs().max().item()
            assert err <= 1e-4 * max(b.abs().max().item(), 1.0), name
    # kernel F: two written slots of three and every slot empty at ragged
    # tiles (M = 100), the 1- and 4-clip streaming shapes, the 512^2 one,
    # and pvt_v2_b0's width 64; the bias takes no gradient
    for b, m, slots, empty, c in ((2, 100, 3, 1, 128), (2, 100, 3, 3, 128),
                                  (1, 1936, 5, 1, 128), (4, 1936, 5, 0, 128),
                                  (1, 4096, 5, 0, 128), (2, 100, 3, 1, 64)):
        g = torch.Generator().manual_seed(2)
        q, k, v = (torch.randn(b, n, c, generator=g).cuda()
                   .requires_grad_(True) for n in (m, slots * m, slots * m))
        bias = torch.zeros(b, slots, m)
        bias[:, :empty] = -1e9
        bias = bias.reshape(b, slots * m).cuda()
        before = dict(K.LAUNCHES)
        got = K.masked_memory_attention(q, k, v, bias)
        assert got.grad_fn is not None
        assert torch.equal(K.masked_memory_attention(q, k, v, bias), got)
        cot = torch.randn_like(got)
        g_got = torch.autograd.grad(got, (q, k, v), cot, retain_graph=True)
        for a, w in zip(g_got, torch.autograd.grad(got, (q, k, v), cot)):
            assert torch.equal(a, w)  # no atomics: the same bits
        torch.cuda.synchronize()
        assert K.LAUNCHES["memory_attention"] == before["memory_attention"] + 2
        assert (K.LAUNCHES["memory_attention_bwd"]
                == before["memory_attention_bwd"] + 2)  # and the repeat
        want = K.masked_memory_attention_reference(q, k, v, bias)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        for a, w in zip(g_got, torch.autograd.grad(want, (q, k, v), cot)):
            assert (a - w).abs().max().item() <= 1e-4 * max(
                w.abs().max().item(), 1.0)
    # the 3xTF32 GEMM of A, B, G and H alone: a Linear weight read
    # transposed, row-major operands, a weight gradient split over K, and
    # rows of 90 floats (4-byte copies), against the fp64 product
    from emip_tpu_torch.kernels.gemm import gemm

    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g).cuda()  # noqa: E731
    for a, b, split in ((r(3872, 128), r(1024, 128).T, False),
                        (r(3872, 1024), r(1024, 128), False),
                        (r(3872, 128).T, r(3872, 320), True),
                        (r(1000, 90), r(70, 90).T, False),
                        (r(999, 70).T, r(999, 90), True)):
        got = gemm(a, b, split_k=split)
        want = a.double() @ b.double()
        assert torch.equal(gemm(a, b, split_k=split), got)
        assert ((got - want).abs().max() <= 1e-5 * want.abs().max()), (
            a.shape, b.shape)
    # the tensor-core forward attention of A, B, G and H alone: A's heads
    # (widths 64 and 32) and the windows (128 and 64; T = 484 ragged, 1024
    # whole tiles, 441 an odd count of tokens) with and without the shift
    # mask, k and v read in place from one [k | v] buffer; keys split
    # where the blocks are few (A's last stage, 8 windows of 1024 tokens):
    # against the fp64 product, and its kept row statistics against the
    # plain version's
    from emip_tpu_torch.kernels.attention import (
        attention,
        attention_reference,
    )
    from emip_tpu_torch.ops.window import shifted_window_mask

    masks = {s: shifted_window_mask(s, s, 2, device="cuda")
             for s in (42, 44, 64)}
    for b, nq, nk, c, heads, side in ((2, 7744, 121, 64, 1, 0),
                                      (2, 121, 121, 256, 8, 0),
                                      (2, 1936, 121, 64, 2, 0),
                                      (2, 121, 121, 64, 2, 0),
                                      (8, 484, 484, 128, 1, None),
                                      (8, 484, 484, 128, 1, 44),
                                      (8, 484, 484, 64, 1, 44),
                                      (8, 441, 441, 64, 1, 42),
                                      (8, 441, 441, 128, 1, 42),
                                      (8, 1024, 1024, 128, 1, 64)):
        windows = side != 0
        mask = masks[side] if side else None
        q, kv = r(b, nq, c), r(b, nk, 2 * c)
        k, v = kv[..., :c], kv[..., c:]
        before = K.LAUNCHES["attention"]
        got, stats = attention(q, k, v, heads, mask, windows, keep_stats=True)
        assert torch.equal(attention(q, k, v, heads, mask, windows), got)
        assert K.LAUNCHES["attention"] == before + 2
        want, want_stats = attention_reference(
            q.double(), k.double(), v.double(), heads,
            None if mask is None else mask.double(), keep_stats=True)
        assert ((got - want).abs().max() <= 1e-5 * want.abs().max()), (
            b, nq, c, heads, side)
        torch.testing.assert_close(stats.double(), want_stats, rtol=1e-5,
                                   atol=1e-5)
    coords = torch.rand(2, 352, 352, 2, generator=torch.Generator()
                        .manual_seed(1)).cuda() * 360 - 4
    got = K.splat_density(coords)
    torch.cuda.synchronize()
    # the kernel's fixed-point sum against the plain version's fp32 sum:
    # last-bit differences only
    torch.testing.assert_close(got, K.splat_density_reference(coords),
                               rtol=0, atol=1e-5)
    # E: the same bits on a second call (its sum is in integers), a grad_fn
    # and the gradient of the plain version, here and on a coherent field (a
    # shift of (2.5, -1.25) px and a 2 degree rotation about the centre,
    # the corners' targets off the image)
    from emip_tpu_torch.ops.geometry import coords_grid

    assert torch.equal(K.splat_density(coords), got)
    grid = coords_grid(352, 352)[None] - 175.5
    cos, sin = np.cos(np.deg2rad(2.0)), np.sin(np.deg2rad(2.0))
    coherent = torch.stack((175.5 + cos * grid[..., 0] - sin * grid[..., 1]
                            + 2.5,
                            175.5 + sin * grid[..., 0] + cos * grid[..., 1]
                            - 1.25), -1).expand(2, -1, -1, -1).contiguous()
    g = torch.Generator().manual_seed(4)
    for field in (coords, coherent.cuda()):
        leaf = field.clone().requires_grad_(True)
        got = K.splat_density(leaf)
        assert got.grad_fn is not None
        want = K.splat_density_reference(leaf)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert torch.equal(K.splat_density(field), got.detach())
        cot = torch.randn(got.shape, generator=g).cuda()
        a = torch.autograd.grad(got, leaf, cot)[0]
        b = torch.autograd.grad(want, leaf, cot)[0]
        assert (a - b).abs().max().item() <= 1e-4 * max(
            b.abs().max().item(), 1.0)
    # I's backward at an N that is no multiple of 4 (single-float loads)
    # and past the register tile of 4096 floats (the streaming
    # instantiation, its dvalues partial in shared memory and, past 28928,
    # in the workspace): the same bits on a second call
    for m, n in ((1001, 1001), (4100, 4100), (3, 30000)):
        corr = (3 * torch.randn(2, m, n, generator=g)).cuda()
        vals = (20 * torch.randn(n, 2, generator=g)).cuda()
        leaves = (corr.requires_grad_(True), vals.requires_grad_(True))
        before = K.LAUNCHES["softmax_expectation_bwd"]
        out = K.softmax_expectation(*leaves)
        cot = torch.randn(out.shape, generator=g).cuda()
        got = torch.autograd.grad(out, leaves, cot, retain_graph=True)
        for a, b in zip(got, torch.autograd.grad(out, leaves, cot)):
            assert torch.equal(a, b), n
        assert K.LAUNCHES["softmax_expectation_bwd"] == before + 2
        want = torch.autograd.grad(
            K.softmax_expectation_reference(*leaves), leaves, cot)
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-4 * max(
                b.abs().max().item(), 1.0), n


@pytest.mark.cuda
def test_cuda_wgmma_product_matches_fp64():
    """The wgmma product of B's and H's bf16 forwards
    (``csrc/gemm_wgmma.cuh``) alone, at the forms those kernels run it: q,
    k, v from two bf16 sources split along N, W0's two halves (bf16 x, fp32
    msg) with GELU, W2 with its LayerNorm on fp32 u, and ragged M, N and K
    tiles; within 1e-5 of max|ref| of the fp64 evaluation, the same bits on
    a second call, one count per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels.gemm import gemm_wgmma, gemm_wgmma_reference

    g = torch.Generator().manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g).cuda()  # noqa: E731
    bf = torch.bfloat16
    cases = [
        dict(a=r(3872, 128).to(bf), a2=r(3872, 128).to(bf), n_switch=128,
             w=r(384, 128) / 11),
        dict(a=r(3872, 128).to(bf), a2=r(3872, 128), w=r(1024, 256) / 16,
             epilogue="gelu"),
        dict(a=r(3872, 1024), w=r(128, 1024) / 32, epilogue="layernorm",
             gamma=1 + 0.1 * r(128), beta=0.1 * r(128)),
        dict(a=r(1000, 100), w=r(70, 100) / 10),
    ]
    for kw in cases:
        before = K.LAUNCHES["gemm_wgmma"]
        got = gemm_wgmma(**kw)
        assert torch.equal(gemm_wgmma(**kw), got)
        assert K.LAUNCHES["gemm_wgmma"] == before + 2
        d = {k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()}
        want = gemm_wgmma_reference(**d)
        assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_cuda_wgmma_input_grad_matches_fp64():
    """The input grads of G's and H's bf16 backwards alone (``gemm_dy_w``:
    dy W on the wgmma product over the transposed weight, split once, and
    on the 3xTF32 GEMM with the same epilogue): dy W0 at K = 1024, dy W2
    times gelu'(h), [gk | gv] [Wk; Wv] rounded to bf16, g + gq Wq with g's
    bf16 addend, rounded, and ragged M, N and K tiles; fp32 within 1e-5 of
    max|ref| of the fp64 evaluation, a bf16 output within one bf16
    rounding more; the same bits on a second call, one count per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels.gemm import gemm_dy_w, gemm_dy_w_reference

    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g).cuda()  # noqa: E731
    bf = torch.bfloat16
    cases = [
        dict(dy=r(4096, 1024), w=r(1024, 256) / 32),
        dict(dy=r(4096, 128), w=r(128, 1024) / 11, epilogue="gelu_grad",
             aux=r(4096, 1024)),
        dict(dy=r(4096, 256), w=r(256, 128) / 16, out_dtype=bf),
        dict(dy=r(4096, 128), w=r(128, 128) / 11, add=r(4096, 128).to(bf),
             out_dtype=bf),
        dict(dy=r(1000, 100), w=r(100, 70) / 10),
    ]
    for kw, wgmma in itertools.product(cases, (True, False)):
        before = K.LAUNCHES["gemm_dy_w"]
        got = gemm_dy_w(**kw, wgmma=wgmma)
        assert torch.equal(gemm_dy_w(**kw, wgmma=wgmma), got)
        assert K.LAUNCHES["gemm_dy_w"] == before + 2
        want = gemm_dy_w_reference(
            **{k: v.double() if torch.is_tensor(v) else v
               for k, v in kw.items() if k != "out_dtype"})
        tol = 1e-5 + (2.0 ** -8 if got.dtype == bf else 0.0)
        assert ((got.double() - want).abs().max()
                <= tol * want.abs().max()), (kw["dy"].shape, wgmma)


@pytest.mark.cuda
def test_cuda_bf16_window_layer_backwards_match_walks():
    """G's (with and without the residual) and H's bf16 backwards on the
    card at 64 and 1024 tokens, masked and not: gx, gt bf16 and every
    parameter grad fp32 within 1e-2 of max|ref| of the plain bf16
    version's VJP and within 8e-3 of the walk of the same kernel
    (``tf32.window_layer_bwd_bf16_walk`` / ``window_ffn_layer_bwd_bf16_walk``,
    on the card's inputs moved to the CPU); the same bits on a second call;
    one backward count per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels import tf32
    from emip_tpu_torch.ops.window import shifted_window_mask

    g = torch.Generator().manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    keys = ("wq", "wk", "wv", "wm", "s1", "b1", "w0", "w2", "s2", "b2")
    for layer, b, tok, c, f, side, residual in (
            ("G", 2, 64, 128, 0, 16, True), ("G", 1, 1024, 128, 0, 64, False),
            ("H", 2, 64, 64, 256, 0, True), ("H", 1, 1024, 128, 1024, 64,
                                             True)):
        x, t, cot = (r(b, 4, tok, c).to(torch.bfloat16) for _ in range(3))
        p = dict(wq=r(c, c) / c ** 0.5, wk=r(c, c) / c ** 0.5,
                 wv=r(c, c) / c ** 0.5, wm=r(c, c) / c ** 0.5,
                 s1=1 + 0.1 * r(c), b1=0.1 * r(c))
        if f:
            p.update(w0=r(f, 2 * c) / (2 * c) ** 0.5, w2=r(c, f) / f ** 0.5,
                     s2=1 + 0.1 * r(c), b2=0.1 * r(c))
        names = keys[:len(p)]
        mask = shifted_window_mask(side, side, 2) if side else None
        if layer == "H":
            name, walk = ("window_attention_ffn_layer_bwd_bf16",
                          tf32.window_ffn_layer_bwd_bf16_walk)
            fn = K.fused_window_attention_ffn_layer
            args = ()
        else:
            name, walk = ("window_attention_layer_bwd_bf16",
                          tf32.window_layer_bwd_bf16_walk)
            fn = K.fused_window_attention_layer
            args = (residual,)
        dev = [x.cuda().requires_grad_(True), t.cuda().requires_grad_(True)]
        pd = {k: p[k].cuda().requires_grad_(True) for k in names}
        md = None if mask is None else mask.cuda()
        out = fn(dev[0], dev[1], pd, md, *args)
        wrt = dev + [pd[k] for k in names]
        before = K.LAUNCHES[name]
        got = torch.autograd.grad(out, wrt, cot.cuda(), retain_graph=True)
        again = torch.autograd.grad(out, wrt, cot.cuda())
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 2, name
        for a, w in zip(got, again):
            assert torch.equal(a, w), name
        leaves = [x.requires_grad_(True), t.requires_grad_(True)] + [
            p[k].requires_grad_(True) for k in names]
        plain = fn(leaves[0], leaves[1], dict(zip(names, leaves[2:])), mask,
                   *args)
        want = torch.autograd.grad(plain, leaves, cot)
        gx, gt, grads = walk(x.detach(), t.detach(),
                             {k: v.detach() for k, v in p.items()}, cot,
                             mask, *args, stream_rows=64, res_rows=64)
        walked = [gx, gt] + [grads[k] for k in names]
        for i, (a, w, k) in enumerate(zip(got, want, walked)):
            a = a.cpu()
            assert a.dtype == w.dtype == k.dtype, (name, i)
            scale = w.float().abs().max()
            assert (a.float() - w.float()).abs().max() <= 1e-2 * scale, (
                name, i)
            assert (a.float() - k.float()).abs().max() <= 8e-3 * scale, (
                name, i)


@pytest.mark.cuda
def test_cuda_bf16_attention_matches_walk_and_plain_version():
    """The bf16 attention of C, G and B's self layer alone
    (``kernels/attention.py:attention_bf16``, ``csrc/attention_bf16.cu``)
    and G's bf16 forward on the card: within 1e-2 of max|ref| of the plain
    bf16 version, and of the walk of the same kernel
    (``tf32.attention_bf16_walk``, ``tf32.window_layer_fwd_bf16_walk``, on
    the card's inputs moved to the CPU) within 8e-3 of max|ref| where the
    output is bf16 (two bf16 ulps: the sums run in another order) and 2e-5
    for C's fp32 output (the exponentials and sums in another order); the
    same bits on a second call, one count per call. C at a ragged 1000
    tokens (width 128), at 1936 (width 64) and at 16400 (width 128, past
    the 12,400 keys a whole v row in shared memory would allow); windows of
    484, 144, 121 and 49 tokens with the shift mask (the last two read its
    rows from a copy padded to whole 16 bytes, ``mask_rows16``) and of 1024
    without it; G with and without the mask and the residual. With a mask,
    the same bits when no tile is skipped (``mask_zero_tiles`` cleared)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels import tf32
    from emip_tpu_torch.kernels.attention import (
        attention_bf16,
        attention_bf16_reference,
        mask_zero_tiles,
    )
    from emip_tpu_torch.ops.window import shifted_window_mask

    g = torch.Generator().manual_seed(7)
    bf = torch.bfloat16

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    def close(got, want, walk, tol_walk):
        scale = want.float().abs().max()
        assert (got.float() - want.float()).abs().max() <= 1e-2 * scale
        assert (got.float() - walk.float()).abs().max() <= tol_walk * scale

    for b, n, d, windows, side in ((2, 1000, 128, False, 0),
                                   (2, 1936, 64, False, 0),
                                   (1, 16400, 128, False, 0),
                                   (8, 484, 128, True, 44),
                                   (4, 1024, 64, True, 0),
                                   (4, 144, 128, True, 24),
                                   (8, 121, 128, True, 22),
                                   (4, 49, 128, True, 14)):
        q, k = r(b, n, d).to(bf), r(b, n, d).to(bf)
        v = r(b, n, d).to(bf) if windows else r(b, n, 2, scale=10.0)
        mask = shifted_window_mask(side, side, 2) if side else None
        dev = [a.cuda() for a in (q, k, v)]
        dmask = None if mask is None else mask.cuda()
        before = K.LAUNCHES["attention_bf16"]
        got = attention_bf16(*dev, dmask)
        assert torch.equal(attention_bf16(*dev, dmask), got)
        torch.cuda.synchronize()
        assert K.LAUNCHES["attention_bf16"] == before + 2
        assert got.dtype == v.dtype
        close(got.cpu(), attention_bf16_reference(q, k, v, mask),
              tf32.attention_bf16_walk(q, k, v, mask),
              8e-3 if v.dtype == bf else 2e-5)
        if dmask is not None:  # the all-zero tiles skipped: the same bits
            table = mask_zero_tiles(dmask)
            assert table.any()
            table.zero_()
            assert torch.equal(attention_bf16(*dev, dmask), got)
            del dmask._emip_zero_tiles

    for b, tok, c, side, residual in ((1, 484, 128, 44, True),
                                      (2, 144, 64, 0, False),
                                      (1, 1024, 128, 64, False)):
        x, t = r(b, 4, tok, c).to(bf), r(b, 4, tok, c).to(bf)
        p = dict(wq=r(c, c) / c ** 0.5, wk=r(c, c) / c ** 0.5,
                 wv=r(c, c) / c ** 0.5, wm=r(c, c) / c ** 0.5,
                 s1=1 + 0.1 * r(c), b1=0.1 * r(c))
        mask = shifted_window_mask(side, side, 2) if side else None
        pd = {k: v.cuda() for k, v in p.items()}
        dmask = None if mask is None else mask.cuda()
        before = K.LAUNCHES["window_attention_layer_bf16"]
        with torch.no_grad():
            got = K.fused_window_attention_layer(x.cuda(), t.cuda(), pd,
                                                 dmask, residual)
            assert torch.equal(K.fused_window_attention_layer(
                x.cuda(), t.cuda(), pd, dmask, residual), got)
        torch.cuda.synchronize()
        assert K.LAUNCHES["window_attention_layer_bf16"] == before + 2
        close(got.cpu(),
              K.fused_window_attention_layer_reference(x, t, p, mask,
                                                       residual),
              tf32.window_layer_fwd_bf16_walk(x, t, p, mask, residual),
              8e-3)


@pytest.mark.cuda
def test_cuda_bf16_memory_attention_matches_walk_and_plain_version():
    """F's bf16 forward on the card (``emip_memory_attention_bf16``: the
    ring in three exact bf16 parts, bf16 wgmma): within 1e-2 of max|ref| of
    the plain bf16 version and 2e-3 of its walk
    (``tf32.memory_attention_fwd_bf16_walk`` with the kernel's key splits,
    on the card's inputs moved to the CPU; the exponentials and sums in
    another order move single bf16 roundings of P), the same bits on a
    second call, one count a call; widths 128 and 64, 1 clip at 352^2 (eight
    key splits), a ragged ring with every slot written, some and none (the
    plain mean of the values). The statistics it keeps feed F's bf16
    backward: dq, dk and dv within 1e-2 of max|ref| of the plain backward
    from the kernel forward's output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels import tf32
    from emip_tpu_torch.kernels.memory_attention import (
        masked_memory_attention_bwd_reference,
    )

    g = torch.Generator().manual_seed(17)
    bf = torch.bfloat16

    def close(got, want, tol):
        scale = want.float().abs().max()
        assert (got.float() - want.float()).abs().max() <= tol * scale

    for b, m, slots, c, valid in ((1, 1936, 5, 128, (5,)),
                                  (2, 100, 3, 128, (3, 0)),
                                  (2, 50, 5, 64, (2, 5))):
        n = slots * m
        q = (2 * torch.randn(b, m, c, generator=g)).to(bf)
        k, v = (torch.randn(b, n, c, generator=g) for _ in range(2))
        ok = torch.zeros(b, slots, dtype=torch.bool)
        for i, nv in enumerate(valid):
            ok[i, slots - nv:] = True
        bias = torch.where(ok.repeat_interleave(m, 1), 0.0, -1e9)
        dev = [a.cuda() for a in (q, k, v, bias)]
        before = K.LAUNCHES["memory_attention_bf16"]
        with torch.no_grad():
            got = K.masked_memory_attention(*dev)
            assert torch.equal(K.masked_memory_attention(*dev), got)
        torch.cuda.synchronize()
        assert K.LAUNCHES["memory_attention_bf16"] == before + 2
        assert got.dtype == torch.float32
        close(got.cpu(), K.masked_memory_attention_reference(q, k, v, bias),
              1e-2)
        close(got.cpu(), tf32.memory_attention_fwd_bf16_walk(q, k, v, bias),
              2e-3)
        leaves = [dev[0].requires_grad_(True), dev[1].requires_grad_(True),
                  dev[2].requires_grad_(True)]
        out = K.masked_memory_attention(*leaves, dev[3])
        cot = torch.randn(out.shape, generator=g)
        grads = torch.autograd.grad(out, leaves, cot.cuda())
        want = masked_memory_attention_bwd_reference(
            q, k, v, bias, out.detach().cpu(), cot)
        for name, a, e in zip("qkv", grads, want):
            assert a.dtype == e.dtype, name
            close(a.cpu(), e, 1e-2)


@pytest.mark.cuda
def test_cuda_multiscale_shapes_match_plain_versions():
    """The shapes multi-scale GMFlow gives B and D, and J's staged bf16
    forward, on the card against their plain versions: B on 121-token
    windows (88^2 split 8 ways, two images), with and without the shift
    mask, fp32 (rtol 1e-3, atol 2e-3: 3xTF32 products) and bf16 (1e-2 of
    max|ref|); D at x4 on fp32 and bf16 logits (rtol 1e-4, atol 1e-3); J's
    bf16 forward at b5's four MixFFN maps (batch 2) and a ragged 7 x 13 map,
    within 1e-2 of max|ref| of the plain bf16 version; each the same bits
    on a second call and one count a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.ops.window import shifted_window_mask

    g = torch.Generator().manual_seed(23)
    bf = torch.bfloat16

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).cuda()

    def twice(name, fn):
        before = K.LAUNCHES[name]
        with torch.no_grad():
            got = fn()
            assert torch.equal(fn(), got)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 2
        return got

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    c, f = 128, 512
    sp = dict(wq=r(c, c) / c**0.5, wk=r(c, c) / c**0.5, wv=r(c, c) / c**0.5,
              wm=r(c, c) / c**0.5, s1=1 + 0.1 * r(c), b1=0.1 * r(c))
    cp = dict(sp, wq=r(c, c) / c**0.5, w0=r(f, 2 * c) / (2 * c)**0.5,
              w2=r(c, f) / f**0.5, s2=1 + 0.1 * r(c), b2=0.1 * r(c))
    x, t = r(2, 64, 121, c), r(2, 64, 121, c)
    for mask in (None, shifted_window_mask(88, 88, 8, device="cuda")):
        for dt in (torch.float32, bf):
            args = (x.to(dt), t.to(dt), sp, cp, mask)
            name = "window_attention_block" + ("_bf16" if dt == bf else "")
            got = twice(name, lambda: K.fused_window_attention_block(*args))
            with torch.no_grad():
                want = K.fused_window_attention_block_reference(*args)
            if dt == bf:
                assert rel(got, want) <= 1e-2
            else:
                torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)
    flow, logits = r(4, 88, 88, 2, scale=3.0), r(4, 88, 88, 144)
    for lg in (logits, logits.to(bf)):
        name = "convex_upsample" + ("_bf16" if lg.dtype == bf else "")
        got = twice(name, lambda: K.convex_upsample(flow, lg, 4))
        torch.testing.assert_close(got, K.convex_upsample_reference(
            flow, lg, 4), rtol=1e-4, atol=1e-3)
    for b, h, w, f in ((2, 88, 88, 256), (2, 44, 44, 512),
                       (2, 22, 22, 1280), (2, 11, 11, 2048),
                       (2, 7, 13, 256)):
        args = (r(b, h * w, f).to(bf), (0.3 * r(3, 3, f)).to(bf),
                0.1 * r(f), h, w)
        got = twice("dwconv_gelu_bf16",
                    lambda: K.fused_dwconv_gelu(*args))
        assert got.dtype == bf
        assert rel(got, K.fused_dwconv_gelu_reference(*args)) <= 1e-2
