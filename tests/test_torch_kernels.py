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
    assert {"primitives.cuh", "mma_tf32.cuh", "sr_attention.cu", "window_attention.cu",
            "flow_attention.cu", "convex_upsample.cu", "splat.cu",
            "memory_attention.cu", "softmax_expectation.cu",
            "dwconv_gelu.cu"} <= names
    assert len(_build._digest()) == 16


# ------------------------------------------------ on the card (skips here)


def _gpu_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    cases = []
    for n, m, c, heads in [(7744, 121, 64, 1), (484, 121, 320, 5)]:
        cases.append(("sr_attention", K.fused_sr_attention,
                      K.fused_sr_attention_reference,
                      (r(2, n, c), r(2, m, c), r(c, c) / c**0.5, r(c),
                       r(2 * c, c) / c**0.5, r(2 * c), r(c, c) / c**0.5,
                       r(c), heads)))
    c, f = 128, 1024
    sp = dict(wq=r(c, c) / c**0.5, wk=r(c, c) / c**0.5, wv=r(c, c) / c**0.5,
              wm=r(c, c) / c**0.5, s1=1 + 0.1 * r(c), b1=0.1 * r(c))
    cp = dict(sp, w0=r(f, 2 * c) / (2 * c)**0.5, w2=r(c, f) / f**0.5,
              s2=1 + 0.1 * r(c), b2=0.1 * r(c))
    cases.append(("window_attention_block", K.fused_window_attention_block,
                  K.fused_window_attention_block_reference,
                  (r(2, 4, 484, c), r(2, 4, 484, c), sp, cp)))
    # G and H at a ragged window (T = 484) and at whole tiles (T = 1024)
    for tok in (484, 1024):
        cases.append(("window_attention_layer",
                      K.fused_window_attention_layer,
                      K.fused_window_attention_layer_reference,
                      (r(2, 4, tok, c), r(2, 4, tok, c), sp)))
        cases.append(("window_attention_ffn_layer",
                      K.fused_window_attention_ffn_layer,
                      K.fused_window_attention_ffn_layer_reference,
                      (r(2, 4, tok, c), r(2, 4, tok, c), cp)))
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
        if name == "flow_attention":
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
    coords = torch.rand(2, 352, 352, 2, generator=torch.Generator()
                        .manual_seed(1)).cuda() * 360 - 4
    got = K.splat_density(coords)
    torch.cuda.synchronize()
    # atomics add in a varying order: last-bit differences only
    torch.testing.assert_close(got, K.splat_density_reference(coords),
                               rtol=0, atol=1e-5)
