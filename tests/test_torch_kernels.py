"""Kernels A-E of the PyTorch port against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX
functions run their Pallas kernels in interpret mode (as in
tests/test_pallas_kernels.py) and, where the JAX package has one, their
XLA reference. Inputs come from numpy seeds; everything is fp32.
Tolerance: 1e-4 absolute and relative unless stated. Both sides compute
the same fp32 formula with sums in another order, and the JAX window
kernel evaluates erf by a rational fit (|err| <= 1.5e-7). The backward
of A-D is held against ``jax.vjp`` in tests/test_torch_train.py.

The ``cuda`` tests hold each CUDA kernel, forward and backward, against
its plain version at the slice's production shapes; they skip where no
GPU is present.
"""

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
    assert {"primitives.cuh", "sr_attention.cu", "window_attention.cu",
            "flow_attention.cu", "convex_upsample.cu", "splat.cu",
            "memory_attention.cu"} <= names
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
    cases.append(("flow_attention", K.fused_flow_attention,
                  K.fused_flow_attention_reference,
                  (r(2, 1936, 128), r(2, 1936, 128), r(2, 1936, 2))))
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
        g_got = torch.autograd.grad(got, wrt, cot)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before[name] + 1, name
        assert K.LAUNCHES[name + "_bwd"] == before[name + "_bwd"] + 1, name
        want = ref(*dev)
        g_want = torch.autograd.grad(want, wrt, cot)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=name)
        for a, b in zip(g_got, g_want):
            # weight grads sum over ~10^4 rows: scale-relative tolerance
            err = (a - b).abs().max().item()
            assert err <= 1e-4 * max(b.abs().max().item(), 1.0), name
    # kernel F: two written slots of three, ragged tiles (M = 100), and
    # the streaming shape; the bias takes no gradient
    for b, m, slots in ((2, 100, 3), (1, 1936, 5)):
        g = torch.Generator().manual_seed(2)
        q, k, v = (torch.randn(b, n, 128, generator=g).cuda()
                   .requires_grad_(True) for n in (m, slots * m, slots * m))
        bias = torch.zeros(b, slots, m)
        bias[:, 0] = -1e9
        bias = bias.reshape(b, slots * m).cuda()
        before = dict(K.LAUNCHES)
        got = K.masked_memory_attention(q, k, v, bias)
        assert got.grad_fn is not None
        cot = torch.randn_like(got)
        g_got = torch.autograd.grad(got, (q, k, v), cot)
        torch.cuda.synchronize()
        assert K.LAUNCHES["memory_attention"] == before["memory_attention"] + 1
        assert (K.LAUNCHES["memory_attention_bwd"]
                == before["memory_attention_bwd"] + 1)
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
