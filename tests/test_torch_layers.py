"""Kernels G-J of the PyTorch port, and the paths that run them, against
the JAX package on the CPU.

G (``fused_window_attention_layer``), H
(``fused_window_attention_ffn_layer``), I (``softmax_expectation``) and J
(``fused_dwconv_gelu`` / ``dwconv_gelu_bwd_fused``): the port's plain
versions against the JAX Pallas kernels in interpret mode (as
tests/test_pallas_kernels.py runs them), forward and VJP on a seeded
cotangent. Then the modules that choose them: the layer-wise
``TransformerBlock`` (``fused_block_max_t`` below the window's token count;
the JAX side under ``EMIP_FUSED_BLOCK_MAX_T``), read-corr global matching
(``global_match_qk_fused=False`` against ``EMIP_GLOBAL_MATCH_QK=0``), the
fused ``MixFFN`` in both forms, and a tiny long model streaming a clip at
a second input size (96^2 beside the other tests' 64^2) through the
layer-wise transformer.

Inputs come from numpy seeds; everything is fp32. Tolerance: 1e-4
absolute and relative on forwards (the same formula with sums in another
order; the JAX kernels evaluate erf by a rational fit, |err| <= 1.5e-7);
grads by max|got - want| / max|want| ("relmax") <= 1e-4 (weight grads sum
over all rows, so an absolute tolerance has no fixed scale); model masks
rtol 1e-3 / atol 1e-2 as in tests/test_torch_slice.py.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch import convert
from emip_tpu_torch import kernels as K
from emip_tpu_torch.convert import state_dict_from_flax_long

TOL = dict(rtol=1e-4, atol=1e-4)
VJP_REL = 1e-4
MASK_TOL = dict(rtol=1e-3, atol=1e-2)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, copy=True)).requires_grad_(grad)


def _relmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _assert_grads(got, want, names):
    for g, w, name in zip(got, want, names):
        assert _relmax(g, w) <= VJP_REL, (name, _relmax(g, w))


def _layer_params(rng, c, f=None):
    """One layer's parameters in flax layout ([in, out] kernels)."""
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(  # noqa
        np.float32)
    p = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
             s1=rng.uniform(0.7, 1.3, c).astype(np.float32),
             b1=rng.normal(0, 0.05, c).astype(np.float32))
    if f:
        p.update(w0=w(2 * c, f), w2=w(f, c),
                 s2=rng.uniform(0.7, 1.3, c).astype(np.float32),
                 b2=rng.normal(0, 0.05, c).astype(np.float32))
    return p


def _windows(rng, shifted, side=8):
    """x, t [2, 4, T, 32] and the shift mask of a side x side map."""
    from emip_tpu.ops.window import shifted_window_mask

    tok = (side // 2) ** 2
    x = rng.standard_normal((2, 4, tok, 32)).astype(np.float32)
    t = rng.standard_normal((2, 4, tok, 32)).astype(np.float32)
    mask = np.asarray(shifted_window_mask(side, side, 2)) if shifted else None
    return x, t, mask


# ------------------------------------------------------------ kernel G


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_layer_and_vjp_match_pallas(shifted, add_residual):
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_layer,
    )

    rng = np.random.default_rng(20 + 2 * shifted + add_residual)
    x, t, mask = _windows(rng, shifted)
    p = _layer_params(rng, 32)
    keys = ("wq", "wk", "wv", "wm", "s1", "b1")
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(
        lambda x, t, *w: fused_window_attention_layer(
            x, t, *w, jmask, add_residual=add_residual),
        x, t, *(p[k] for k in keys))
    cot = rng.standard_normal(want.shape).astype(np.float32)

    leaves = [_t(x, True), _t(t, True)] + [
        _t(p[k].T if p[k].ndim == 2 else p[k], True) for k in keys]
    before = dict(K.LAUNCHES)
    got = K.fused_window_attention_layer(
        leaves[0], leaves[1], dict(zip(keys, leaves[2:])),
        None if mask is None else _t(mask), add_residual)
    assert K.LAUNCHES == before  # the plain version launches nothing
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, leaves, _t(cot))
    grads = [g.numpy().T if g.dim() == 2 else g.numpy() for g in grads]
    _assert_grads(grads, vjp(cot), ("x", "t") + keys)


# ------------------------------------------------------------ kernel H


@pytest.mark.parametrize("shifted", [False, True])
def test_window_ffn_layer_and_vjp_match_pallas(shifted):
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_ffn_layer,
    )

    rng = np.random.default_rng(30 + shifted)
    x, t, mask = _windows(rng, shifted)
    p = _layer_params(rng, 32, 64)
    keys = ("wq", "wk", "wv", "wm", "s1", "b1", "w0", "w2", "s2", "b2")
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(
        lambda x, t, *w: fused_window_attention_ffn_layer(x, t, *w, jmask),
        x, t, *(p[k] for k in keys))
    cot = rng.standard_normal(want.shape).astype(np.float32)

    # the port keeps the reference's one [F, 2C] weight where the JAX
    # kernel takes w0 [2C, F] in two halves
    leaves = [_t(x, True), _t(t, True)] + [
        _t(p[k].T if p[k].ndim == 2 else p[k], True) for k in keys]
    got = K.fused_window_attention_ffn_layer(
        leaves[0], leaves[1], dict(zip(keys, leaves[2:])),
        None if mask is None else _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, leaves, _t(cot))
    grads = [g.numpy().T if g.dim() == 2 else g.numpy() for g in grads]
    _assert_grads(grads, vjp(cot), ("x", "t") + keys)


def test_block_equals_its_two_layers():
    """B's plain version is G on (x, x) then H on (x1, t)."""
    rng = np.random.default_rng(33)
    x, t, mask = _windows(rng, True)
    sp = {k: _t(v.T if v.ndim == 2 else v)
          for k, v in _layer_params(rng, 32).items()}
    cp = {k: _t(v.T if v.ndim == 2 else v)
          for k, v in _layer_params(rng, 32, 64).items()}
    x, t, mask = _t(x), _t(t), _t(mask)
    x1 = K.fused_window_attention_layer(x, x, sp, mask)
    two = K.fused_window_attention_ffn_layer(x1, t, cp, mask)
    one = K.fused_window_attention_block(x, t, sp, cp, mask)
    torch.testing.assert_close(one, two, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ kernel I


@pytest.mark.parametrize("b,m,n", [(2, 16, 16), (3, 24, 40)])
def test_softmax_expectation_and_vjp_match_pallas(b, m, n):
    from emip_tpu.ops.pallas import softmax_expectation

    rng = np.random.default_rng(40 + n)
    corr = (rng.standard_normal((b, m, n)) * 3).astype(np.float32)
    values = (rng.standard_normal((n, 2)) * 5).astype(np.float32)
    want, vjp = jax.vjp(softmax_expectation, corr, values)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    c, v = _t(corr, True), _t(values, True)
    before = dict(K.LAUNCHES)
    got = K.softmax_expectation(c, v)
    assert K.LAUNCHES == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, (c, v), _t(cot))
    _assert_grads([g.numpy() for g in grads], vjp(cot), ("corr", "values"))


# ------------------------------------------------------------ kernel J


@pytest.mark.parametrize("library_forward", [False, True])
@pytest.mark.parametrize("b,h,w,f", [(2, 6, 8, 32), (1, 3, 3, 16),
                                     (2, 1, 5, 8)])
def test_dwconv_gelu_and_vjp_match_pallas(b, h, w, f, library_forward):
    """``fused_dwconv_gelu`` (Pallas forward and backward) and, with
    ``library_forward``, ``dwconv_gelu_bwd_fused`` (XLA forward, Pallas
    backward) with the exact GELU; maps down to one row, so that every
    border case of the 3x3 window occurs."""
    from emip_tpu.ops.pallas.mixffn import (
        dwconv_gelu_bwd_fused,
        fused_dwconv_gelu,
    )

    rng = np.random.default_rng(50 + f)
    u = rng.standard_normal((b, h * w, f)).astype(np.float32)
    wdw = (rng.standard_normal((3, 3, f)) * 0.3).astype(np.float32)
    bdw = (rng.standard_normal(f) * 0.1).astype(np.float32)
    jfn = dwconv_gelu_bwd_fused if library_forward else fused_dwconv_gelu
    want, vjp = jax.vjp(lambda u, k, bias: jfn(u, k, bias, h, w), u, wdw, bdw)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    leaves = [_t(u, True), _t(wdw, True), _t(bdw, True)]
    before = dict(K.LAUNCHES)
    got = K.fused_dwconv_gelu(*leaves, h, w, library_forward=library_forward)
    assert K.LAUNCHES == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, leaves, _t(cot))
    _assert_grads([g.numpy() for g in grads], vjp(cot), ("u", "wdw", "bdw"))


def test_new_wrappers_check_their_arguments():
    """No silent fallback, and shapes the kernels do not take raise before
    any launch (checked on the meta device: no card is needed)."""
    corr = torch.empty((1, 4, 6), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        K.softmax_expectation(corr, torch.empty((6, 2)))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        K.fused_dwconv_gelu(torch.empty((1, 4, 8), device="meta"),
                            torch.empty((3, 3, 8)), torch.empty(8), 2, 2)
    x = torch.empty((1, 4, 16, 32), device="meta")
    p = {k: torch.empty(32, 32) for k in ("wq", "wk", "wv", "wm")}
    p.update(s1=torch.empty(32), b1=torch.empty(32))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        K.fused_window_attention_layer(x, x, p)
    # (the package re-exports a function under its module's name)
    se = importlib.import_module("emip_tpu_torch.kernels.softmax_expectation")
    dw = importlib.import_module("emip_tpu_torch.kernels.dwconv_gelu")
    with pytest.raises(ValueError, match="values has shape"):
        se._check(torch.empty(1, 4, 6), torch.empty(6, 3))
    with pytest.raises(ValueError, match="expected 2 x 3"):
        dw._check(torch.empty(1, 4, 8), torch.empty(3, 3, 8), torch.empty(8),
                  2, 3)


# ---------------------------------------- layer-wise TransformerBlock (G, H)


def _block_state(v):
    from tests.test_torch_modules import _transformer_state

    sd = _transformer_state({"params": {"layer0": v["params"]}}, 1, "")
    return {k[len("layers.0."):]: a for k, a in sd.items()}


@pytest.mark.parametrize("shifted", [False, True])
def test_layerwise_transformer_block_matches_jax(shifted, monkeypatch):
    """Windows of 64 tokens with ``fused_block_max_t`` 16: the port runs G
    then H, the JAX block its two per-layer Pallas kernels; both equal the
    whole-block path."""
    from emip_tpu.models.gmflow.transformer import (
        TransformerBlock as JaxBlock,
    )
    from emip_tpu_torch.models.gmflow.transformer import TransformerBlock

    rng = np.random.default_rng(60 + shifted)
    src = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    tgt = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    jm = JaxBlock(32, ffn_dim_expansion=2, with_shift=shifted,
                  use_fused_attn=True)
    v = th.random_variables(jm, src, tgt, attn_num_splits=2, seed=4)
    monkeypatch.setenv("EMIP_FUSED_BLOCK_MAX_T", "16")
    want = np.asarray(jm.apply(v, src, tgt, 2))

    sd = _block_state(v)
    layers = TransformerBlock(32, 2, with_shift=shifted, fused_block_max_t=16)
    block = TransformerBlock(32, 2, with_shift=shifted)
    assert set(layers.state_dict()) == set(block.state_dict())
    layers.load_state_dict(sd, strict=True)
    block.load_state_dict(sd, strict=True)
    calls = []
    monkeypatch.setattr(
        "emip_tpu_torch.models.gmflow.transformer."
        "fused_window_attention_block",
        lambda *a, **k: calls.append("B") or K.fused_window_attention_block(
            *a, **k))
    with torch.no_grad():
        got = layers(_t(src), _t(tgt), 2)
        assert calls == []  # the layer-wise path does not touch kernel B
        whole = block(_t(src), _t(tgt), 2)
        assert calls == ["B"]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


def test_transformer_layer_grads_reach_every_parameter():
    """G and H as autograd Functions inside the modules: the input and
    every live parameter of both layers get a gradient equal to the
    whole-block path's."""
    from emip_tpu_torch.models.gmflow.transformer import TransformerBlock

    torch.manual_seed(0)
    layers = TransformerBlock(32, 2, with_shift=True, fused_block_max_t=0)
    block = TransformerBlock(32, 2, with_shift=True)
    block.load_state_dict(layers.state_dict())
    src = torch.randn(1, 8, 8, 32, requires_grad=True)
    tgt = torch.randn(1, 8, 8, 32, requires_grad=True)
    cot = torch.randn(1, 8, 8, 32)
    grads = {}
    for name, m in (("layers", layers), ("block", block)):
        live = [(n, p) for n, p in m.named_parameters() if "adaptor" not in n]
        gs = torch.autograd.grad(m(src, tgt, 2), [src, tgt] + [p for _, p in
                                                               live], cot)
        grads[name] = dict(zip(["src", "tgt"] + [n for n, _ in live], gs))
    assert len(grads["layers"]) == 2 + 6 + 10
    for n, g in grads["layers"].items():
        assert g.abs().max() > 0, n
        assert _relmax(g, grads["block"][n]) <= VJP_REL, n


def test_shift_mask_is_made_once_and_serves_a_later_backward():
    """The shift mask is one shared tensor per shape and device. Made first
    under ``inference_mode`` (a prediction run), it must still be a plain
    tensor that a later train step can save for its backward."""
    from emip_tpu_torch.models.gmflow.transformer import TransformerBlock
    from emip_tpu_torch.ops.window import shifted_window_mask

    with torch.inference_mode():
        first = shifted_window_mask(12, 20, 2)
    assert not first.is_inference()
    assert shifted_window_mask(12, 20, 2, device="cpu") is first
    np.testing.assert_array_equal(
        first.numpy(),
        np.asarray(importlib.import_module(
            "emip_tpu.ops.window").shifted_window_mask(12, 20, 2)))

    torch.manual_seed(1)
    layers = TransformerBlock(32, 2, with_shift=True, fused_block_max_t=0)
    src = torch.randn(1, 12, 20, 32, requires_grad=True)
    out = layers(src, torch.randn(1, 12, 20, 32), 2)
    (g,) = torch.autograd.grad(out.sum(), src)
    assert torch.isfinite(g).all() and g.abs().max() > 0


# -------------------------------------------------- read-corr matching (I)


@pytest.mark.parametrize("bidir", [True, False])
def test_read_corr_global_matching_matches_jax(bidir, monkeypatch):
    from emip_tpu.models.gmflow.matching import (
        global_correlation_softmax as jax_gcs,
    )
    from emip_tpu_torch.models.gmflow import matching

    rng = np.random.default_rng(70)
    f0 = rng.standard_normal((2, 8, 10, 32)).astype(np.float32)
    f1 = rng.standard_normal((2, 8, 10, 32)).astype(np.float32)
    monkeypatch.setenv("EMIP_GLOBAL_MATCH_QK", "0")

    def jloss(f0, f1):
        flow, _, corr = jax_gcs(f0, f1, bidir)
        return jnp.sum(flow**2) + 0.1 * jnp.sum(jnp.tanh(corr)), (flow, corr)

    (_, (wflow, wcorr)), wgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(f0, f1)

    used = []
    monkeypatch.setattr(matching, "softmax_expectation",
                        lambda c, v: used.append(tuple(c.shape))
                        or K.softmax_expectation(c, v))
    monkeypatch.setattr(matching, "fused_flow_attention", None)  # not taken
    a, b = _t(f0, True), _t(f1, True)
    flow, corr = matching.global_correlation_softmax(a, b, bidir,
                                                     qk_fused=False)
    assert used == [(2, 80, 80)] * (2 if bidir else 1)
    np.testing.assert_allclose(flow.detach().numpy(), np.asarray(wflow), **TOL)
    np.testing.assert_allclose(corr.detach().numpy(), np.asarray(wcorr), **TOL)
    loss = (flow**2).sum() + 0.1 * torch.tanh(corr).sum()
    grads = torch.autograd.grad(loss, (a, b))
    _assert_grads([g.numpy() for g in grads], wgrads, ("f0", "f1"))

    # and equal to the flash-matching path of the port
    monkeypatch.undo()
    qk_flow, _ = matching.global_correlation_softmax(_t(f0), _t(f1), bidir)
    np.testing.assert_allclose(flow.detach().numpy(), qk_flow.numpy(), **TOL)


def test_gmflow_config_switches_reach_the_model():
    from emip_tpu_torch.models.gmflow import GMFlow, GMFlowConfig

    assert GMFlowConfig().global_match_qk_fused is True
    assert GMFlowConfig().fused_block_max_t == 784
    gm = GMFlow(GMFlowConfig(feature_channels=32, num_transformer_layers=2,
                             ffn_dim_expansion=2, fused_block_max_t=0,
                             global_match_qk_fused=False))
    assert all(b.fused_block_max_t == 0 for b in gm.transformer.layers)
    rng = np.random.default_rng(71)
    f0 = _t(rng.standard_normal((1, 32, 8, 8)).astype(np.float32))
    f1 = _t(rng.standard_normal((1, 32, 8, 8)).astype(np.float32))
    ref = GMFlow(GMFlowConfig(feature_channels=32, num_transformer_layers=2,
                              ffn_dim_expansion=2))
    ref.load_state_dict(gm.state_dict())
    with torch.no_grad():
        fw, bw, corr = gm.eval()([f0], [f1])
        rfw, rbw, rcorr = ref.eval()([f0], [f1])
    # flows are multiplied by 8 in the convex upsample
    torch.testing.assert_close(fw[-1], rfw[-1], rtol=1e-4, atol=5e-4)
    torch.testing.assert_close(bw[-1], rbw[-1], rtol=1e-4, atol=5e-4)
    torch.testing.assert_close(corr, rcorr, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ fused MixFFN (J)


def _mixffn_pair(use_fused, dwconv_impl):
    """(JAX MixFFN with the fused kernel, variables, port MixFFN with the
    same weights, input)."""
    from emip_tpu.models.pvt_v2 import MixFFN as JaxMixFFN
    from emip_tpu_torch.models.pvt_v2 import MixFFN

    rng = np.random.default_rng(80)
    x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    jm = JaxMixFFN(dim=16, hidden=32, use_fused=use_fused,
                   dwconv_impl=dwconv_impl)
    v = th.random_variables(jm, x, seed=8)
    o = convert._Out(v["params"], {})
    o.dense("fc1", "fc1")
    o.dense("fc2", "fc2")
    o.conv("dwconv.dwconv", "dwconv")
    port = MixFFN(16, 32, use_fused, dwconv_impl)
    port.load_state_dict({k: _t(a) for k, a in o.sd.items()}, strict=True)
    return jm, v, port, x


@pytest.mark.parametrize("use_fused,dwconv_impl", [
    ("always", "conv"), ("never", "bwd_fused"), ("never", "conv")])
def test_mixffn_and_grads_match_jax(use_fused, dwconv_impl, monkeypatch):
    from emip_tpu_torch.models import pvt_v2

    jm, v, port, x = _mixffn_pair(use_fused, dwconv_impl)
    want, vjp = jax.vjp(lambda v, x: jm.apply(v, x), v, x)
    cot = np.random.default_rng(81).standard_normal(want.shape).astype(
        np.float32)
    gv, gx = vjp(cot)

    flags = []
    monkeypatch.setattr(
        pvt_v2, "fused_dwconv_gelu",
        lambda *a, **k: flags.append(k["library_forward"])
        or K.fused_dwconv_gelu(*a, **k))
    xt = _t(x.reshape(2, 48, 16), True)
    got = port(xt, 6, 8)
    # kernel J's wrapper is on the path exactly when a switch asks for it
    assert flags == {"always": [False], "never": (
        [True] if dwconv_impl == "bwd_fused" else [])}[use_fused]
    np.testing.assert_allclose(got.detach().numpy().reshape(want.shape),
                               np.asarray(want), **TOL)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad(got, [xt] + list(params.values()),
                                _t(cot.reshape(2, 48, 16)))
    assert _relmax(grads[0].numpy().reshape(x.shape), gx) <= VJP_REL
    got_g = dict(zip(params, grads[1:]))
    gp = gv["params"]
    assert _relmax(got_g["fc1.weight"].numpy().T, gp["fc1"]["kernel"]) <= VJP_REL
    assert _relmax(got_g["fc2.bias"].numpy(), gp["fc2"]["bias"]) <= VJP_REL
    assert _relmax(got_g["dwconv.dwconv.bias"].numpy(),
                   gp["dwconv"]["bias"]) <= VJP_REL
    # [F, 1, 3, 3] against flax's [3, 3, 1, F]
    assert _relmax(got_g["dwconv.dwconv.weight"].numpy().transpose(2, 3, 1, 0),
                   gp["dwconv"]["kernel"]) <= VJP_REL


@pytest.mark.parametrize("switch", [dict(fused_ffn="always"),
                                    dict(ffn_dwconv="bwd_fused")])
def test_tiny_pvt_with_fused_ffn_matches_jax(switch):
    """A 4-stage PVT with the MixFFN switch set on both sides: the same
    ``state_dict`` keys as the default, the same stage features as JAX."""
    from emip_tpu.models.pvt_v2 import PVTv2 as JaxPVTv2
    from emip_tpu.models.pvt_v2 import PVTv2Config as JaxCfg
    from emip_tpu_torch.models.pvt_v2 import PVTv2, PVTv2Config

    depths = (1, 1, 1, 1)
    dims, heads, ratios = (32, 64, 160, 256), (1, 2, 5, 8), (8, 8, 4, 4)
    jm = JaxPVTv2(config=JaxCfg(dims, heads, ratios, depths, (8, 4, 2, 1),
                                remat=False, fused_attn="always", **switch))
    rng = np.random.default_rng(82)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    v = th.random_variables(jm, x, seed=9)
    o = convert._Out({"backbone": v["params"]}, {})
    convert._pvt_into(o, "backbone", depths)
    prefix = "backbone.feat_net.pvtv2_en."
    sd = {k[len(prefix):]: _t(a) for k, a in o.sd.items()}
    port = PVTv2(PVTv2Config(dims, heads, ratios, depths, **switch)).eval()
    default = PVTv2(PVTv2Config(dims, heads, ratios, depths))
    assert list(port.state_dict()) == list(default.state_dict())
    port.load_state_dict(sd, strict=True)
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = port(th.nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(th.nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=2e-4)


def test_mixffn_switches_are_validated_and_configurable(tmp_path):
    """The two switches take the JAX package's values only, default to its
    defaults, and are reachable from the YAML configuration beside the
    GMFlow ones."""
    import yaml

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.models.backbones import create_backbone
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS, PVTv2Config

    assert (PVTv2Config().fused_ffn, PVTv2Config().ffn_dwconv) == (
        "never", "conv")
    with pytest.raises(ValueError, match="fused_ffn"):
        PVTv2Config(fused_ffn="auto")
    with pytest.raises(ValueError, match="ffn_dwconv"):
        PVTv2Config(ffn_dwconv="shift")
    b0 = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b0"], depths=(1, 1, 1, 1))
    pvt, _ = create_backbone(b0, fused_ffn="always", ffn_dwconv=None)
    assert pvt.config.fused_ffn == "always"
    assert pvt.block1[0].mlp.use_fused == "always"
    assert pvt.block1[0].mlp.dwconv_impl == "conv"

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(dict(model=dict(args=dict(
        backbone_name="pvt_v2_b0", inp_size=512, fused_ffn="always",
        ffn_dwconv="bwd_fused",
        GMFlow=dict(feature_channels=64, global_match_qk_fused=False,
                    fused_block_max_t=100))))))
    cfg = load_config(str(path)).model
    assert (cfg.inp_size, cfg.fused_ffn, cfg.ffn_dwconv) == (
        512, "always", "bwd_fused")
    assert cfg.gmflow.global_match_qk_fused is False
    assert cfg.gmflow.fused_block_max_t == 100
    path.write_text(yaml.safe_dump(dict(model=dict(args=dict(
        backbone_name="pvt_v2_b0", GMFlow=dict(feature_channels=64))))))
    cfg = load_config(str(path)).model
    assert (cfg.fused_ffn, cfg.ffn_dwconv) == (None, None)
    assert cfg.gmflow.global_match_qk_fused is True
    assert cfg.gmflow.fused_block_max_t == 784


# ----------------------------------- a second input size, layer-wise (long)

SIZE2 = 96  # 12 x 12 flow features, windows of 36 tokens, 9 reduced keys


@pytest.fixture(scope="module")
def long_pair_96():
    """(JAX EMIPLong, variables, port EMIPLong) at 96^2 with identical
    weights; the port's transformer blocks run layer-wise (G, H)."""
    jm = th.jax_tiny_long(size=SIZE2)
    img = np.zeros((1, SIZE2, SIZE2, 3), np.float32)
    variables = th.random_variables(jm, img, img, jm.init_memory(1), seed=43,
                                    train=False)
    port = th.torch_tiny_long(size=SIZE2, fused_block_max_t=16)
    port.load_state_dict(
        state_dict_from_flax_long(variables, th.DEPTHS, th.NUM_LAYERS),
        strict=True)
    return jm, variables, port


def test_long_clip_at_a_second_size_matches_jax(long_pair_96, monkeypatch):
    """A 3-frame clip streamed at 96^2 (nothing may assume one input size:
    conv_corr 144 -> 72, a [3, 144, 64] ring) with the JAX transformer
    layer-wise too: frame 0's short mask, both long masks, the memory."""
    jm, variables, port = long_pair_96
    monkeypatch.setenv("EMIP_FUSED_BLOCK_MAX_T", "16")
    rng = np.random.default_rng(90)
    f = [rng.standard_normal((1, SIZE2, SIZE2, 3)).astype(np.float32)
         for _ in range(3)]
    jstep = jax.jit(lambda v, a, b, s: jm.apply(v, a, b, s, False))
    jmem = jm.init_memory(1)
    jmask1, jshort0, jmem = jstep(variables, f[0], f[1], jmem)
    jmask2, _, jmem = jstep(variables, f[1], f[2], jmem)

    before = dict(K.LAUNCHES)
    with torch.no_grad():
        masks = port.scan_video(torch.stack([th.nchw(x) for x in f], dim=1))
        state = port.init_memory(1)
        _, _, state = port.step(th.nchw(f[0]), th.nchw(f[1]), state)
        _, _, state = port.step(th.nchw(f[1]), th.nchw(f[2]), state)
    assert K.LAUNCHES == before
    assert masks.shape == (1, 3, 1, SIZE2, SIZE2)
    for got, want in zip(masks[0], (jshort0, jmask1, jmask2)):
        np.testing.assert_allclose(th.nhwc(got[None]), np.asarray(want),
                                   **MASK_TOL)
    h8 = SIZE2 // 8
    assert state.keys.shape == (1, th.MEMORY_SIZE, h8 * h8, th.FDIM)
    np.testing.assert_allclose(
        state.keys.reshape(1, th.MEMORY_SIZE, h8, h8, th.FDIM).numpy(),
        np.asarray(jmem.keys), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(state.valid.numpy(), np.asarray(jmem.valid))


def test_frames_of_another_size_than_the_models_raise(long_pair_96):
    _, _, port = long_pair_96
    with pytest.raises(ValueError, match="built for inp_size 96"):
        port.encode_frame(torch.zeros(1, 3, 64, 64))


@pytest.mark.slow
def test_conv_corr_weights_carry_at_512():
    """The 512^2 correlation embedding (4096 -> 2048 -> 128 channels, 302
    MB of fp32 weights): flax kernels [3, 3, in, out] arrive as torch
    [out, in, 3, 3] under the reference's keys."""
    rng = np.random.default_rng(91)
    k0 = rng.standard_normal((3, 3, 4096, 2048)).astype(np.float32)
    k3 = rng.standard_normal((3, 3, 2048, 128)).astype(np.float32)
    o = convert._Out({"conv_corr_0": dict(kernel=k0, bias=np.zeros(2048)),
                      "conv_corr_3": dict(kernel=k3, bias=np.zeros(128))}, {})
    o.conv("conv_corr.0", "conv_corr_0")
    o.conv("conv_corr.3", "conv_corr_3")
    assert o.sd["conv_corr.0.weight"].shape == (2048, 4096, 3, 3)
    assert o.sd["conv_corr.3.weight"].shape == (128, 2048, 3, 3)
    np.testing.assert_array_equal(o.sd["conv_corr.0.weight"][5, 7],
                                  k0[:, :, 7, 5])
