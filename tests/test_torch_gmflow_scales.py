"""Multi-scale GMFlow of the port against the JAX package's.

GMFlow's refinement configuration at a small size: two scales (global
matching and propagation at the coarse one, local matching of radius 2
and local propagation of radius 1 at the fine one), 32 channels, two
transformer blocks, FFN x2, x4 convex upsampling, windows split 2 and 4
ways. Both packages get the same seeded weights (``convert``) and the same
numpy features; the JAX side runs its Pallas kernels in interpret mode.
Held: the forward and backward flows, the training lists (each scale's
upsampled flow before and after propagation) and the correlation volume,
in fp32 (tolerance 1e-4 relative, 5e-4 absolute, as the one-scale GMFlow
test: the x4 and x8 upsamplings multiply flow errors) and in bf16 (the
correlation volume to 2e-2 of max|ref|, the bf16 band's module tolerance
of tests/test_torch_bf16.py; each flow within 2x JAX's own bf16-vs-fp32
gap on it);
one case has odd windows (10 x 10 and 20 x 20 maps: 25 tokens a window at
both scales). Local matching and local propagation are also held alone,
and the port's warp of bf16 features against JAX's ``flow_warp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch import convert
from emip_tpu_torch.dtypes import set_compute_dtype

C = 32
CFG = dict(num_scales=2, upsample_factor=4, feature_channels=C,
           num_transformer_layers=2, ffn_dim_expansion=2,
           attn_splits_list=(2, 4), corr_radius_list=(-1, 2),
           prop_radius_list=(-1, 1))
TOL = dict(rtol=1e-4, atol=5e-4)
BF16_REL = 2e-2


def _features(seed: int, side: int):
    """Seeded NHWC features of both frames at both scales (side, 2 side)."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((2, s, s, C)).astype(np.float32)
             for s in (side, 2 * side)] for _ in range(2)]


@pytest.fixture(scope="module")
def weights():
    """JAX GMFlow's seeded variables and the port's state dict of them."""
    from emip_tpu.models.gmflow import GMFlow as JaxGMFlow
    from emip_tpu.models.gmflow import GMFlowConfig as JaxCfg

    jm = JaxGMFlow(config=JaxCfg(**CFG))
    f0, f1 = _features(40, 8)
    img = np.zeros((1, 32, 32, 3), np.float32)
    variables = th.random_variables(
        jm, img, method=lambda m, x: (m.encode(x), m(f0, f1)), seed=41)
    o = convert._Out({"gmflow": variables["params"]}, {})
    convert._gmflow_into(o, "gmflow", CFG["num_transformer_layers"])
    state = {k[len("GMFlow."):]: torch.from_numpy(np.array(v))
             for k, v in o.sd.items() if k.startswith("GMFlow.")}
    return variables, state


def _port(state, dtype=torch.float32):
    from emip_tpu_torch.models.gmflow import GMFlow, GMFlowConfig

    model = GMFlow(GMFlowConfig(**CFG))
    model.load_state_dict(state, strict=True)
    set_compute_dtype(model, dtype)
    return model.eval()


_JITTED = {}


def _jax(variables, f0, f1, dtype):
    """JAX GMFlow's (fw list, bw list, corr) at training=True (one jitted
    function a dtype, compiled once a shape)."""
    from emip_tpu.models.gmflow import GMFlow as JaxGMFlow
    from emip_tpu.models.gmflow import GMFlowConfig as JaxCfg

    if dtype not in _JITTED:
        jm = JaxGMFlow(config=JaxCfg(**CFG), dtype=dtype)
        _JITTED[dtype] = jax.jit(
            lambda v, a, b: jm.apply(v, a, b, training=True))
    cast = [[jnp.asarray(a, dtype) for a in fs] for fs in (f0, f1)]
    return _JITTED[dtype](variables, *cast)


def _run_port(model, f0, f1, dtype):
    with torch.no_grad():
        ins = [[th.nchw(a).to(dtype) for a in fs] for fs in (f0, f1)]
        fws, bws, corr = model(*ins, training=True)
        last = model(*ins)
    assert len(last[0]) == 1
    np.testing.assert_array_equal(th.nhwc(last[0][0].float()),
                                  th.nhwc(fws[-1].float()))
    return fws, bws, corr


@pytest.mark.parametrize("side", [8, 10])
def test_gmflow_two_scales_matches_jax(weights, side):
    variables, state = weights
    f0, f1 = _features(42 + side, side)
    jfw, jbw, jcorr = _jax(variables, f0, f1, jnp.float32)
    fws, bws, corr = _run_port(_port(state), f0, f1, torch.float32)
    assert len(fws) == len(jfw) == 4
    for got, want in zip(fws + bws, list(jfw) + list(jbw)):
        np.testing.assert_allclose(th.nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(corr.numpy(), np.asarray(jcorr),
                               rtol=1e-4, atol=1e-4)


def _rel(got: torch.Tensor, want) -> float:
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    g = got.double().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def test_gmflow_two_scales_bf16_matches_jax(weights):
    """bf16 features from the transformer to the upsampler's convs, fp32
    flows and correlation volume on both sides. The correlation volume is
    held to 2e-2 of max|ref|. The flows are not: with seeded weights the
    fine scale's local matching is soft, and bf16 moves JAX's own flows by
    5-17% of max|ref| from its fp32 ones (the later the output, the more).
    Each flow is held within 2x JAX's own bf16-vs-fp32 gap on it, the
    band's rule on the card, and the port's flows are shown to move off
    its fp32 ones (they compute in bf16)."""
    variables, state = weights
    f0, f1 = _features(50, 8)
    # both sides start from the same bf16 features
    f0, f1 = ([np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in fs] for fs in (f0, f1))
    jfw, jbw, jcorr = _jax(variables, f0, f1, jnp.bfloat16)
    j32 = _jax(variables, f0, f1, jnp.float32)
    fws, bws, corr = _run_port(_port(state, torch.bfloat16), f0, f1,
                               torch.bfloat16)
    p32 = _run_port(_port(state), f0, f1, torch.float32)
    for got, want, ref32, port32 in zip(fws + bws, list(jfw) + list(jbw),
                                        list(j32[0]) + list(j32[1]),
                                        p32[0] + p32[1]):
        assert got.dtype == torch.float32
        got = got.permute(0, 2, 3, 1)
        gap = _rel(torch.from_numpy(np.asarray(want, np.float32)), ref32)
        assert _rel(got, want) <= 2 * gap
        assert _rel(got, port32.permute(0, 2, 3, 1).numpy()) > 1e-4
    assert corr.dtype == torch.float32
    assert _rel(corr, jcorr) <= BF16_REL


@pytest.mark.parametrize("radius,h,w", [(2, 6, 9), (4, 11, 7)])
def test_local_correlation_softmax_matches_jax(radius, h, w):
    from emip_tpu.models.gmflow.matching import (
        local_correlation_softmax as jax_local,
    )
    from emip_tpu_torch.models.gmflow.matching import (
        local_correlation_softmax,
    )

    rng = np.random.default_rng(60 + radius)
    f0 = rng.standard_normal((2, h, w, 16)).astype(np.float32)
    f1 = rng.standard_normal((2, h, w, 16)).astype(np.float32)
    jflow, jprob = jax_local(f0, f1, radius)
    flow, prob = local_correlation_softmax(torch.from_numpy(f0),
                                           torch.from_numpy(f1), radius)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("radius", [1, 2])
def test_local_propagation_matches_jax(radius):
    from emip_tpu.models.gmflow.transformer import (
        FeatureFlowAttention as JaxFFA,
    )
    from emip_tpu_torch.models.gmflow.transformer import FeatureFlowAttention

    rng = np.random.default_rng(70 + radius)
    feat = rng.standard_normal((2, 7, 9, C)).astype(np.float32)
    flow = (rng.standard_normal((2, 7, 9, 2)) * 3).astype(np.float32)
    jm = JaxFFA(in_channels=C)
    local = dict(local_window_attn=True, local_window_radius=radius)
    v = th.random_variables(jm, feat, flow, seed=71, **local)
    want = jm.apply(v, feat, flow, **local)
    o = convert._Out(v["params"], {})
    o.dense("q_proj", "q_proj")
    o.dense("k_proj", "k_proj")
    port = FeatureFlowAttention(C)
    port.load_state_dict({k: torch.from_numpy(np.array(a))
                          for k, a in o.sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(feat), torch.from_numpy(flow), True,
                   radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_flow_warp_bf16_samples_in_fp32():
    """Warping bf16 features (multi-scale GMFlow's feature1): fp32
    coordinates and weights, the result rounded to bf16, as JAX's
    ``flow_warp`` computes it. Before, the port sampled at bf16
    coordinates: a normalised x near 1 keeps 8 bits, so samples across 88
    columns moved by up to ~0.09 pixel."""
    from emip_tpu.ops.geometry import flow_warp as jax_warp
    from emip_tpu_torch.ops.geometry import flow_warp

    rng = np.random.default_rng(80)
    feat = rng.standard_normal((2, 12, 88, 8)).astype(np.float32)
    feat = np.asarray(jnp.asarray(feat, jnp.bfloat16), np.float32)
    flow = (rng.standard_normal((2, 12, 88, 2)) * 4).astype(np.float32)
    want = jax_warp(jnp.asarray(feat, jnp.bfloat16), flow)
    got = flow_warp(torch.from_numpy(feat).to(torch.bfloat16),
                    torch.from_numpy(flow))
    assert got.dtype == torch.bfloat16
    # equal up to one bf16 rounding of a sum taken in another order
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=8e-3, atol=8e-3)


def test_two_stream_model_refuses_two_scales():
    """GMFlow alone takes two scales; the two-stream model, whose flow
    encoder returns one scale in both packages, says so when built with
    them."""
    import dataclasses

    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.gmflow import GMFlowConfig

    cfg = EMIPShortConfig(backbone_name="pvt_v2_b0", inp_size=64,
                          gmflow=GMFlowConfig(feature_channels=64))
    two = dataclasses.replace(cfg, gmflow=GMFlowConfig(
        **dict(CFG, feature_channels=64)))
    with pytest.raises(ValueError, match="num_scales=1"):
        EMIPShort(two)
