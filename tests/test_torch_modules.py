"""The port's kernel-holding modules against their JAX counterparts.

Each JAX module gets seeded random variables (tests/torch_helpers.py);
``emip_tpu_torch.convert`` turns them into the port's weights, so both
sides compute with identical parameters on the same numpy inputs. The JAX
side runs its Pallas kernels in interpret mode (``fused_attn="always"``,
``use_fused_attn=True``, ``use_pallas=True``); where the JAX package has
an XLA path it is held against the port too. fp32; tolerance 1e-4
absolute and relative (5e-4 through a whole GMFlow, whose 8x convex
upsample multiplies flow errors by 8).
"""

import jax
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch import convert

TOL = dict(rtol=1e-4, atol=1e-4)


def _sub_state(o, prefix):
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in o.sd.items() if k.startswith(prefix)}


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


# ---------------------------------------------------------- PVT / kernel A


@pytest.mark.parametrize("sr_ratio,heads", [(2, 2), (1, 4)])
def test_sr_attention_module_matches_jax(sr_ratio, heads):
    from emip_tpu.models.pvt_v2 import SRAttention as JaxSRAttention
    from emip_tpu_torch.models.pvt_v2 import SRAttention

    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    fused = JaxSRAttention(dim=64, num_heads=heads, sr_ratio=sr_ratio,
                           use_fused="always")
    plain = JaxSRAttention(dim=64, num_heads=heads, sr_ratio=sr_ratio,
                           use_fused="never")
    v = th.random_variables(fused, x, seed=1)
    o = convert._Out(v["params"], {})
    for name in ("q", "kv", "proj"):
        o.dense(name, name)
    if sr_ratio > 1:
        o.conv("sr", "sr")
        o.ln("norm", "norm")
    port = _load(SRAttention(64, heads, sr_ratio), _sub_state(o, ""))
    with torch.no_grad():
        got = port(torch.from_numpy(x.reshape(2, 64, 64)), 8, 8).numpy()
    for model in (fused, plain):
        want = np.asarray(model.apply(v, x)).reshape(2, 64, 64)
        np.testing.assert_allclose(got, want, **TOL)


def test_pvt_v2_matches_jax():
    from emip_tpu.models.pvt_v2 import PVTv2 as JaxPVTv2
    from emip_tpu.models.pvt_v2 import PVTv2Config as JaxCfg
    from emip_tpu_torch.models.pvt_v2 import PVTv2, PVTv2Config

    depths = (1, 1, 2, 1)
    dims, heads, ratios = (32, 64, 160, 256), (1, 2, 5, 8), (8, 8, 4, 4)
    jm = JaxPVTv2(config=JaxCfg(dims, heads, ratios, depths, (8, 4, 2, 1),
                                remat=False, fused_attn="always"))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    v = th.random_variables(jm, x, seed=2)
    o = convert._Out({"backbone": v["params"]}, {})
    convert._pvt_into(o, "backbone", depths)
    port = _load(PVTv2(PVTv2Config(dims, heads, ratios, depths)),
                 _sub_state(o, "backbone.feat_net.pvtv2_en."))
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = port(th.nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(th.nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=2e-4)


# -------------------------------------------------- flow transformer / B


def _transformer_state(v, num_layers, module_prefix):
    o = convert._Out({"t": v["params"]}, {})
    convert._transformer_into(o, "t", "x", num_layers)
    return {module_prefix + k[2:]: torch.from_numpy(np.array(a))
            for k, a in o.sd.items()}


@pytest.mark.parametrize("shifted", [False, True])
def test_transformer_block_matches_jax(shifted):
    from emip_tpu.models.gmflow.transformer import (
        TransformerBlock as JaxBlock,
    )
    from emip_tpu_torch.models.gmflow.transformer import TransformerBlock

    rng = np.random.default_rng(9 + shifted)
    src = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    tgt = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    mods = [JaxBlock(32, ffn_dim_expansion=2, with_shift=shifted,
                     use_fused_attn=fused) for fused in (True, False)]
    v = th.random_variables(mods[0], src, tgt, attn_num_splits=2, seed=4)
    # a one-block "transformer" tree: layer0 = this block
    sd = _transformer_state({"params": {"layer0": v["params"]}}, 1, "")
    sd = {k[len("layers.0."):]: a for k, a in sd.items()}
    port = _load(TransformerBlock(32, 2, with_shift=shifted), sd)
    with torch.no_grad():
        got = port(torch.from_numpy(src), torch.from_numpy(tgt), 2).numpy()
    for model in mods:  # Pallas whole-block kernel, then the XLA layers
        np.testing.assert_allclose(got, np.asarray(model.apply(v, src, tgt, 2)),
                                   **TOL)


def test_feature_transformer_matches_jax():
    from emip_tpu.models.gmflow.transformer import (
        FeatureTransformer as JaxFT,
    )
    from emip_tpu_torch.models.gmflow.transformer import FeatureTransformer

    rng = np.random.default_rng(11)
    f0 = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    f1 = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    jm = JaxFT(num_layers=2, d_model=32, ffn_dim_expansion=2,
               use_fused_attn=True)
    v = th.random_variables(jm, f0, f1, attn_num_splits=2, seed=5)
    port = _load(FeatureTransformer(2, 32, 2),
                 _transformer_state(v, 2, ""))
    a0, a1 = jm.apply(v, f0, f1, attn_num_splits=2)
    with torch.no_grad():
        b0, b1 = port(torch.from_numpy(f0), torch.from_numpy(f1), 2)
    np.testing.assert_allclose(b0.numpy(), np.asarray(a0), **TOL)
    np.testing.assert_allclose(b1.numpy(), np.asarray(a1), **TOL)


# -------------------------------------- matching + propagation / kernel C


@pytest.mark.parametrize("bidir", [True, False])
def test_global_correlation_softmax_matches_jax(bidir):
    from emip_tpu.models.gmflow.matching import (
        global_correlation_softmax as jax_gcs,
    )
    from emip_tpu_torch.models.gmflow.matching import (
        global_correlation_softmax,
    )

    rng = np.random.default_rng(12)
    f0 = rng.standard_normal((2, 8, 10, 32)).astype(np.float32)
    f1 = rng.standard_normal((2, 8, 10, 32)).astype(np.float32)
    flow, corr = global_correlation_softmax(torch.from_numpy(f0),
                                            torch.from_numpy(f1), bidir)
    for use_pallas in (True, False):
        wflow, _, wcorr = jax_gcs(f0, f1, bidir, use_pallas=use_pallas)
        np.testing.assert_allclose(flow.numpy(), np.asarray(wflow), **TOL)
        np.testing.assert_allclose(corr.numpy(), np.asarray(wcorr), **TOL)


def test_feature_flow_attention_matches_jax():
    from emip_tpu.models.gmflow.transformer import (
        FeatureFlowAttention as JaxFFA,
    )
    from emip_tpu_torch.models.gmflow.transformer import FeatureFlowAttention

    rng = np.random.default_rng(13)
    feat = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    flow = (rng.standard_normal((2, 8, 8, 2)) * 4).astype(np.float32)
    mods = [JaxFFA(in_channels=32, use_pallas=p) for p in (True, False)]
    v = th.random_variables(mods[0], feat, flow, seed=6)
    o = convert._Out(v["params"], {})
    o.dense("q_proj", "q_proj")
    o.dense("k_proj", "k_proj")
    port = _load(FeatureFlowAttention(32), _sub_state(o, ""))
    with torch.no_grad():
        got = port(torch.from_numpy(feat), torch.from_numpy(flow)).numpy()
    for model in mods:
        np.testing.assert_allclose(got, np.asarray(model.apply(v, feat, flow)),
                                   **TOL)


# ------------------------------------------------------ GMFlow / kernel D


def test_gmflow_matches_jax():
    from emip_tpu.models.gmflow import GMFlow as JaxGMFlow
    from emip_tpu.models.gmflow import GMFlowConfig as JaxCfg
    from emip_tpu_torch.models.gmflow import GMFlow, GMFlowConfig

    c = 32
    jm = JaxGMFlow(config=JaxCfg(feature_channels=c, num_transformer_layers=2,
                                 ffn_dim_expansion=2))
    rng = np.random.default_rng(15)
    f0 = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    f1 = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    img = np.zeros((1, 64, 64, 3), np.float32)
    shapes_v = th.random_variables(
        jm, img, method=lambda m, x: (m.encode(x), m([f0], [f1])), seed=7)
    o = convert._Out({"gmflow": shapes_v["params"]}, {})
    convert._gmflow_into(o, "gmflow", 2)
    port = _load(GMFlow(GMFlowConfig(feature_channels=c,
                                     num_transformer_layers=2,
                                     ffn_dim_expansion=2)),
                 _sub_state(o, "GMFlow."))
    fw, bw, corr = jax.jit(lambda v: jm.apply(v, [f0], [f1]))(shapes_v)
    with torch.no_grad():
        pfw, pbw, pcorr = port([th.nchw(f0)], [th.nchw(f1)])
    tol = dict(rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(th.nhwc(pfw[-1]), np.asarray(fw[-1]), **tol)
    np.testing.assert_allclose(th.nhwc(pbw[-1]), np.asarray(bw[-1]), **tol)
    np.testing.assert_allclose(pcorr.numpy(), np.asarray(corr), **TOL)


# ------------------------------------------- modules around the kernels


def test_injector_and_cnn_encoder_match_jax():
    from emip_tpu.models.gmflow.encoder import CNNEncoder as JaxEncoder
    from emip_tpu.models.prompt import Injector as JaxInjector
    from emip_tpu_torch.models.gmflow.encoder import CNNEncoder
    from emip_tpu_torch.models.prompt import Injector

    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 6, 6, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 6, 32)).astype(np.float32)
    ji = JaxInjector(dim=32)
    vi = th.random_variables(ji, x, ctx, seed=8)
    o = convert._Out({"inj": vi["params"]}, {})
    convert._injector_into(o, "inj")
    port = _load(Injector(32), _sub_state(o, "inj."))
    with torch.no_grad():
        got = th.nhwc(port(th.nchw(x), th.nchw(ctx)))
    np.testing.assert_allclose(got, np.asarray(ji.apply(vi, x, ctx)), **TOL)

    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    je = JaxEncoder(output_dim=64)
    ve = th.random_variables(je, img, seed=9)
    o = convert._Out({"gmflow": {"backbone": ve["params"]}}, {})
    bb = "gmflow/backbone"
    o.conv("conv1", f"{bb}/conv1")
    for L in (1, 2, 3):
        for j in (0, 1):
            for n in ("conv1", "conv2", "downsample"):
                if o.has(f"{bb}/layer{L}_{j}/{n}"):
                    dst = f"layer{L}.{j}." + ("downsample.0" if n ==
                                              "downsample" else n)
                    o.conv(dst, f"{bb}/layer{L}_{j}/{n}")
    for n in ("conv2", "dwconv64", "dwconv96", "dwconv128", "dwconv",
              "dwconv_pre", "dwconv_post"):
        o.conv(n, f"{bb}/{n}")
    enc = _load(CNNEncoder(64), _sub_state(o, ""))
    with torch.no_grad():
        got = th.nhwc(enc(th.nchw(img))[0])
    np.testing.assert_allclose(got, np.asarray(je.apply(ve, img)[0]), **TOL)
