"""The bf16 band of short inference against the JAX package in bf16.

The JAX package's published configuration computes in bfloat16
(``compute_dtype``); the port's ``EMIPShort(config, dtype=torch.bfloat16)``
follows flax's rule (fp32 parameters cast at use, fp32 normalisation
statistics and BatchNorms, fp32 accumulation) with kernels A-D in their
bf16 forwards. Here, on the CPU, each kernel's plain bf16 version, each
module in bf16 and the tiny two-stream model (tests/torch_helpers.py: b0
widths, depths (1, 1, 1, 1), 64^2, exact GELU) run on the same numpy
inputs and weights as the JAX package in bf16, its Pallas kernels in
interpret mode. Inputs are rounded to bf16 the same way on both sides.
The bf16 backwards and the bf16 train steps are in
tests/test_torch_bf16_train.py.

Tolerances, as max|err| / max|ref|: kernels 8e-3 (two bf16 ulps: both
sides round at the same points, sums run in another order), modules 2e-2
(bf16 through several layers). The whole slice is held to the band JAX's
own bf16 leaves against its fp32 (see :func:`test_short_model_bf16_band`),
and shown to compute in bf16 rather than fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch import kernels as K
from emip_tpu_torch.convert import state_dict_from_flax

BF16 = torch.bfloat16
KERNEL_REL = 8e-3
MODULE_REL = 2e-2


def _np(x) -> np.ndarray:
    """A torch or JAX array as fp64 numpy."""
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _tb(x):
    """numpy fp32 -> torch bf16 (round to nearest even, as JAX rounds)."""
    return _t(x).to(BF16)


def _jb(x):
    return jnp.asarray(x, jnp.bfloat16)


def _same_dtype(got: torch.Tensor, want) -> None:
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    assert names[got.dtype] == str(jnp.asarray(want).dtype), (got.dtype,
                                                              want.dtype)


# ------------------------------------------------------------ kernels


def test_gemm_bf16_matches_jax():
    """The bf16 GEMM's plain version: bf16 operands, fp32 sums, the fp32
    bias, one rounding (or the fp32 sums where the caller rounds later)."""
    from emip_tpu_torch.kernels.gemm import gemm

    rng = np.random.default_rng(1)
    a = rng.standard_normal((300, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)  # [in, out]
    bias = (rng.standard_normal(96) * 0.1).astype(np.float32)
    acc = jnp.dot(_jb(a), _jb(w), preferred_element_type=jnp.float32)
    for out_dtype, want in ((None, (acc + bias).astype(jnp.bfloat16)),
                            (torch.float32, acc)):
        got = gemm(_tb(a), _tb(w.T).t(), None if out_dtype else _t(bias),
                   out_dtype=out_dtype)
        _same_dtype(got, want)
        assert _rel(got, want) <= KERNEL_REL


@pytest.mark.parametrize("n,m,c,heads", [(64, 16, 64, 2), (36, 9, 64, 1),
                                         (49, 49, 32, 1)])
def test_sr_attention_bf16_matches_pallas(n, m, c, heads):
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    rng = np.random.default_rng(200 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, kv_in = f(2, n, c), f(2, m, c)
    wq, wkv, wp = f(c, c) / c**0.5, f(c, 2 * c) / c**0.5, f(c, c) / c**0.5
    bq, bkv, bp = f(c) * 0.1, f(2 * c) * 0.1, f(c) * 0.1
    want = fused_sr_attention(_jb(x), _jb(kv_in), _jb(wq), bq, _jb(wkv),
                              bkv, _jb(wp), bp, heads)
    before = dict(K.LAUNCHES)
    got = K.fused_sr_attention(_tb(x), _tb(kv_in), _tb(wq.T), _t(bq),
                               _tb(wkv.T), _t(bkv), _tb(wp.T), _t(bp), heads)
    _same_dtype(got, want)
    assert _rel(got, want) <= KERNEL_REL
    assert K.LAUNCHES == before  # the plain version launches nothing


@pytest.mark.parametrize("shifted", [False, True])
def test_window_block_bf16_matches_pallas(shifted):
    """B in bf16 is mixed: a bf16 self layer, then the fp32 cross layer and
    FFN on fp32 weights, the output rounded to bf16."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(17 + shifted)
    b, k2, tok, c, f = 2, 4, 16, 64, 128
    x = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    t = rng.standard_normal((b, k2, tok, c)).astype(np.float32)

    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    def ln():
        return (rng.uniform(0.7, 1.3, c).astype(np.float32),
                rng.normal(0, 0.05, c).astype(np.float32))

    sp = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c))
    sp["s1"], sp["b1"] = ln()
    cp = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
              w0=w(2 * c, f), w2=w(f, c))
    cp["s1"], cp["b1"] = ln()
    cp["s2"], cp["b2"] = ln()
    mask = np.asarray(shifted_window_mask(8, 8, 2)) if shifted else None
    want = fused_window_attention_block(
        _jb(x), _jb(t), sp, cp, None if mask is None else jnp.asarray(mask))

    def torch_layout(p):
        return {k: _t(v.T if v.ndim == 2 else v) for k, v in p.items()}

    got = K.fused_window_attention_block(
        _tb(x), _tb(t), torch_layout(sp), torch_layout(cp),
        None if mask is None else _t(mask))
    _same_dtype(got, want)
    assert _rel(got, want) <= KERNEL_REL


@pytest.mark.parametrize("b,l,c", [(2, 64, 64), (3, 100, 128)])
def test_flow_attention_bf16_matches_pallas(b, l, c):
    """C with bf16 q and k, fp32 values: fp32 out."""
    from emip_tpu.ops.pallas import fused_flow_attention

    rng = np.random.default_rng(300 + l)
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    want = fused_flow_attention(_jb(q), _jb(k), v)
    got = K.fused_flow_attention(_tb(q), _tb(k), _t(v))
    _same_dtype(got, want)
    assert _rel(got, want) <= KERNEL_REL


def test_convex_upsample_bf16_matches_pallas():
    """D reads bf16 logits and computes in fp32: fp32 out."""
    from emip_tpu.ops.pallas.convex_upsample import convex_upsample_pallas

    rng = np.random.default_rng(4)
    flow = (rng.standard_normal((2, 8, 8, 2)) * 3).astype(np.float32)
    mask = rng.standard_normal((2, 8, 8, 9 * 64)).astype(np.float32)
    want = convex_upsample_pallas(flow, _jb(mask), 8)
    got = K.convex_upsample(_t(flow), _tb(mask), 8)
    _same_dtype(got, want)
    assert _rel(got, want) <= KERNEL_REL


# ----------------------------------------------------- models, fixtures


@pytest.fixture(scope="module")
def models():
    """The tiny EMIPShort of both packages in bf16 (and JAX's in fp32, and
    the port's in fp32) on one set of seeded variables. The port's models
    load the same fp32 state dict: ``convert`` needs nothing for bf16."""
    from emip_tpu.models.emip_short import EMIPShort as JaxEMIPShort

    jm32, cfg = th.jax_tiny_short()
    jm16 = JaxEMIPShort(config=cfg, dtype=jnp.bfloat16)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm32, img, img, seed=21)
    sd = state_dict_from_flax(variables, th.DEPTHS, th.NUM_LAYERS)
    port32 = th.torch_tiny_short()
    port32.load_state_dict(sd, strict=True)
    port16 = th.torch_tiny_short(dtype=BF16)
    port16.load_state_dict(sd, strict=True)
    return dict(jm32=jm32, jm16=jm16, variables=variables, port32=port32,
                port16=port16)


def _apply(jm, variables, fn, *args):
    """``fn(module, *args)`` inside the bound JAX model, jitted."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))(variables, *args)


def test_bf16_state_dict_is_the_fp32_one(models):
    """The bf16 model holds the same fp32 parameters and buffers, under the
    same keys: checkpoints and ``convert`` serve both dtypes."""
    sd16, sd32 = models["port16"].state_dict(), models["port32"].state_dict()
    assert list(sd16) == list(sd32)
    for k, v in sd16.items():
        assert v.dtype == sd32[k].dtype and torch.equal(v, sd32[k]), k
    assert models["port16"].compute_dtype == BF16


def _frames(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, th.SIZE, th.SIZE, 3)).astype(np.float32)


def _bf16_features(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_backbone_bf16_matches_jax(models):
    """The PVT backbone (patch embeds, one PVT block per stage with kernel
    A, the stage LayerNorms) in bf16: bf16 stages, as JAX's."""
    img = _frames(30)
    want = _apply(models["jm16"], models["variables"],
                  lambda m, x: m.backbone(x), img)
    with torch.no_grad():
        got = models["port16"].backbone(th.nchw(img))
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1)
        _same_dtype(g, w)
        assert _rel(g, w) <= MODULE_REL


def test_flow_encoder_bf16_matches_jax(models):
    """GMFlow's CNN encoder: bf16 convs, fp32 InstanceNorm statistics."""
    img = _frames(31)
    want = _apply(models["jm16"], models["variables"],
                  lambda m, x: m.gmflow.encode(x)[0], img)
    with torch.no_grad():
        got = models["port16"].GMFlow.encode(th.nchw(img))[0]
    got = got.permute(0, 2, 3, 1)
    _same_dtype(got, want)
    assert _rel(got, want) <= MODULE_REL


def test_injector_bf16_matches_jax(models):
    """The camouflage feeder: fp32 channel LayerNorms, the MDTA attention
    accumulated in fp32, the gated FFN in bf16."""
    x, ctx = _bf16_features(32, (2, 8, 8, th.FDIM), (2, 8, 8, th.FDIM))
    want = _apply(models["jm16"], models["variables"],
                  lambda m, a, b: m.injector(a, b), _jb(x), _jb(ctx))
    with torch.no_grad():
        got = models["port16"].injector(_tb(x).permute(0, 3, 1, 2),
                                        _tb(ctx).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1)
    _same_dtype(got, want)
    assert _rel(got, want) <= MODULE_REL


def test_feature_transformer_bf16_matches_jax(models):
    """The two transformer blocks (unshifted, shifted) of kernel B."""
    f0, f1 = _bf16_features(33, (2, 8, 8, th.FDIM), (2, 8, 8, th.FDIM))
    want = _apply(models["jm16"], models["variables"],
                  lambda m, a, b: m.gmflow.transformer(a, b, 2), _jb(f0),
                  _jb(f1))
    with torch.no_grad():
        got = models["port16"].GMFlow.transformer(_tb(f0), _tb(f1), 2)
    for g, w in zip(got, want):
        _same_dtype(g, w)
        assert _rel(g, w) <= MODULE_REL


def test_matching_bf16_matches_jax():
    """Global matching on bf16 features: the fp32 correlation volume and
    the flow of kernel C (bf16 q, k; the fp32 pixel grid)."""
    from emip_tpu.models.gmflow.matching import (
        global_correlation_softmax as jax_match,
    )
    from emip_tpu_torch.models.gmflow.matching import (
        global_correlation_softmax,
    )

    f0, f1 = _bf16_features(34, (2, 8, 8, 64), (2, 8, 8, 64))
    jflow, _, jcorr = jax_match(_jb(f0), _jb(f1), True)
    flow, corr = global_correlation_softmax(_tb(f0), _tb(f1), True)
    for g, w in ((flow, jflow), (corr, jcorr)):
        _same_dtype(g, w)
        assert g.dtype == torch.float32
        assert _rel(g, w) <= MODULE_REL


def test_propagation_and_upsampler_bf16_match_jax(models):
    """Flow propagation (bf16 projections, kernel C: fp32 flow), then the
    upsampler's bf16 convs and kernel D on their bf16 logits."""
    from emip_tpu.ops.pallas.convex_upsample import convex_upsample_pallas

    (feat,) = _bf16_features(35, (4, 8, 8, th.FDIM))
    flow = (np.random.default_rng(36).standard_normal((4, 8, 8, 2))
            * 2).astype(np.float32)

    def jax_tail(m, f, fl):
        prop = m.gmflow.feature_flow_attn(f, fl)
        logits = m.gmflow._upsample_mask(prop, f)
        return prop, logits, convex_upsample_pallas(prop, logits, 8)

    want = _apply(models["jm16"], models["variables"], jax_tail, _jb(feat),
                  flow)
    gm = models["port16"].GMFlow
    with torch.no_grad():
        prop = gm.feature_flow_attn(_tb(feat), _t(flow))
        logits = gm._upsample_mask(prop, _tb(feat))
        got = (prop, logits, K.convex_upsample(prop, logits, 8))
    for g, w in zip(got, want):
        _same_dtype(g, w)
        assert _rel(g, w) <= MODULE_REL


def test_conv_corr_and_decode_bf16_match_jax(models):
    """conv_corr (bf16 convs around its fp32 BatchNorm), then the motion
    collector, the three dimensional reductions and the NCD: fp32 logits
    (each ConvBR's BatchNorm returns fp32)."""
    corr, f8, f16, f32 = _bf16_features(
        37, (2, 8, 8, 64), (2, 8, 8, th.FDIM), (2, 4, 4, 160),
        (2, 2, 2, 256))
    jf8, jf16, jf32 = (_jb(a) for a in (f8, f16, f32))

    def jax_decode(m, c, a, b, d):
        emb = m.conv_corr(c)
        mask, fea_new = m.decode(a, b, d, emb)
        return emb, fea_new, mask

    want = _apply(models["jm16"], models["variables"], jax_decode, corr, jf8,
                  jf16, jf32)
    port = models["port16"]
    nchw = lambda a: _tb(a).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        emb = port.conv_corr_embed(_t(corr))
        fea_new = port.injector1(nchw(f8), emb)
        mask = port.decoder(port.dr3(nchw(f32)), port.dr2(nchw(f16)),
                            port.dr1(fea_new))
    for g, w in zip((emb, fea_new, mask), want):
        g = g.permute(0, 2, 3, 1)
        _same_dtype(g, w)
        assert _rel(g, w) <= MODULE_REL


@pytest.mark.parametrize("island", ["ConvBR", "ChannelLayerNorm",
                                    "InstanceNorm", "PatchEmbedLayerNorm"])
def test_fp32_islands_have_jax_dtypes(island):
    """Normalisations keep fp32 statistics: BatchNorm (inside ConvBR)
    returns fp32, the LayerNorms and InstanceNorm return bf16, as the JAX
    modules with ``dtype=bfloat16`` do; the values agree."""
    import emip_tpu.models.common as jc
    import emip_tpu.models.gmflow.encoder as je
    import emip_tpu.models.prompt as jp
    import emip_tpu.models.pvt_v2 as jpvt
    from emip_tpu_torch import convert
    from emip_tpu_torch.dtypes import set_compute_dtype
    from emip_tpu_torch.models import common, prompt, pvt_v2
    from emip_tpu_torch.models.gmflow import encoder

    (x,) = _bf16_features(38, (2, 8, 8, 16))
    if island == "InstanceNorm":
        want = je.instance_norm(_jb(x))
        got = encoder.instance_norm(_tb(x).permute(0, 3, 1, 2))
    else:
        jmod, port, arg = {
            "ConvBR": (jc.ConvBR(8, 3, padding=1, dtype=jnp.bfloat16),
                       common.ConvBR(16, 8), _jb(x)),
            "ChannelLayerNorm": (jp.ChannelLayerNorm(),
                                 prompt.ChannelLayerNorm(16), _jb(x)),
            "PatchEmbedLayerNorm": (
                jpvt.OverlapPatchEmbed(3, 2, 16, dtype=jnp.bfloat16),
                pvt_v2.OverlapPatchEmbed(3, 2, 16, 16), x),
        }[island]
        v = th.random_variables(jmod, arg, seed=6)
        o = convert._Out(v["params"], v.get("batch_stats", {}))
        if island == "ConvBR":
            o.conv("conv", "conv")
            o.bn("bn", "bn")
        elif island == "ChannelLayerNorm":
            o.sd["body.weight"] = v["params"]["scale"]
            o.sd["body.bias"] = v["params"]["bias"]
        else:
            o.conv("proj", "proj")
            o.ln("norm", "norm")
        port.load_state_dict({k: torch.from_numpy(np.array(a))
                              for k, a in o.sd.items()}, strict=True)
        set_compute_dtype(port.eval(), BF16)
        want = jmod.apply(v, arg)
        with torch.no_grad():
            if island == "PatchEmbedLayerNorm":
                got, h, w = port(th.nchw(x))
                got = got.reshape(2, h, w, 16).permute(0, 3, 1, 2)
            else:
                got = port(_tb(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1)
    _same_dtype(got, want)
    assert _rel(got, want) <= MODULE_REL


# ------------------------------------------------------ the whole slice


@pytest.fixture(scope="module")
def slice_outputs(models):
    a, b = _frames(5), _frames(6)
    out = {}
    for name in ("jm32", "jm16"):
        mask, fw, _ = jax.jit(models[name].apply)(models["variables"], a, b)
        out[name] = dict(mask=mask, flow=fw[-1])
    for name in ("port32", "port16"):
        with torch.no_grad():
            mask, fw, _ = models[name](th.nchw(a), th.nchw(b))
        out[name] = dict(mask=mask.permute(0, 2, 3, 1),
                         flow=fw[-1].permute(0, 2, 3, 1))
    return out


@pytest.mark.parametrize("output", ["mask", "flow"])
def test_short_model_bf16_band(slice_outputs, output):
    """Let gap(X) = |X - JAX fp32| on the same inputs. The port's bf16 lies
    within 2 gap(JAX bf16) of JAX bf16 (max and mean), and its own gap from
    its fp32 is at least a quarter of JAX's: it really computes in bf16
    (a port that ran fp32 would sit next to JAX fp32)."""
    o = {k: _np(v[output]) for k, v in slice_outputs.items()}
    for k, v in slice_outputs.items():
        assert v[output].dtype in (torch.float32, jnp.float32), k
        assert np.isfinite(o[k]).all(), k
    jax_gap = np.abs(o["jm16"] - o["jm32"])
    port_err = np.abs(o["port16"] - o["jm16"])
    port_gap = np.abs(o["port16"] - o["port32"])
    assert jax_gap.max() > 0
    assert port_err.max() <= 2 * jax_gap.max()
    assert port_err.mean() <= 2 * jax_gap.mean()
    assert port_gap.max() >= 0.25 * jax_gap.max()
    # and the fp32 band is where it was (tests/test_torch_slice.py)
    np.testing.assert_allclose(o["port32"], o["jm32"], rtol=1e-3,
                               atol=2e-2 if output == "flow" else 1e-2)


# ----------------------------------------------- configuration, entries


def test_bf16_model_refuses_kernels_without_bf16(monkeypatch):
    """Every configuration builds in bf16 (the name is from when some were
    refused; none is now): EMIPShort at windows above
    ``fused_block_max_t`` (G and H), with read-corr matching (I) and with
    either MixFFN switch (J); EMIPLong with the same switches; SegNetwork
    with either J switch. Each holds the compute dtype it was given; only a
    dtype other than fp32 or bf16 raises."""
    import dataclasses

    from emip_tpu_torch.dtypes import compute_dtype
    from emip_tpu_torch.models.emip_long import EMIPLong
    from emip_tpu_torch.models.emip_short import EMIPShort, SegNetwork
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS

    base = th.torch_tiny_short().config
    switches = [dict(gmflow=dataclasses.replace(base.gmflow,
                                                fused_block_max_t=8)),
                dict(gmflow=dataclasses.replace(base.gmflow,
                                                global_match_qk_fused=False)),
                dict(fused_ffn="always"), dict(ffn_dwconv="bwd_fused")]
    for switch in switches:
        cfg = dataclasses.replace(base, **switch)
        for dtype in (torch.float32, BF16):
            model = EMIPShort(cfg, dtype=dtype)
            assert compute_dtype(model.GMFlow) == dtype
            assert compute_dtype(model.backbone) == dtype
            long = EMIPLong(cfg, memory_size=2, dtype=dtype)
            assert compute_dtype(long.LTM) == dtype
    b0 = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b0"], depths=th.DEPTHS)
    for switch in (dict(fused_ffn="always"), dict(ffn_dwconv="bwd_fused")):
        seg = SegNetwork(b0, channel=th.CHANNEL, dtype=BF16, **switch)
        assert compute_dtype(seg.decoder) == BF16
        mlp = seg.backbone.feat_net.pvtv2_en.block1[0].mlp
        assert (mlp.use_fused, mlp.dwconv_impl) == (
            switch.get("fused_ffn", "never"),
            switch.get("ffn_dwconv", "conv"))
    with pytest.raises(ValueError):
        EMIPShort(base, dtype=torch.float16)


@pytest.mark.parametrize("value,want", [(None, "bfloat16"),
                                        ("bfloat16", "bfloat16"),
                                        ("float32", "float32"),
                                        ("float16", ValueError),
                                        ("bf16", ValueError)])
def test_compute_dtype_is_read_from_the_yaml(tmp_path, value, want):
    """``compute_dtype``: bfloat16 when the key is missing (the JAX
    package's default), bfloat16 or float32 as written, anything else
    raises."""
    import yaml

    from emip_tpu_torch.config import load_config

    path = tmp_path / "c.yaml"
    th.tiny_yaml(path, "/d", "/s", compute_dtype=value)
    raw = {k: v for k, v in yaml.safe_load(open(path)).items()
           if v is not None}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    if want is ValueError:
        with pytest.raises(ValueError, match="compute_dtype"):
            load_config(str(path))
        return
    assert load_config(str(path)).compute_dtype == want


def test_only_fp32_entry_points_warn_of_bfloat16(caplog):
    """The repository's YAML asks for bfloat16, and every entry point
    honours it (train, train_static, test, test_of, and since the bf16
    long model train_long and test_long): loading it warns of nothing."""
    import logging
    import os

    from emip_tpu_torch.config import load_config

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "emip.yaml")
    with caplog.at_level(logging.WARNING, logger="emip_tpu_torch"):
        assert load_config(path).compute_dtype == "bfloat16"
    assert [r.getMessage() for r in caplog.records] == []


@pytest.mark.parametrize("entry", ["test", "test_of"])
def test_inference_entry_points_build_bf16(tmp_path, monkeypatch, entry):
    """``test`` and ``test_of`` build their model in the YAML's
    compute_dtype (bfloat16 here, as when the key is missing) and write
    their images on the CPU's plain versions; the static trainer's model
    is bf16 for the same YAML too, the short trainer's is tested in
    tests/test_torch_bf16_train.py."""
    import importlib

    import emip_tpu_torch.test as test_mod
    from emip_tpu_torch.data import make_synthetic_video_root

    root = make_synthetic_video_root(str(tmp_path / "MoCA_test"),
                                     num_videos=1, frames_per_video=3,
                                     size=(72, 80), seed=1)
    cfg = th.tiny_yaml(tmp_path / "c.yaml", root, str(tmp_path / "run"),
                       compute_dtype="bfloat16")
    built = []
    real = test_mod.load_short_model

    def spy(cfg, ckpt, device):
        model = real(cfg, ckpt, device)
        built.append(model.compute_dtype)
        return model

    monkeypatch.setattr(test_mod, "load_short_model", spy)
    out = tmp_path / "out"
    mod = importlib.import_module(f"emip_tpu_torch.{entry}")
    if entry == "test":
        mod.main(["--config", cfg, "--data", f"MoCA_test={root}",
                  "--save_path", str(out), "--batch_size", "2",
                  "--device", "cpu"])
        images = list(out.rglob("*.png"))
    else:
        mod.main(["--config", cfg, "--data_root", root, "--save_path",
                  str(out), "--device", "cpu"])
        images = list(out.rglob("*.jpg"))
    assert built == [BF16]
    assert len(images) == 2

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.train.static import build_seg_model

    assert load_config(cfg).compute_dtype == "bfloat16"
    assert build_seg_model(load_config(cfg), "cpu").compute_dtype == BF16


# --------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_bf16_kernels_match_plain_versions():
    """A, B, C and D in bf16 and the bf16 GEMM on the card against their
    plain bf16 versions on the same inputs (1e-2 of max|ref|), the same
    bits on a second call, bf16 launch counts (the backwards are in
    tests/test_torch_bf16_train.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels.gemm import gemm, gemm_reference
    from emip_tpu_torch.ops.window import shifted_window_mask

    g = torch.Generator().manual_seed(7)

    def r(*s, scale=1.0, dtype=BF16):
        return (torch.randn(*s, generator=g) * scale).to(dtype).cuda()

    def params(c, f):
        w = lambda *s: r(*s, scale=s[1] ** -0.5, dtype=torch.float32)  # noqa
        sp = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
                  s1=r(c, scale=0.1, dtype=torch.float32) + 1,
                  b1=r(c, scale=0.05, dtype=torch.float32))
        cp = dict(sp, w0=w(f, 2 * c), w2=w(c, f))
        cp.update(s2=sp["s1"], b2=sp["b1"])
        return sp, cp

    cases = []
    for n, m, c, h in ((7744, 121, 64, 1), (484, 121, 320, 5),
                       (121, 121, 512, 8), (300, 49, 64, 2)):
        cases.append(("sr_attention_bf16", K.fused_sr_attention,
                      K.fused_sr_attention_reference,
                      (r(2, n, c), r(2, m, c), r(c, c, scale=c ** -0.5),
                       r(c, scale=0.1, dtype=torch.float32),
                       r(2 * c, c, scale=c ** -0.5),
                       r(2 * c, scale=0.1, dtype=torch.float32),
                       r(c, c, scale=c ** -0.5),
                       r(c, scale=0.1, dtype=torch.float32), h)))
    for c, side in ((128, None), (128, 44), (64, 44)):
        sp, cp = params(c, 8 * c)
        mask = shifted_window_mask(side, side, 2, device="cuda") if side \
            else None
        cases.append(("window_attention_block_bf16",
                      K.fused_window_attention_block,
                      K.fused_window_attention_block_reference,
                      (r(4, 4, 484, c), r(4, 4, 484, c), sp, cp, mask)))
    for c in (128, 64):
        cases.append(("flow_attention_bf16", K.fused_flow_attention,
                      K.fused_flow_attention_reference,
                      (r(4, 1936, c), r(4, 1936, c),
                       r(4, 1936, 2, scale=10, dtype=torch.float32))))
    cases.append(("convex_upsample_bf16", K.convex_upsample,
                  K.convex_upsample_reference,
                  (r(2, 44, 44, 2, scale=3, dtype=torch.float32),
                   r(2, 44, 44, 576), 8)))
    cases.append(("gemm_bf16", gemm, gemm_reference,
                  (r(3872, 320), r(1024, 320).t(),
                   r(1024, dtype=torch.float32))))
    with torch.no_grad():
        for name, fn, ref, args in cases:
            before = dict(K.LAUNCHES)
            got = fn(*args)
            assert torch.equal(fn(*args), got), name
            torch.cuda.synchronize()
            assert K.LAUNCHES[name] == before[name] + 2, name
            fp32 = name.replace("_bf16", "")
            assert K.LAUNCHES[fp32] == before[fp32], name
            want = ref(*args)
            assert got.dtype == want.dtype, name
            err = (got.float() - want.float()).abs().max()
            assert err <= 1e-2 * want.float().abs().max(), (name, err)
