"""The port's short train step against the JAX package, on the CPU.

Kernel VJPs: each kernel's ``torch.autograd.Function`` on CPU tensors
(plain forward, autograd backward) against ``jax.vjp`` of the public
Pallas function, run in interpret mode as tests/test_pallas_kernels.py
runs it, on one numpy cotangent. Then the loss-side ops, the two losses,
the tiny two-stream model in train mode (b0 widths, PVT depths
(1, 1, 1, 1), 64^2 frames, 2 flow-transformer blocks; identical weights
through ``state_dict_from_flax``; drop path 0 on both sides, because the
two frameworks' generators differ), one full clamp + AdamW step, and the
host code (LR schedule, the training loop and its entry point).

Grad tolerances are max|got - want| / max|want| ("relmax"), with the
scale floor of tests/test_grad_parity.py where a leaf may be zero in
theory; each is stated beside its test with the measured value.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch import kernels as K
from emip_tpu_torch.convert import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel VJPs: the same fp32 formulas with sums in another order (and the
# JAX window kernel's rational erf, |err| <= 1.5e-7); measured <= 2e-6
VJP_REL = 1e-4


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, copy=True)).requires_grad_(grad)


def _relmax(got, want, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-30)


# ------------------------------------------------------- kernel VJPs


@pytest.mark.parametrize("n,m,c,heads", [(64, 16, 64, 2), (36, 9, 40, 5)])
def test_sr_attention_vjp_matches_pallas(n, m, c, heads):
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    rng = np.random.default_rng(300 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    jargs = (f(2, n, c), f(2, m, c), f(c, c) / c**0.5, f(c) * 0.1,
             f(c, 2 * c) / c**0.5, f(2 * c) * 0.1, f(c, c) / c**0.5,
             f(c) * 0.1)
    cot = f(2, n, c)
    _, vjp = jax.vjp(lambda *a: fused_sr_attention(*a, heads), *jargs)
    want = vjp(jnp.asarray(cot))
    targs = [_t(a.T if a.ndim == 2 else a, True) for a in jargs]
    before = dict(K.LAUNCHES)
    out = K.fused_sr_attention(*targs, heads)
    assert out.grad_fn is not None
    out.backward(_t(cot))
    assert K.LAUNCHES == before  # the CPU path launches nothing
    for name, t, w in zip(("x", "kv_in", "wq", "bq", "wkv", "bkv", "wp",
                           "bp"), targs, want):
        got = t.grad.numpy()
        got = got.T if got.ndim == 2 else got
        assert _relmax(got, w) <= VJP_REL, name


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


@pytest.mark.parametrize("shifted", [False, True])
def test_window_block_vjp_matches_pallas(shifted):
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(17 + shifted)
    b, k2, tok, c, f = 2, 4, 16, 32, 64
    x = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    t = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    cot = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    sp, cp = _window_params(rng, c, f)
    mask = np.asarray(shifted_window_mask(8, 8, 2)) if shifted else None
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda x, t, sp, cp: fused_window_attention_block(x, t, sp, cp,
                                                          jmask),
        x, t, sp, cp)
    gx, gt, gsp, gcp = vjp(jnp.asarray(cot))
    tx, tt = _t(x, True), _t(t, True)
    tsp = {k: _t(v.T if v.ndim == 2 else v, True) for k, v in sp.items()}
    tcp = {k: _t(v.T if v.ndim == 2 else v, True) for k, v in cp.items()}
    out = K.fused_window_attention_block(
        tx, tt, tsp, tcp, None if mask is None else _t(mask))
    assert out.grad_fn is not None
    out.backward(_t(cot))
    assert _relmax(tx.grad, gx) <= VJP_REL
    assert _relmax(tt.grad, gt) <= VJP_REL
    for tree, want in ((tsp, gsp), (tcp, gcp)):
        for k, v in tree.items():
            got = v.grad.numpy()
            got = got.T if got.ndim == 2 else got
            assert _relmax(got, want[k]) <= VJP_REL, k


@pytest.mark.parametrize("b,l,c", [(2, 64, 32), (3, 100, 64)])
def test_flow_attention_vjp_matches_pallas(b, l, c):
    from emip_tpu.ops.pallas import fused_flow_attention

    rng = np.random.default_rng(40 + l)
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    cot = rng.standard_normal((b, l, 2)).astype(np.float32)
    _, vjp = jax.vjp(fused_flow_attention, q, k, v)
    want = vjp(jnp.asarray(cot))
    targs = [_t(a, True) for a in (q, k, v)]
    out = K.fused_flow_attention(*targs)
    out.backward(_t(cot))
    for name, a, w in zip("qkv", targs, want):
        assert _relmax(a.grad, w) <= VJP_REL, name


@pytest.mark.parametrize("k", [4, 8])
def test_convex_upsample_vjp_matches_pallas(k):
    from emip_tpu.ops.pallas.convex_upsample import convex_upsample_pallas

    rng = np.random.default_rng(50 + k)
    flow = (rng.standard_normal((2, 6, 5, 2)) * 3).astype(np.float32)
    mask = rng.standard_normal((2, 6, 5, 9 * k * k)).astype(np.float32)
    cot = rng.standard_normal((2, 6 * k, 5 * k, 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: convex_upsample_pallas(a, b, k), flow, mask)
    gflow, gmask = vjp(jnp.asarray(cot))
    tflow, tmask = _t(flow, True), _t(mask, True)
    K.convex_upsample(tflow, tmask, k).backward(_t(cot))
    assert _relmax(tflow.grad, gflow) <= VJP_REL
    assert _relmax(tmask.grad, gmask) <= VJP_REL


def test_kernel_functions_compute_only_requested_grads():
    """needs_input_grad: a frozen weight gets no grad, and no graph is
    kept when nothing asks for one."""
    rng = np.random.default_rng(3)
    c = 32
    x = _t(rng.standard_normal((1, 2, 16, c)).astype(np.float32), True)
    t = _t(rng.standard_normal((1, 2, 16, c)).astype(np.float32))
    sp, cp = _window_params(rng, c, 64)
    tsp = {k: _t(v.T if v.ndim == 2 else v) for k, v in sp.items()}
    tcp = {k: _t(v.T if v.ndim == 2 else v) for k, v in cp.items()}
    out = K.fused_window_attention_block(x, t, tsp, tcp)
    out.sum().backward()
    assert x.grad is not None and t.grad is None
    assert all(v.grad is None for v in (*tsp.values(), *tcp.values()))
    with torch.no_grad():
        assert K.fused_window_attention_block(x, t, tsp, tcp).grad_fn is None


# --------------------------------------------------------------- ops


@functools.lru_cache(maxsize=1)
def _op_cases():
    import emip_tpu.ops.geometry as jg
    import emip_tpu.ops.image as ji
    import emip_tpu.ops.upsample as ju
    import emip_tpu.ops.warp as jw
    from emip_tpu_torch.ops import geometry, image, upsample, warp

    rng = np.random.default_rng(8)
    img = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    # sample points inside, on and past every edge, and exactly integer
    coords = np.stack([rng.uniform(-2.5, 12.5, (2, 7, 6)),
                       rng.uniform(-2.5, 10.5, (2, 7, 6))], -1)
    coords[0, 0] = [[0, 0], [10, 8], [-1, 3], [11, 8], [4, -1], [3, 5]]
    coords = coords.astype(np.float32)
    flow = (rng.standard_normal((2, 9, 11, 2)) * 2).astype(np.float32)
    flow_i = np.round(flow)  # integer targets: corners of weight 0 and 1
    small = rng.standard_normal((2, 5, 4, 2)).astype(np.float32)
    img16 = rng.standard_normal((2, 16, 12, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    return {
        "bilinear_sample_border": (
            geometry.bilinear_sample(t(img), t(coords), "border"),
            jg.bilinear_sample(img, coords, padding_mode="border")),
        "bilinear_sample_zeros": (
            geometry.bilinear_sample(t(img), t(coords), "zeros"),
            jg.bilinear_sample(img, coords, padding_mode="zeros")),
        "flow_warp": (geometry.flow_warp(t(img), t(flow)),
                      jg.flow_warp(img, flow)),
        "flow_warp_loss": (warp.flow_warp_loss(t(img), t(flow)),
                           jw.flow_warp_loss(img, flow)),
        "upsample_flow_bilinear": (
            upsample.upsample_flow_bilinear(t(small), 8),
            ju.upsample_flow_bilinear(small, 8)),
        "resize_area": (image.resize_area(th.nchw(img16), (8, 5)),
                        ji.resize_area(img16, (8, 5))),
        "resize_nearest": (image.resize_nearest(th.nchw(img16), (32, 7)),
                           ji.resize_nearest(img16, (32, 7))),
        "occlusion_mask_backward": (warp.occlusion_mask_backward(t(flow)),
                                    jw.occlusion_mask_backward(flow)),
        "occlusion_mask_integer_flow": (
            warp.occlusion_mask_backward(t(flow_i)),
            jw.occlusion_mask_backward(flow_i)),
    }


@pytest.mark.parametrize("name", [
    "bilinear_sample_border", "bilinear_sample_zeros", "flow_warp",
    "flow_warp_loss", "upsample_flow_bilinear", "resize_area",
    "resize_nearest", "occlusion_mask_backward",
    "occlusion_mask_integer_flow"])
def test_train_ops_match_jax(name):
    got, want = _op_cases()[name]
    if name.startswith("resize"):
        got = got.permute(0, 2, 3, 1)
    # grid_sample normalises the pixel coordinates to [-1, 1] and back
    # (|err| ~1e-6 of a coordinate); the rest is the same formula
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


# ------------------------------------------------------------ losses


def _loss_inputs(levels=((16, 16), (8, 8)), seed=9):
    rng = np.random.default_rng(seed)
    im1 = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    im2 = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    flows = [tuple((rng.standard_normal((2, h, w, 2)) * 2).astype(np.float32)
                   for _ in range(2)) for h, w in levels]
    return im1, im2, flows


def test_hybrid_e_loss_and_ssim_match_jax():
    from emip_tpu.losses.flow import ssim_distance as j_ssim
    from emip_tpu.losses.seg import hybrid_e_loss as j_hybrid
    from emip_tpu_torch.losses import hybrid_e_loss, ssim_distance

    rng = np.random.default_rng(10)
    pred = (rng.standard_normal((3, 20, 24, 1)) * 3).astype(np.float32)
    gt = (rng.uniform(size=(3, 20, 24, 1)) > 0.6).astype(np.float32)
    np.testing.assert_allclose(
        float(hybrid_e_loss(th.nchw(pred), th.nchw(gt))),
        float(j_hybrid(pred, gt)), rtol=1e-6)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    y = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ssim_distance(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(j_ssim(x, y)), rtol=1e-5, atol=1e-6)


def test_unsup_flow_loss_value_and_flow_grads_match_jax():
    """Loss value and its grads w.r.t. identical flows (two pyramid levels,
    so the area / nearest resizes run); never end to end through the warp
    (the flow grads are piecewise constant in the flow)."""
    from emip_tpu.losses.flow import unsup_flow_loss as j_loss
    from emip_tpu_torch.losses import unsup_flow_loss

    im1, im2, flows = _loss_inputs()

    @jax.jit
    def jfn(flows):
        total, _, mean_abs = j_loss(flows, im1, im2)
        return total, mean_abs

    (lj, mj), gj = jax.value_and_grad(jfn, has_aux=True)(
        [tuple(map(jnp.asarray, p)) for p in flows])
    tflows = [tuple(_t(a, True) for a in p) for p in flows]
    total, warp_loss, mean_abs = unsup_flow_loss(
        tflows, torch.from_numpy(im1), torch.from_numpy(im2))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mean_abs.detach()), float(mj),
                               rtol=1e-6)
    for (tf, tb), (gf, gb) in zip(tflows, gj):
        # the same piecewise-bilinear grads, away from integer crossings;
        # measured relmax ~1e-6
        assert _relmax(tf.grad, gf) <= 1e-4
        assert _relmax(tb.grad, gb) <= 1e-4


# ---------------------------------------------- model in train mode


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32),
            rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32),
            (rng.uniform(size=(2, th.SIZE, th.SIZE, 1)) > 0.5
             ).astype(np.float32))


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX model, variables, port model) with identical weights, drop path
    0 on both sides; the port has GMFlow frozen."""
    from emip_tpu_torch.train.state import freeze_gmflow

    jm, _ = th.jax_tiny_short(drop_path_rate=0.0)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm, img, img, seed=31)
    port = th.torch_tiny_short(drop_path_rate=0.0)
    port.load_state_dict(
        state_dict_from_flax(variables, th.DEPTHS, th.NUM_LAYERS),
        strict=True)
    freeze_gmflow(port)
    return jm, variables, port


@pytest.fixture(scope="module")
def jax_train(tiny_pair):
    """One JAX short train step (lr STEP_LR) and the
    seg-loss grads w.r.t. the trainable tree, from one forward."""
    from emip_tpu.losses.flow import unsup_flow_loss
    from emip_tpu.losses.seg import hybrid_e_loss
    from emip_tpu.train.short import make_short_train_step
    from emip_tpu.train.state import (
        GMFLOW_FREEZE,
        TrainState,
        build_optimizer,
        merge_params,
    )

    jm, variables, _ = tiny_pair
    a, b, gt = _batch()
    tx = build_optimizer(learning_rate=STEP_LR, weight_decay=1e-7,
                         clip_value=0.5)
    state = TrainState.create(variables, tx, GMFLOW_FREEZE)
    rngs = {"droppath": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(0)}

    @jax.jit
    def losses_and_seg_grads(trainable):
        def fn(tr):
            (mask, fw, bw), mutated = jm.apply(
                {"params": merge_params(tr, state.frozen),
                 "batch_stats": state.batch_stats},
                a, b, train=True, rngs=rngs, mutable=["batch_stats"])
            lp = hybrid_e_loss(mask, gt)
            lf, _, _ = unsup_flow_loss(list(zip(fw, bw)), a, b)
            return lp, lf
        (lp, lf), vjp = jax.vjp(fn, trainable)
        (g,) = vjp((jnp.ones_like(lp), jnp.zeros_like(lf)))
        return lp, lf, g

    lp, lf, seg = losses_and_seg_grads(state.params)
    step = make_short_train_step(jm, tx, donate=False)
    new_state, metrics = step(state, dict(image1=a, image2=b, gt=gt),
                              jax.random.PRNGKey(1))
    # the same compiled step twice more, on batches of their own (the
    # three-step A/B); and all three again with the first batch's frames
    # nudged by AB_NUDGE, which measures how far the trajectory moves
    # under rounding-sized changes
    batches = [(a, b, gt)] + [_batch(seed) for seed in AB_SEEDS]
    ab_state, ab_losses = new_state, [float(metrics["loss"])]
    for i, (a2, b2, gt2) in enumerate(batches[1:]):
        ab_state, m = step(ab_state, dict(image1=a2, image2=b2, gt=gt2),
                           jax.random.PRNGKey(2 + i))
        ab_losses.append(float(m["loss"]))
    nudged, nudged_losses = state, []
    scale = np.float32(1 + AB_NUDGE)
    for i, (a2, b2, gt2) in enumerate(batches):
        if i == 0:
            a2, b2 = a2 * scale, b2 * scale
        nudged, m = step(nudged, dict(image1=a2, image2=b2, gt=gt2),
                         jax.random.PRNGKey(1 + i))
        nudged_losses.append(float(m["loss"]))
    return dict(state=state, new_state=new_state, metrics=metrics,
                losses=(float(lp), float(lf)), seg=seg, batch=(a, b, gt),
                ab_batches=batches, ab_losses=ab_losses, ab_state=ab_state,
                ab_nudged_losses=nudged_losses, ab_nudged_state=nudged)


def _torch_batch(batch):
    a, b, gt = batch
    return dict(image1=th.nchw(a), image2=th.nchw(b), gt=th.nchw(gt))


def _grads_as_torch(tiny_pair, grads, state):
    """JAX grads of the trainable tree in the port's key space (GMFlow's,
    which the step never forms, as zeros)."""
    from emip_tpu.train.state import merge_params

    _, variables, _ = tiny_pair
    frozen = jax.tree_util.tree_map(np.zeros_like, state.frozen)
    full = merge_params(jax.tree_util.tree_map(np.asarray, grads), frozen)
    return state_dict_from_flax(
        {"params": full, "batch_stats": variables["batch_stats"]},
        th.DEPTHS, th.NUM_LAYERS)


# seg-loss grads through the whole tiny model: fp32 through ~60 layers
# in both frameworks (Pallas interpret vs plain torch); measured worst leaf
# relmax 2e-4 with the 1e-6 scale floor of tests/test_grad_parity.py
SEG_GRAD_REL = 5e-3


def test_train_mode_losses_and_seg_grads_match_jax(tiny_pair, jax_train):
    from emip_tpu_torch.train.short import short_losses

    _, _, port = tiny_pair
    model = _clone(port)
    model.train()
    out = short_losses(model, _torch_batch(jax_train["batch"]))
    lp, lf = jax_train["losses"]
    np.testing.assert_allclose(float(out["loss_pred"].detach()), lp,
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["loss_flow"].detach()), lf,
                               rtol=1e-4)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(
        out["loss_pred"], [p for p in model.parameters() if p.requires_grad],
        allow_unused=True)
    want = _grads_as_torch(tiny_pair, jax_train["seg"], jax_train["state"])
    assert not any(n.startswith("GMFlow.") for n in names)
    scale = max(float(want[n].abs().max()) for n in names)
    worst = []
    for n, g in zip(names, grads):
        g = torch.zeros_like(want[n]) if g is None else g
        worst.append((_relmax(g, want[n], 1e-6 * scale), n))
    assert max(worst)[0] <= SEG_GRAD_REL, sorted(worst)[-5:]


def _clone(model):
    import copy

    return copy.deepcopy(model)


# the engine VJP with identical cotangents (kernels B, C, D in context);
# measured relmax 3e-6
ENGINE_VJP_REL = 1e-4


def test_engine_vjp_matches_jax(tiny_pair):
    jm, variables, port = tiny_pair
    rng = np.random.default_rng(12)
    h = th.SIZE // 8
    a = rng.standard_normal((2, h, h, th.FDIM)).astype(np.float32)
    b = rng.standard_normal((2, h, h, th.FDIM)).astype(np.float32)

    def engine(self, a, b):
        return self.gmflow([a], [b], training=True)

    def flows(a, b):
        fw, bw, _ = jm.apply(variables, a, b, method=engine)
        return list(fw), list(bw)

    (jfw, jbw), vjp = jax.vjp(flows, a, b)
    cots = [[rng.standard_normal(f.shape).astype(np.float32) for f in fs]
            for fs in (jfw, jbw)]
    ga, gb = vjp(tuple([jnp.asarray(c) for c in cs] for cs in cots))

    ta, tb = th.nchw(a).requires_grad_(), th.nchw(b).requires_grad_()
    fw, bw, _ = port.GMFlow([ta], [tb], training=True)
    assert len(fw) == len(jfw) == 2  # pre-propagation + final
    for got, want in zip(fw + bw, list(jfw) + list(jbw)):
        assert _relmax(th.nhwc(got), want) <= 1e-4
    torch.autograd.backward(
        fw + bw, [th.nchw(c) for c in cots[0] + cots[1]])
    assert _relmax(th.nhwc(ta.grad), ga) <= ENGINE_VJP_REL
    assert _relmax(th.nhwc(tb.grad), gb) <= ENGINE_VJP_REL


# one clamp + AdamW step at lr 1e-3. Adam's first update is about
# -lr * g / (|g| + eps), a sign wherever |g| >> eps, so an element whose
# grad is near zero or comes through the (piecewise-constant) warp grads
# can flip: every element is held to Adam's bound of 2 lr, and the share
# of elements that agree within 1e-3 lr to 99.5% (measured 99.92% of the
# 3.1M trainable elements)
STEP_LR = 1e-3
STEP_AGREE_SHARE = 0.995


def test_one_train_step_matches_jax(tiny_pair, jax_train):
    from emip_tpu.train.state import merge_params
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    jm, variables, port = tiny_pair
    model = _clone(port)
    opt = build_optimizer(model, STEP_LR, 1e-7, 0.5)
    gm_before = {k: v.clone() for k, v in model.GMFlow.state_dict().items()}
    bn_inputs = {}

    def hook(name):
        def record(mod, inp, out):
            bn_inputs[name] = inp[0].shape
        return record

    hooks = [m.register_forward_hook(hook(n))
             for n, m in model.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = short_train_step(model, opt, _torch_batch(jax_train["batch"]))
    for hk in hooks:
        hk.remove()
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jax_train["metrics"]["loss"]), rtol=1e-4)

    new = jax_train["new_state"]
    want = state_dict_from_flax(
        {"params": jax.tree_util.tree_map(
            np.asarray, merge_params(new.params, new.frozen)),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)},
        th.DEPTHS, th.NUM_LAYERS)
    got = model.state_dict()
    # GMFlow: bit-identical and not trainable
    for k, v in model.GMFlow.state_dict().items():
        assert torch.equal(v, gm_before[k]), k
    assert not any(p.requires_grad for p in model.GMFlow.parameters())
    # trainable leaves
    total = agree = 0
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        d = (got[n] - want[n]).abs()
        assert float(d.max()) <= 2 * STEP_LR * (1 + 1e-3), n
        total += d.numel()
        agree += int((d <= 1e-3 * STEP_LR).sum())
    assert agree >= STEP_AGREE_SHARE * total, agree / total
    # BatchNorm statistics: the running mean and variance as flax's (the
    # biased batch variance)
    assert bn_inputs
    for name in bn_inputs:
        rm, rv = f"{name}.running_mean", f"{name}.running_var"
        np.testing.assert_allclose(got[rm].numpy(), want[rm].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=rm)
        np.testing.assert_allclose(got[rv].numpy(), want[rv].numpy(),
                                   rtol=1e-4, err_msg=rv)
        assert not torch.equal(got[rv], before[rv]), rv


# the fp32 A/B of PARITY.md: three clamp + AdamW steps at STEP_LR from
# identical weights on three batches (the first is the one-step test's).
# After the first step the weights part where Adam's update flips its sign
# (see STEP_AGREE_SHARE; the flow loss's warp grads are piecewise
# constant), and the later steps carry that on: JAX's own steps from
# frames nudged by AB_NUDGE part from its unnudged ones by up to 1.2e-3 of
# the loss and 3.8e-2 of a BatchNorm statistic's max|ref| (the port, from
# the same frames: 3.6e-4 and 2.8e-2). The port's losses and statistics
# after the three steps are held within twice that band of JAX's
AB_SEEDS = (5, 6)
AB_NUDGE = 1e-6


def _state_dict_of(state):
    from emip_tpu.train.state import merge_params

    return state_dict_from_flax(
        {"params": jax.tree_util.tree_map(
            np.asarray, merge_params(state.params, state.frozen)),
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               state.batch_stats)},
        th.DEPTHS, th.NUM_LAYERS)


def test_three_train_steps_match_jax(tiny_pair, jax_train):
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    _, _, port = tiny_pair
    model = _clone(port)
    opt = build_optimizer(model, STEP_LR, 1e-7, 0.5)
    losses = [float(short_train_step(model, opt, _torch_batch(b))["loss"])
              for b in jax_train["ab_batches"]]
    want = np.asarray(jax_train["ab_losses"])
    band = np.abs(np.asarray(jax_train["ab_nudged_losses"]) - want).max()
    assert len(losses) == len(want) == 3 and np.isfinite(losses).all()
    assert 0 < band, "the nudge did not move JAX's losses"
    delta = np.abs(np.asarray(losses) - want).max()
    assert delta <= 2 * band, (losses, want, band)
    ref = _state_dict_of(jax_train["ab_state"])
    nudged = _state_dict_of(jax_train["ab_nudged_state"])
    got = model.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats

    def worst(sd):
        return max(float((sd[k] - ref[k]).abs().max() / ref[k].abs().max())
                   for k in stats)

    assert worst(got) <= 2 * worst(nudged), (worst(got), worst(nudged))


def test_clamp_adamw_matches_optax():
    """Element-wise clamp then AdamW: decoupled decay and eps placement
    as optax's, two steps on one tensor with grads beyond the clamp."""
    import optax

    from emip_tpu_torch.train.state import ClampAdamW

    rng = np.random.default_rng(13)
    p0 = rng.standard_normal(64).astype(np.float32)
    g = [(rng.standard_normal(64) * 0.8).astype(np.float32) for _ in range(2)]
    tx = optax.chain(optax.clip(0.5), optax.adamw(1e-2, weight_decay=0.1))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ClampAdamW([tp], lr=1e-2, weight_decay=0.1, clip=0.5)
    for gi in g:
        upd, st = tx.update(jnp.asarray(gi), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(gi.copy())
        opt.step()
    # torch scales p by (1 - lr wd) before the Adam step, optax adds
    # -lr (adam + wd p): the same value rounded differently in fp32, a few
    # ulps of |p| <= 3.1
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-6)


# --------------------------------------------------------- host code


def test_cosine_epoch_lr_matches_jax():
    from emip_tpu.train.state import cosine_epoch_lr as j_lr
    from emip_tpu_torch.train.state import cosine_epoch_lr

    a, b = cosine_epoch_lr(1e-5, 1e-6, 30), j_lr(1e-5, 1e-6, 30, True)
    for e in range(1, 70):
        assert a(e) == pytest.approx(b(e), rel=1e-12)


@pytest.mark.parametrize("gt_kind", ["blob", "empty", "full", "noise"])
def test_validation_metrics_match_jax(gt_kind):
    from emip_tpu.metrics import MAE, Smeasure, WeightedFmeasure
    from emip_tpu_torch.metrics import frame_scores

    rng = np.random.default_rng(14)
    h, w = 37, 52
    yy, xx = np.mgrid[0:h, 0:w]
    gt = {"blob": ((yy - 15) ** 2 + (xx - 30) ** 2 < 90) * 255.0,
          "empty": np.zeros((h, w)),
          "full": np.full((h, w), 255.0),
          "noise": (rng.uniform(size=(h, w)) > 0.7) * 255.0}[gt_kind]
    pred = np.clip(gt / 255.0 * 0.6 + rng.uniform(0, 0.5, (h, w)), 0, 1)
    want = {}
    for key, metric, out in (("wFm", WeightedFmeasure(), "wfm"),
                             ("Sm", Smeasure(), "sm"), ("MAE", MAE(), "mae")):
        metric.step(pred * 255.0, gt)
        want[key] = float(metric.get_results()[out])
    got = frame_scores(pred * 255.0, gt)
    # the same float64 formulas
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-15), key


def _write_tiny_yaml(path, root, save, epoch):
    import yaml

    cfg = dict(
        train_dataset=dict(image_path=root, gt_path=root, inp_size=th.SIZE,
                           batch_size=2),
        val_dataset=dict(image_path=root, gt_path=root, inp_size=th.SIZE,
                         batch_size=1),
        model=dict(args=dict(
            inp_size=th.SIZE, channel=th.CHANNEL, backbone_name="pvt_v2_b0",
            include_dead_modules=False,
            GMFlow=dict(feature_channels=th.FDIM,
                        num_transformer_layers=th.NUM_LAYERS))),
        optimizer=dict(lr=1e-4, weight_decay=1e-7),
        seed=5, epoch=epoch, epoch_val=1, epoch_save=1, save_path=save)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def test_train_entry_point_trains_checkpoints_and_resumes(tmp_path):
    """``python -m emip_tpu_torch.train --config <yaml>
    --max_steps_per_epoch 2`` (in process) on a synthetic root: 2 steps,
    validation, a checkpoint with optimizer state; ``--resume`` continues
    from it."""
    from emip_tpu_torch.data import make_synthetic_video_root
    from emip_tpu_torch.train.__main__ import main

    root = make_synthetic_video_root(str(tmp_path / "data"), num_videos=2,
                                     frames_per_video=4, size=(56, 64))
    cfg = tmp_path / "tiny.yaml"
    save = str(tmp_path / "run")
    _write_tiny_yaml(cfg, root, save, epoch=2)
    summary = main(["--config", str(cfg), "--max_steps_per_epoch", "2",
                    "--device", "cpu"])
    assert summary["steps"] == 2 and summary["best_epoch"] == 1
    assert np.isfinite(summary["best_mae"])
    ckpt = torch.load(os.path.join(save, "ckpt", "ckpt.pt"))
    assert ckpt["epoch"] == 1
    assert {float(s["step"]) for s in ckpt["optimizer"]["state"].values()
            } == {2.0}
    assert os.path.exists(os.path.join(save, "ckpt_best", "ckpt.pt"))
    assert os.path.exists(os.path.join(save, "config.yaml"))

    _write_tiny_yaml(cfg, root, save, epoch=3)
    summary = main(["--config", str(cfg), "--resume",
                    "--max_steps_per_epoch", "1", "--device", "cpu"])
    assert summary["steps"] == 1 and summary["best_epoch"] == 2
    ckpt = torch.load(os.path.join(save, "ckpt", "ckpt.pt"))
    assert ckpt["epoch"] == 2
    assert {float(s["step"]) for s in ckpt["optimizer"]["state"].values()
            } == {3.0}


def test_train_cli_flags_mirror_root_train_py():
    from emip_tpu_torch.train.__main__ import parse_args

    with open(os.path.join(REPO, "train.py")) as f:
        root_flags = set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))
    port = parse_args([])
    # --multi_host joins a torchrun / SLURM process group (data
    # parallelism, emip_tpu_torch/parallel.py), as the root script's joins
    # jax.distributed; --device is the one flag the port adds: it defaults
    # to the card
    assert {f"--{k}" for k in vars(port)} == root_flags | {"--device"}
    assert port.device == "cuda" and port.multi_host is False
    args = parse_args(["--config", "c.yaml", "--resume", "--save_path", "s",
                       "--max_steps_per_epoch", "2", "--multi_host"])
    assert (args.config, args.resume, args.save_path,
            args.max_steps_per_epoch, args.multi_host) == (
                "c.yaml", True, "s", 2, True)
    proc = subprocess.run([sys.executable, "-m", "emip_tpu_torch.train",
                           "--help"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert all(flag in proc.stdout for flag in root_flags)


def test_train_loader_batches_are_seeded_and_augmented(tmp_path):
    from emip_tpu_torch.data import PairTrainLoader, make_synthetic_video_root

    root = make_synthetic_video_root(str(tmp_path / "d"), num_videos=2,
                                     frames_per_video=4, size=(48, 56))
    a = PairTrainLoader(root, root, batch_size=2, size=32, seed=1)
    b = PairTrainLoader(root, root, batch_size=2, size=32, seed=1)
    ba, bb = list(a), list(b)
    assert len(ba) == len(a) == 3
    assert ba[0]["image1"].shape == (2, 32, 32, 3)
    assert ba[0]["gt"].shape == (2, 32, 32, 1)
    for x, y in zip(ba, bb):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    plain = next(iter(PairTrainLoader(root, root, batch_size=2, size=32,
                                      seed=1, augment=False)))
    assert not np.array_equal(plain["image1"], ba[0]["image1"])
