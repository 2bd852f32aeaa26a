"""The bf16 train step and bf16 static pretraining against the JAX package
in bf16, on the CPU.

The JAX package trains in its published ``compute_dtype``, bfloat16: each
kernel's custom VJP upcasts its bf16 operands, recomputes its forward in
fp32 and rounds each grad to its input's dtype. The port's bf16 kernels
(A, B, C and D) do the same; on CPU tensors their backward is the fp32
plain version's VJP at the upcast inputs (B's with the rounding of x1
passed straight through), each grad rounded once.

Here, on the same numpy inputs and weights:

- each bf16 kernel VJP against ``jax.vjp`` of the JAX Pallas function on
  bf16 inputs (interpret mode, as tests/test_pallas_kernels.py runs it):
  every grad in JAX's dtype and within 8e-3 of max|ref| (two bf16 ulps:
  both sides round at the same points, their sums run in another order).
  Autograd through the bf16 forward's plain version, which differentiates
  its rounded intermediates, misses that limit for B at its test shapes
  (kept as cases), not for A's (it stays within 7.1e-3); for C and D it is
  the same function (their plain bf16 versions upcast at once);
- the tiny two-stream model (tests/torch_helpers.py, drop path off) in
  bf16: one train step's loss and all trainable leaves' grads together
  within twice JAX's own bf16-vs-fp32 gap of JAX's bf16 step
  (``make_short_train_step``), and the port's own gap from its fp32 at
  least a quarter of JAX's (it really trains in bf16); then three clamp +
  AdamW steps, the A/B protocol of PARITY.md: max |delta loss| of port
  bf16 against JAX bf16 at most twice that of JAX bf16 against JAX fp32;
- the static SegNetwork's bf16 step the same way;
- ``train`` and ``train_static`` on a tiny YAML that says bfloat16.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch import kernels as K
from emip_tpu_torch.convert import state_dict_from_flax

BF16 = torch.bfloat16
KERNEL_REL = 8e-3
STEP_LR = 1e-3
STEPS = 3


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


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return {BF16: "bfloat16", torch.float32: "float32"}[x.dtype]
    return str(jnp.asarray(x).dtype)


def _torch_layout(a):
    """A JAX weight [in, out] in torch's [out, in] layout."""
    return a.T if a.ndim == 2 else a


# ------------------------------------------------------- kernel VJPs


def _sr_case(n, m, c):
    rng = np.random.default_rng(200 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = (f(2, n, c), f(2, m, c), f(c, c) / c**0.5, f(c) * 0.1,
            f(c, 2 * c) / c**0.5, f(2 * c) * 0.1, f(c, c) / c**0.5,
            f(c) * 0.1)
    return args, f(2, n, c)


_SR_BF16 = (0, 1, 2, 4, 6)  # x, kv_in and the weights: bf16 in the model


def _sr_grads(n, m, c, heads, fn):
    """(JAX grads, grads of ``fn``) of kernel A on bf16 inputs."""
    from emip_tpu.ops.pallas.sr_attention import fused_sr_attention

    args, cot = _sr_case(n, m, c)
    jargs = [_jb(a) if i in _SR_BF16 else jnp.asarray(a)
             for i, a in enumerate(args)]
    _, vjp = jax.vjp(lambda *a: fused_sr_attention(*a, heads), *jargs)
    want = vjp(_jb(cot))
    leaves = [(_tb if i in _SR_BF16 else _t)(_torch_layout(a))
              .requires_grad_(True) for i, a in enumerate(args)]
    out = fn(*leaves, heads)
    out.backward(_tb(cot))
    return want, [_torch_layout(x.grad) for x in leaves]


@pytest.mark.parametrize("n,m,c,heads", [(64, 16, 64, 2), (36, 9, 64, 1),
                                         (49, 49, 32, 1)])
def test_sr_attention_bf16_vjp_matches_pallas(n, m, c, heads):
    """A: gx, g_kv_in and the three weight grads bf16, the bias grads
    fp32, as the JAX kernel's; measured worst 4e-4 of max|ref|."""
    before = dict(K.LAUNCHES)
    want, got = _sr_grads(n, m, c, heads, K.fused_sr_attention)
    assert K.LAUNCHES == before  # the plain versions launch nothing
    for name, g, w in zip(("x", "kv_in", "wq", "bq", "wkv", "bkv", "wp",
                           "bp"), got, want):
        assert _dtype_name(g) == _dtype_name(w), name
        assert _rel(g, w) <= KERNEL_REL, name


def _window_case(shifted, c=64, f=128):
    rng = np.random.default_rng(17 + shifted)
    b, k2, tok = 2, 4, 16
    x = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    t = rng.standard_normal((b, k2, tok, c)).astype(np.float32)
    cot = rng.standard_normal((b, k2, tok, c)).astype(np.float32)

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
    return x, t, cot, sp, cp


def _window_grads(shifted, fn):
    """(JAX grads, grads of ``fn``) of kernel B on bf16 windows with fp32
    parameters, as names -> grads."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block,
    )
    from emip_tpu.ops.window import shifted_window_mask

    x, t, cot, sp, cp = _window_case(shifted)
    mask = np.asarray(shifted_window_mask(8, 8, 2)) if shifted else None
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda x, t, sp, cp: fused_window_attention_block(
        x, t, sp, cp, jmask), _jb(x), _jb(t), sp, cp)
    gx, gt, gsp, gcp = vjp(_jb(cot))
    want = dict(x=gx, t=gt, **{"self_" + k: v for k, v in gsp.items()},
                **{"cross_" + k: v for k, v in gcp.items()})
    tx, tt = _tb(x).requires_grad_(True), _tb(t).requires_grad_(True)
    tsp = {k: _t(_torch_layout(v)).requires_grad_(True)
           for k, v in sp.items()}
    tcp = {k: _t(_torch_layout(v)).requires_grad_(True)
           for k, v in cp.items()}
    out = fn(tx, tt, tsp, tcp, None if mask is None else _t(mask))
    out.backward(_tb(cot))
    got = dict(x=tx.grad, t=tt.grad,
               **{"self_" + k: _torch_layout(v.grad) for k, v in tsp.items()},
               **{"cross_" + k: _torch_layout(v.grad)
                  for k, v in tcp.items()})
    return want, got


@pytest.mark.parametrize("shifted", [False, True])
def test_window_block_bf16_vjp_matches_pallas(shifted):
    """B: gx, gt bf16 and the 16 parameter grads fp32 (the JAX kernel's 17:
    it takes W0 in two halves); measured worst 6.8e-3 of max|ref| (gt,
    shifted), one bf16 ulp of an element near max|ref|."""
    want, got = _window_grads(shifted, K.fused_window_attention_block)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert _dtype_name(g) == _dtype_name(w), name
        assert _rel(g, w) <= KERNEL_REL, name


@pytest.mark.parametrize("b,l,c", [(2, 64, 64), (3, 100, 128)])
def test_flow_attention_bf16_vjp_matches_pallas(b, l, c):
    """C: dq, dk bf16, dv fp32; measured worst 5e-4 of max|ref|."""
    from emip_tpu.ops.pallas import fused_flow_attention

    rng = np.random.default_rng(300 + l)
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    cot = rng.standard_normal((b, l, 2)).astype(np.float32)
    _, vjp = jax.vjp(fused_flow_attention, _jb(q), _jb(k), jnp.asarray(v))
    want = vjp(jnp.asarray(cot))
    targs = [_tb(q).requires_grad_(True), _tb(k).requires_grad_(True),
             _t(v).requires_grad_(True)]
    out = K.fused_flow_attention(*targs)
    assert out.grad_fn is not None and out.dtype == torch.float32
    out.backward(_t(cot))
    for name, a, w in zip("qkv", targs, want):
        assert _dtype_name(a.grad) == _dtype_name(w), name
        assert _rel(a.grad, w) <= KERNEL_REL, name


@pytest.mark.parametrize("k", [4, 8])
def test_convex_upsample_bf16_vjp_matches_pallas(k):
    """D: gflow fp32, gmask bf16; measured equal to JAX's."""
    from emip_tpu.ops.pallas.convex_upsample import convex_upsample_pallas

    rng = np.random.default_rng(50 + k)
    flow = (rng.standard_normal((2, 6, 5, 2)) * 3).astype(np.float32)
    mask = rng.standard_normal((2, 6, 5, 9 * k * k)).astype(np.float32)
    cot = rng.standard_normal((2, 6 * k, 5 * k, 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: convex_upsample_pallas(a, b, k),
                     jnp.asarray(flow), _jb(mask))
    want = vjp(jnp.asarray(cot))
    targs = [_t(flow).requires_grad_(True), _tb(mask).requires_grad_(True)]
    K.convex_upsample(*targs, k).backward(_t(cot))
    for name, a, w in zip(("flow", "mask"), targs, want):
        assert _dtype_name(a.grad) == _dtype_name(w), name
        assert _rel(a.grad, w) <= KERNEL_REL, name


@pytest.mark.parametrize("shifted", [False, True])
def test_bf16_vjp_is_not_autograd_through_the_bf16_forward(shifted):
    """The limit tells the JAX kernels' gradient (the fp32 VJP at the
    upcast inputs) from autograd through the bf16 forward's plain version
    (its rounded q, k, v, P, o and x1): at B's test shapes the latter
    misses 8e-3 on some grad (measured 9.1e-3 and 1.0e-2 on gt), while the
    port's bf16 kernel meets it. (At A's test shapes autograd through the
    bf16 plain version stays under the limit, worst 7.1e-3 against the
    port's 4e-4; C's and D's bf16 plain versions upcast at once, so their
    autograd is the fp32 VJP.)"""
    from emip_tpu_torch.kernels.window_attention import _block_reference_bf16

    want, naive = _window_grads(shifted, _block_reference_bf16)
    _, port = _window_grads(shifted, K.fused_window_attention_block)
    assert max(_rel(naive[k], w) for k, w in want.items()) > KERNEL_REL
    assert max(_rel(port[k], w) for k, w in want.items()) <= KERNEL_REL


def test_bf16_kernels_keep_nothing_without_a_gradient():
    """Without autograd the bf16 forwards keep no inputs and return no
    graph; with a leaf that needs a gradient the output carries a
    grad_fn."""
    rng = np.random.default_rng(5)
    q = _tb(rng.standard_normal((1, 8, 64)))
    v = _t(rng.standard_normal((1, 8, 2)))
    with torch.no_grad():
        assert K.fused_flow_attention(q, q, v).grad_fn is None
    assert K.fused_flow_attention(q, q, v).grad_fn is None
    leaf = q.clone().requires_grad_(True)
    out = K.fused_flow_attention(leaf, q, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert leaf.grad.dtype == BF16


# ------------------------------------------------ the tiny train step


def _batches(n=STEPS):
    rng = np.random.default_rng(44)
    out = []
    for _ in range(n):
        out.append((
            rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32),
            rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32),
            (rng.uniform(size=(2, th.SIZE, th.SIZE, 1)) > 0.5
             ).astype(np.float32)))
    return out


def _capturing(tx):
    """``tx`` after a transformation that keeps each step's raw grads in
    its state (the first element of the optimizer state)."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


def _leaves(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(x, np.float64))
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.fixture(scope="module")
def short_runs():
    """The tiny EMIPShort of both packages on one set of seeded variables,
    drop path off: JAX bf16 and fp32 ``make_short_train_step`` (clamp +
    AdamW at STEP_LR) for STEPS steps, each step's total loss and the
    first step's grads of the trainable tree; the port's bf16 and fp32
    models the same, their first step's grads (autograd of the total loss
    before the step: the port's optimizer clamps .grad in place)."""
    from emip_tpu.models.emip_short import EMIPShort as JaxEMIPShort
    from emip_tpu.train.short import make_short_train_step
    from emip_tpu.train.state import (
        GMFLOW_FREEZE,
        TrainState,
        build_optimizer,
        merge_params,
    )
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer as port_optimizer

    jm32, cfg = th.jax_tiny_short(drop_path_rate=0.0)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm32, img, img, seed=31)
    batches = _batches()
    out = dict(variables=variables)
    tx = _capturing(build_optimizer(learning_rate=STEP_LR, weight_decay=1e-7,
                                    clip_value=0.5))
    for name, jm in (("jax32", jm32),
                     ("jax16", JaxEMIPShort(config=cfg, dtype=jnp.bfloat16))):
        state = TrainState.create(variables, tx, GMFLOW_FREEZE)
        step = make_short_train_step(jm, tx, donate=False)
        losses, grads = [], None
        for i, (a, b, gt) in enumerate(batches):
            state, metrics = step(state, dict(image1=a, image2=b, gt=gt),
                                  jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
            if grads is None:
                grads = state.opt_state[0]
        frozen = jax.tree_util.tree_map(np.zeros_like, state.frozen)
        full = merge_params(jax.tree_util.tree_map(np.asarray, grads),
                            frozen)
        sd = state_dict_from_flax(
            {"params": full, "batch_stats": variables["batch_stats"]},
            th.DEPTHS, th.NUM_LAYERS)
        out[name] = dict(losses=losses, grads=sd)

    sd = state_dict_from_flax(variables, th.DEPTHS, th.NUM_LAYERS)
    for name, dtype in (("port32", torch.float32), ("port16", BF16)):
        model = th.torch_tiny_short(drop_path_rate=0.0, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        opt = port_optimizer(model, STEP_LR, 1e-7, 0.5)
        gm0 = {k: v.clone() for k, v in model.GMFlow.state_dict().items()}
        grads = {}
        clamp_and_step = opt.step

        def step(closure=None):  # the first step's grads, before the clamp
            if not grads:
                grads.update({n: None if p.grad is None else p.grad.clone()
                              for n, p in model.named_parameters()
                              if p.requires_grad})
            return clamp_and_step(closure)

        opt.step = step
        losses = []
        for a, b, gt in batches:
            batch = dict(image1=th.nchw(a), image2=th.nchw(b),
                         gt=th.nchw(gt))
            losses.append(float(short_train_step(model, opt, batch)["loss"]))
        out[name] = dict(losses=losses, grads=grads, model=model,
                         gmflow_kept=all(
                             torch.equal(v, gm0[k]) for k, v in
                             model.GMFlow.state_dict().items()))
    return out


def _grad_vectors(runs, names):
    """Per run, the named leaves' grads as one fp64 vector (a leaf the
    graph does not reach counts as zeros)."""
    vec = {}
    for run in ("jax32", "jax16", "port32", "port16"):
        grads = runs[run]["grads"]
        parts = []
        for n in names:
            g = grads[n]
            shape = runs["jax32"]["grads"][n].shape
            parts.append(np.zeros(shape).ravel() if g is None
                         else _np(g).ravel())
        vec[run] = np.concatenate(parts)
    return vec


def test_bf16_train_step_within_jax_band(short_runs):
    """One step: the port's bf16 loss and all trainable leaves' grads
    together lie within 2 x gap(JAX bf16, JAX fp32) of JAX bf16 (max and
    mean); the port's own bf16-vs-fp32 gap is at least a quarter of JAX's;
    GMFlow is frozen and untouched. Measured: see the worst single leaf in
    the assertion messages (CHANGES.md)."""
    runs = short_runs
    model = runs["port16"]["model"]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert not any(n.startswith("GMFlow.") for n in names)
    assert runs["port16"]["gmflow_kept"] and runs["port32"]["gmflow_kept"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    loss = {k: runs[k]["losses"][0] for k in runs if k != "variables"}
    loss_gap = abs(loss["jax16"] - loss["jax32"])
    assert loss_gap > 0
    assert abs(loss["port16"] - loss["jax16"]) <= 2 * loss_gap, loss
    v = _grad_vectors(runs, names)
    gap = np.abs(v["jax16"] - v["jax32"])
    err = np.abs(v["port16"] - v["jax16"])
    own = np.abs(v["port16"] - v["port32"])
    worst = max(
        (float(np.abs(_np(runs["port16"]["grads"][n])
                      - _np(runs["jax16"]["grads"][n])).max()
               / max(float(np.abs(_np(runs["jax16"]["grads"][n])
                                  - _np(runs["jax32"]["grads"][n])).max()),
                     1e-30)), n)
        for n in names if runs["port16"]["grads"][n] is not None)
    msg = (f"err max {err.max():.3e} mean {err.mean():.3e}; JAX gap max "
           f"{gap.max():.3e} mean {gap.mean():.3e}; port gap max "
           f"{own.max():.3e}; worst leaf {worst[1]} at {worst[0]:.2f} x "
           f"its own gap")
    print(msg)
    assert gap.max() > 0, msg
    assert err.max() <= 2 * gap.max(), msg
    assert err.mean() <= 2 * gap.mean(), msg
    assert own.max() >= 0.25 * gap.max(), msg


def test_bf16_three_step_ab_within_jax_band(short_runs):
    """The A/B protocol of PARITY.md over STEPS clamp + AdamW steps at lr
    1e-3 from identical weights on identical batches: max |delta total
    loss| of port bf16 against JAX bf16 is at most twice that of JAX bf16
    against JAX fp32, and every loss is finite."""
    la = np.asarray(short_runs["port16"]["losses"])
    lj = np.asarray(short_runs["jax16"]["losses"])
    l32 = np.asarray(short_runs["jax32"]["losses"])
    assert la.shape == lj.shape == (STEPS,)
    assert np.isfinite(la).all()
    band = np.abs(lj - l32).max()
    assert band > 0
    assert np.abs(la - lj).max() <= 2 * band, (la, lj, l32)


# ---------------------------------------------- the static train step

SEG_DEPTHS = (1, 1, 2, 1)


@pytest.fixture(scope="module")
def static_runs():
    """SegNetwork of both packages (b0 widths, PVT depths (1, 1, 2, 1),
    drop path off) on one set of seeded variables, in bf16 and fp32: the
    hybrid-E loss of one train-mode batch and every leaf's grad; and one
    ``static_train_step`` of the port's bf16 model."""
    from emip_tpu.losses.seg import hybrid_e_loss as jax_loss
    from emip_tpu.models.backbones import register_backbone
    from emip_tpu.models.emip_short import SegNetwork as JaxSeg
    from emip_tpu.models.pvt_v2 import PVTv2, PVTv2Config
    from emip_tpu_torch.convert import state_dict_from_flax_seg
    from emip_tpu_torch.losses.seg import hybrid_e_loss
    from emip_tpu_torch.models.emip_short import SegNetwork
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS
    from emip_tpu_torch.train.state import ClampAdamW
    from emip_tpu_torch.train.static import static_train_step

    import dataclasses

    b0 = PVTv2Config((32, 64, 160, 256), (1, 2, 5, 8), (8, 8, 4, 4),
                     SEG_DEPTHS, (8, 4, 2, 1), drop_path_rate=0.0,
                     remat=False, fused_attn="always")
    name = "pvt_v2_b0_port_static_bf16"
    register_backbone(name, lambda dtype: PVTv2(config=b0, dtype=dtype),
                      b0.embed_dims)
    rng = np.random.default_rng(46)
    x = rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(2, th.SIZE, th.SIZE, 1)) > 0.6).astype(
        np.float32)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(JaxSeg(backbone_name=name,
                                           channel=th.CHANNEL), img,
                                    seed=21, train=False)
    out = {}
    for run, dtype in (("jax32", jnp.float32), ("jax16", jnp.bfloat16)):
        jm = JaxSeg(backbone_name=name, channel=th.CHANNEL, dtype=dtype)

        def loss_fn(params, jm=jm):
            logits, _ = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x, train=True, rngs={"droppath": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return jax_loss(logits, gt)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"])
        out[run] = dict(loss=float(loss), grads=state_dict_from_flax_seg(
            {"params": jax.tree_util.tree_map(np.asarray, grads),
             "batch_stats": variables["batch_stats"]}, SEG_DEPTHS))
    sd = state_dict_from_flax_seg(variables, SEG_DEPTHS)
    cfg = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b0"], depths=SEG_DEPTHS,
                              drop_path_rate=0.0)
    for run, dtype in (("port32", torch.float32), ("port16", BF16)):
        model = SegNetwork(cfg, th.CHANNEL, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        model.train()
        names = [n for n, _ in model.named_parameters()]
        loss = hybrid_e_loss(model(th.nchw(x)), th.nchw(gt))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[run] = dict(loss=float(loss.detach()),
                        grads=dict(zip(names, grads)), model=model)
    model = out["port16"]["model"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = ClampAdamW(model.parameters(), STEP_LR, 1e-7, 0.5)
    step_loss = static_train_step(model, opt, dict(image=th.nchw(x),
                                                   gt=th.nchw(gt)))
    out["step"] = dict(loss=float(step_loss), moved=[
        n for n, p in model.named_parameters()
        if not torch.equal(p.detach(), before[n])], leaves=len(before))
    return out


def test_bf16_static_step_within_jax_band(static_runs):
    """The static step's loss and every leaf's grad together within 2 x
    gap(JAX bf16, JAX fp32) of JAX bf16 (max and mean), the port's own gap
    at least a quarter of JAX's, fp32 logits from the bf16 model; one bf16
    static train step moves every leaf and keeps the parameters fp32."""
    runs = static_runs
    names = list(runs["port16"]["grads"])
    loss_gap = abs(runs["jax16"]["loss"] - runs["jax32"]["loss"])
    assert loss_gap > 0
    assert abs(runs["port16"]["loss"] - runs["jax16"]["loss"]) <= \
        2 * loss_gap
    vec = {run: np.concatenate([_np(runs[run]["grads"][n]).ravel()
                                for n in names])
           for run in ("jax32", "jax16", "port32", "port16")}
    gap = np.abs(vec["jax16"] - vec["jax32"])
    err = np.abs(vec["port16"] - vec["jax16"])
    own = np.abs(vec["port16"] - vec["port32"])
    msg = (f"err max {err.max():.3e} mean {err.mean():.3e}; JAX gap max "
           f"{gap.max():.3e} mean {gap.mean():.3e}; port gap max "
           f"{own.max():.3e}")
    print(msg)
    assert gap.max() > 0, msg
    assert err.max() <= 2 * gap.max(), msg
    assert err.mean() <= 2 * gap.mean(), msg
    assert own.max() >= 0.25 * gap.max(), msg
    step = runs["step"]
    assert np.isfinite(step["loss"])
    assert len(step["moved"]) == step["leaves"]
    model = runs["port16"]["model"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.compute_dtype == BF16


# --------------------------------------------------- the entry points


@pytest.mark.parametrize("entry", ["train", "train_static"])
def test_trainers_honour_bfloat16(tmp_path, monkeypatch, entry):
    """``train`` and ``train_static`` on a tiny YAML that says bfloat16
    build their model in bf16 on ``--device cpu``, take their steps and
    save an fp32 state dict, which loads into an fp32 model and into a bf16
    one."""
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.train import loops, static

    built = []
    if entry == "train":
        from emip_tpu_torch.data import make_synthetic_video_root
        from emip_tpu_torch.train.__main__ import main

        real = loops.seeded_init_

        def spy(model, seed):
            built.append(model.compute_dtype)
            return real(model, seed)

        monkeypatch.setattr(loops, "seeded_init_", spy)
        root = make_synthetic_video_root(str(tmp_path / "data"),
                                         num_videos=1, frames_per_video=3,
                                         size=(56, 64))
        save = str(tmp_path / "run")
        cfg = th.tiny_yaml(tmp_path / "tiny.yaml", root, save,
                           compute_dtype="bfloat16", epoch=2)
        summary = main(["--config", cfg, "--max_steps_per_epoch", "1",
                        "--device", "cpu"])
        assert summary["steps"] == 1 and np.isfinite(summary["best_mae"])
        ckpt = os.path.join(save, "ckpt", "ckpt.pt")
    else:
        from emip_tpu_torch.data import make_synthetic_static_root
        from emip_tpu_torch.train_static import main

        real = static.build_seg_model

        def spy(cfg, device):
            model = real(cfg, device)
            built.append(model.compute_dtype)
            return model

        monkeypatch.setattr(static, "build_seg_model", spy)
        root = make_synthetic_static_root(str(tmp_path / "data"),
                                          num_images=4, size=(56, 64))
        save = str(tmp_path / "run")
        cfg = th.tiny_yaml(tmp_path / "tiny.yaml", root, save,
                           compute_dtype="bfloat16")
        summary = main(["--config", cfg, "--data_root", root,
                        "--max_steps_per_epoch", "2", "--device", "cpu"])
        assert summary["steps"] == 2 and np.isfinite(summary["last_loss"])
        ckpt = os.path.join(save, "static", "ckpt", "ckpt.pt")
    assert built == [BF16]
    state = torch.load(ckpt)["model"]
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in state.values())
    conf = load_config(cfg)
    for dtype in (torch.float32, BF16):
        if entry == "train":
            model = EMIPShort(conf.model, dtype=dtype)
            model.load_state_dict(state)
        else:
            model = static.build_seg_model(conf, "cpu")
            model.load_state_dict(state)
            _, unexpected = EMIPShort(conf.model, dtype=dtype
                                      ).load_state_dict(state, strict=False)
            assert unexpected == []


# --------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_bf16_backward_kernels_match_plain_versions():
    """The bf16 backwards of A, B, C and D, and of G and H (512^2 windows)
    and J, on the card against the fp32 plain version's VJP at the upcast
    inputs, each grad rounded to its input's dtype (1e-2 of max|ref| per
    grad), the grads' dtypes, the same bits on a second call, one bf16
    backward launch each and no fp32 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels import _common as cm
    from emip_tpu_torch.kernels.window_attention import _block_recompute_bf16
    from emip_tpu_torch.ops.window import shifted_window_mask

    g = torch.Generator().manual_seed(9)

    def r(*s, scale=1.0, dtype=BF16):
        return (torch.randn(*s, generator=g) * scale).to(dtype).cuda()

    f32 = torch.float32
    c, f = 128, 1024
    w = lambda *s: r(*s, scale=s[1] ** -0.5, dtype=f32)  # noqa: E731
    sp = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
              s1=r(c, scale=0.1, dtype=f32) + 1, b1=r(c, scale=0.1, dtype=f32))
    cp = dict(sp, w0=w(f, 2 * c), w2=w(c, f), s2=sp["s1"], b2=sp["b1"])
    keys = ("wq", "wk", "wv", "wm", "s1", "b1")
    ckeys = keys + ("w0", "w2", "s2", "b2")
    mask = shifted_window_mask(44, 44, 2, device="cuda")

    def block(fn):
        return lambda x, t, *p: fn(x, t, dict(zip(keys, p[:6])),
                                   dict(zip(ckeys, p[6:])), mask)

    mask512 = shifted_window_mask(64, 64, 2, device="cuda")

    def layer(fn, names):
        return lambda x, t, *p: fn(x, t, dict(zip(names, p)), mask512)

    cases = [
        ("sr_attention_bwd_bf16", K.fused_sr_attention,
         K.fused_sr_attention_reference,
         [r(2, 300, 64), r(2, 49, 64), r(64, 64, scale=0.125),
          r(64, scale=0.1, dtype=f32), r(128, 64, scale=0.125),
          r(128, scale=0.1, dtype=f32), r(64, 64, scale=0.125),
          r(64, scale=0.1, dtype=f32)], (2,)),
        ("window_attention_block_bwd_bf16",
         block(K.fused_window_attention_block), block(_block_recompute_bf16),
         [r(2, 4, 484, c), r(2, 4, 484, c)] + [sp[k] for k in keys]
         + [cp[k] for k in ckeys], ()),
        ("flow_attention_bwd_bf16", K.fused_flow_attention,
         K.fused_flow_attention_reference,
         [r(2, 1000, 128), r(2, 1000, 128),
          r(2, 1000, 2, scale=10, dtype=f32)],
         ()),
        ("convex_upsample_bwd_bf16", K.convex_upsample,
         K.convex_upsample_reference,
         [r(2, 44, 44, 2, scale=3, dtype=f32), r(2, 44, 44, 576)], (8,)),
        ("window_attention_layer_bwd_bf16",
         layer(K.fused_window_attention_layer, keys),
         layer(K.fused_window_attention_layer_reference, keys),
         [r(2, 4, 1024, c), r(2, 4, 1024, c)] + [sp[k] for k in keys], ()),
        ("window_attention_ffn_layer_bwd_bf16",
         layer(K.fused_window_attention_ffn_layer, ckeys),
         layer(K.fused_window_attention_ffn_layer_reference, ckeys),
         [r(2, 4, 1024, c), r(2, 4, 1024, c)] + [cp[k] for k in ckeys], ()),
        ("dwconv_gelu_bwd_bf16", K.fused_dwconv_gelu,
         K.fused_dwconv_gelu_reference,
         [r(2, 44 * 44, 256), r(3, 3, 256, scale=0.3),
          r(256, scale=0.1, dtype=f32)], (44, 44)),
    ]
    for name, fn, plain, args, extra in cases:
        leaves = [a.detach().requires_grad_(True) for a in args]
        out = fn(*leaves, *extra)
        cot = torch.randn(out.shape, generator=g).to(out.dtype).cuda()
        before = dict(K.LAUNCHES)
        got = torch.autograd.grad(out, leaves, cot, retain_graph=True)
        again = torch.autograd.grad(out, leaves, cot)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before[name] + 2, name
        fp32 = name.replace("_bf16", "")
        assert K.LAUNCHES[fp32] == before[fp32], name
        want = cm.plain_vjp_fp32(plain, args, [True] * len(args), cot,
                                 *extra)
        for i, (a, b, ref, x) in enumerate(zip(got, again, want, args)):
            assert a.dtype == x.dtype == ref.dtype, (name, i)
            assert torch.equal(a, b), (name, i)
            err = (a.float() - ref.float()).abs().max()
            assert err <= 1e-2 * ref.float().abs().max(), (name, i, err)
