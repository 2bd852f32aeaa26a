"""The rest of the bf16 band against the JAX package in bf16, on the CPU: G's
and H's bf16 backwards (the short train step at 512^2), kernel J in bf16
(the fused MixFFN switches) and read-corr matching (kernel I) in a bf16
model.

The JAX package's published ``compute_dtype`` is bfloat16 in every
configuration. Its G and H backward kernels upcast the bf16 windows,
recompute the layer in fp32 on the fp32 weights and round gx and gt to
bf16; its J kernels compute in fp32 on the widened bf16 u and taps and
store bf16 (the tap grad is returned in the taps' dtype, so it is rounded
to bf16 before the cast's VJP widens it); under read-corr matching kernel I
reads the fp32 correlation volume in both bands. Here, on the same numpy
inputs and weights, with the JAX Pallas kernels in interpret mode:

- G's (with and without the residual) and H's bf16 VJPs, masked and
  unmasked, against ``jax.vjp`` of the Pallas functions on bf16 windows:
  every grad in JAX's dtype and within 8e-3 of max|ref| (two bf16 ulps, as
  tests/test_torch_bf16_train.py holds A-D); the backward keeps no graph
  without a gradient;
- J's bf16 forward and VJP against ``fused_dwconv_gelu`` and, with the
  library's forward, ``dwconv_gelu_bwd_fused``, on bf16 u and taps cast to
  bf16: the same limit, and the tap grad rounded to bf16;
- the tiny two-stream model (tests/torch_helpers.py, drop path off) in
  bf16 with ``fused_block_max_t`` 8 (G and H on its 16-token windows),
  with read-corr matching (I) and with ``fused_ffn="always"`` (J), on the
  variables of six seeds: one train step's loss and all trainable leaves'
  grads within twice JAX's own bf16-vs-fp32 gap of JAX's bf16 step, the
  port's own gap at least a quarter of JAX's; then three clamp + AdamW
  steps, the A/B protocol of PARITY.md;
- why JAX's bf16 block (B) and its G then H differ where the port's two
  agree: XLA's excess precision on the CPU, pinned at the kernels.
"""

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


# ------------------------------------------------------ G and H backward

_SELF = ("wq", "wk", "wv", "wm", "s1", "b1")
_CROSS = _SELF + ("w0", "w2", "s2", "b2")


def _layer_case(layer, shifted, c=64, f=128):
    """bf16 windows [2, 4, 16, C] (8 x 8 maps in 4 x 4 windows), a
    cotangent, fp32 parameters in JAX's layout and the shift mask or
    None."""
    from emip_tpu.ops.window import shifted_window_mask

    rng = np.random.default_rng(90 + 2 * shifted + (layer == "H"))
    shape = (2, 4, 16, c)
    x, t, cot = (rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))

    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    def ln():
        return (rng.uniform(0.7, 1.3, c).astype(np.float32),
                rng.normal(0, 0.05, c).astype(np.float32))

    p = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c))
    p["s1"], p["b1"] = ln()
    if layer == "H":
        p.update(w0=w(2 * c, f), w2=w(f, c))
        p["s2"], p["b2"] = ln()
    mask = np.asarray(shifted_window_mask(8, 8, 2)) if shifted else None
    return x, t, cot, p, mask


def _layer_grads(layer, shifted, residual=True):
    """(JAX grads, port grads) of G or H on bf16 windows, names -> grads."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_ffn_layer,
        fused_window_attention_layer,
    )

    x, t, cot, p, mask = _layer_case(layer, shifted)
    keys = _CROSS if layer == "H" else _SELF
    jmask = None if mask is None else jnp.asarray(mask)
    if layer == "H":
        def jfn(x, t, *ps):
            return fused_window_attention_ffn_layer(x, t, *ps, jmask)
    else:
        def jfn(x, t, *ps):
            return fused_window_attention_layer(x, t, *ps, jmask, residual)
    _, vjp = jax.vjp(jfn, _jb(x), _jb(t), *(jnp.asarray(p[k]) for k in keys))
    want = dict(zip(("x", "t") + keys, vjp(_jb(cot))))
    tx, tt = _tb(x).requires_grad_(True), _tb(t).requires_grad_(True)
    tp = {k: _t(_torch_layout(p[k])).requires_grad_(True) for k in keys}
    tmask = None if mask is None else _t(mask)
    if layer == "H":
        out = K.fused_window_attention_ffn_layer(tx, tt, tp, tmask)
    else:
        out = K.fused_window_attention_layer(tx, tt, tp, tmask, residual)
    assert out.dtype == BF16
    out.backward(_tb(cot))
    got = dict(x=tx.grad, t=tt.grad,
               **{k: _torch_layout(v.grad) for k, v in tp.items()})
    return want, got


@pytest.mark.parametrize("layer,residual", [("G", True), ("G", False),
                                            ("H", True)])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_layer_bf16_vjp_matches_pallas(layer, residual, shifted):
    """G (its 6 parameter grads, with and without the residual) and H (its
    10, W0 as one [F, 2C] weight against JAX's two halves joined): gx, gt
    bf16 and the parameter grads fp32, each within 8e-3 of max|ref|;
    measured worst 2.4e-4 for G and 2.6e-3 for H (both sides round the
    same fp32 grads once: a flip of one bf16 ulp near max|ref|)."""
    want, got = _layer_grads(layer, shifted, residual)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert _dtype_name(g) == _dtype_name(w), name
        assert _rel(g, w) <= KERNEL_REL, name


@pytest.mark.parametrize("layer", ["G", "H"])
def test_window_layer_bf16_backward_counts_no_launch_on_the_cpu(layer):
    """On CPU tensors the bf16 backward is the fp32 plain VJP at the
    upcast inputs (gx, gt bf16): no kernel launch is counted, and only the
    grads asked for come back."""
    x, t, cot, p, mask = _layer_case(layer, True)
    keys = _CROSS if layer == "H" else _SELF
    tp = {k: _t(_torch_layout(p[k])) for k in keys}
    fn = (K.fused_window_attention_ffn_layer if layer == "H"
          else K.fused_window_attention_layer)
    leaf = _tb(t).requires_grad_(True)
    before = dict(K.LAUNCHES)
    out = fn(_tb(x), leaf, tp, _t(mask))
    (gt,) = torch.autograd.grad(out, [leaf], _tb(cot))
    assert gt.dtype == BF16 and torch.isfinite(gt.float()).all()
    assert K.LAUNCHES == before


# ------------------------------------------------------------- kernel J


def _dwconv_case(seed, b=2, h=6, w=8, f=16):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, h * w, f)).astype(np.float32)
    wdw = (rng.standard_normal((3, 3, f)) / 3).astype(np.float32)
    bdw = rng.normal(0, 0.1, f).astype(np.float32)
    cot = rng.standard_normal((b, h * w, f)).astype(np.float32)
    return u, wdw, bdw, cot, h, w


@pytest.mark.parametrize("library_forward", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 8, 16), (1, 7, 13, 8)])
def test_dwconv_gelu_bf16_and_vjp_match_pallas(library_forward, shape):
    """J in bf16 on bf16 u and taps cast to bf16 (fp32 leaves, as the
    model's parameters), the bias fp32: forward bf16 and gu bf16 within
    8e-3 of max|ref| of ``fused_dwconv_gelu`` (J's forward) or, with the
    library's forward, ``dwconv_gelu_bwd_fused``; the tap and bias grads
    fp32 at the leaves, the tap grad rounded to bf16 on both sides.
    Measured: J's forward 0 to 7e-6 of max|ref|, the library's bf16
    forward 1.8-4.3e-3 (cuDNN's and XLA's bf16 convolutions round apart),
    gu and the tap grad equal, the bias grad 2e-7."""
    from emip_tpu.ops.pallas.mixffn import (
        dwconv_gelu_bwd_fused,
        fused_dwconv_gelu,
    )

    b, h, w, f = shape
    u, wdw, bdw, cot, h, w = _dwconv_case(60 + f, b, h, w, f)
    jfn = dwconv_gelu_bwd_fused if library_forward else fused_dwconv_gelu

    def jax_fn(u, wdw, bdw):
        return jfn(u, wdw.astype(jnp.bfloat16), bdw, h, w)

    want, vjp = jax.vjp(jax_fn, _jb(u), jnp.asarray(wdw), jnp.asarray(bdw))
    gwant = vjp(_jb(cot))
    tu = _tb(u).requires_grad_(True)
    tw, tbias = (_t(a).requires_grad_(True) for a in (wdw, bdw))
    got = K.fused_dwconv_gelu(tu, tw.to(BF16), tbias, h, w,
                              library_forward=library_forward)
    assert _dtype_name(got) == _dtype_name(want) == "bfloat16"
    assert _rel(got, want) <= KERNEL_REL
    got.backward(_tb(cot))
    for name, g, wv in zip(("u", "wdw", "bdw"), (tu.grad, tw.grad,
                                                 tbias.grad), gwant):
        assert _dtype_name(g) == _dtype_name(wv), name
        assert _rel(g, wv) <= KERNEL_REL, name
    for gw in (tw.grad, torch.from_numpy(np.asarray(gwant[1]))):
        assert torch.equal(gw, gw.to(BF16).float())


def test_dwconv_gelu_bf16_returns_grads_in_the_inputs_dtypes():
    """Called on bf16 taps directly, J's bf16 VJP returns gu and the tap
    grad in bf16 and the bias grad in fp32 (the JAX kernel's dtypes), from
    the fp32 VJP at the widened inputs; no graph without a gradient."""
    u, wdw, bdw, cot, h, w = _dwconv_case(70)
    leaves = [_tb(u).requires_grad_(True), _tb(wdw).requires_grad_(True),
              _t(bdw).requires_grad_(True)]
    with torch.no_grad():
        assert K.fused_dwconv_gelu(*leaves, h, w).grad_fn is None
    out = K.fused_dwconv_gelu(*leaves, h, w)
    grads = torch.autograd.grad(out, leaves, _tb(cot))
    assert [g.dtype for g in grads] == [BF16, BF16, torch.float32]
    up =[x.detach().float().requires_grad_(True) for x in leaves]
    want = torch.autograd.grad(K.fused_dwconv_gelu_reference(*up, h, w), up,
                               _tb(cot).float())
    for g, wv, x in zip(grads, want, leaves):
        assert torch.equal(g, wv.to(x.dtype))


# ------------------------------------------------ the tiny train steps

# each configuration: the port's switches (GMFlow fields, PVT fields), the
# JAX package's (environment knobs read when it traces, PVT fields)
CONFIGS = {
    "G/H": (dict(fused_block_max_t=8), {},
            {"EMIP_FUSED_BLOCK_MAX_T": "8"}, {}),
    "I": (dict(global_match_qk_fused=False), {},
          {"EMIP_GLOBAL_MATCH_QK": "0"}, {}),
    "J": ({}, dict(fused_ffn="always"), {}, dict(fused_ffn="always")),
}


# The seeds of the variables (the batches from seed + 1000) of the switched
# train steps. Every grad gate is held at each seed. A scalar loss's gap
# between JAX's bf16 and fp32 steps is as noisy as the difference it bounds
# (at one seed it falls to 1.1e-4 for an error of 1e-3), so the loss and
# the three-step A/B are held pooled: the sum of the port's errors over the
# seeds against twice the sum of JAX's gaps.
SEEDS = range(1, 7)


def _batches(seed, n=STEPS):
    rng = np.random.default_rng(seed + 1000)
    return [(rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32),
             rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32),
             (rng.uniform(size=(2, th.SIZE, th.SIZE, 1)) > 0.5
              ).astype(np.float32)) for _ in range(n)]


def _capturing(tx):
    """``tx`` after a transformation that keeps each step's raw grads in
    its state (the first element of the optimizer state)."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


@pytest.fixture(scope="module", params=list(CONFIGS))
def switched_runs(request):
    """The tiny EMIPShort of both packages with one kernel switch, drop path
    off, on the variables of each of SEEDS: JAX bf16 and fp32
    ``make_short_train_step`` (clamp + AdamW at STEP_LR) for STEPS steps,
    each step's total loss and the first step's grads of the trainable
    tree; the port's bf16 and fp32 models the same, their first step's
    grads taken before the clamp, and the launches they count (none: the
    CPU runs the plain versions). A list with one dict per seed."""
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

    gm, pvt, env, jpvt = CONFIGS[request.param]
    jm32, cfg = th.jax_tiny_short(drop_path_rate=0.0, pvt=jpvt)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    tx = _capturing(build_optimizer(learning_rate=STEP_LR, weight_decay=1e-7,
                                    clip_value=0.5))
    runs = [dict(config=request.param, seed=seed,
                 variables=th.random_variables(jm32, img, img, seed=seed))
            for seed in SEEDS]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        for name, jm in (("jax32", jm32), ("jax16", JaxEMIPShort(
                config=cfg, dtype=jnp.bfloat16))):
            step = make_short_train_step(jm, tx, donate=False)
            for out in runs:
                variables = out["variables"]
                state = TrainState.create(variables, tx, GMFLOW_FREEZE)
                losses, grads = [], None
                for i, (a, b, gt) in enumerate(_batches(out["seed"])):
                    state, metrics = step(state, dict(image1=a, image2=b,
                                                      gt=gt),
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

    for out in runs:
        sd = state_dict_from_flax(out.pop("variables"), th.DEPTHS,
                                  th.NUM_LAYERS)
        for name, dtype in (("port32", torch.float32), ("port16", BF16)):
            model = th.torch_tiny_short(drop_path_rate=0.0, dtype=dtype,
                                        pvt=pvt, **gm)
            model.load_state_dict(sd, strict=True)
            opt = port_optimizer(model, STEP_LR, 1e-7, 0.5)
            grads = {}

            def step(closure=None, grads=grads, model=model,
                     clamp_and_step=opt.step):  # the grads before the clamp
                if not grads:
                    grads.update({n: None if p.grad is None
                                  else p.grad.clone()
                                  for n, p in model.named_parameters()
                                  if p.requires_grad})
                return clamp_and_step(closure)

            opt.step = step
            before = dict(K.LAUNCHES)
            losses = []
            for a, b, gt in _batches(out["seed"]):
                batch = dict(image1=th.nchw(a), image2=th.nchw(b),
                             gt=th.nchw(gt))
                losses.append(float(short_train_step(model, opt, batch)[
                    "loss"]))
            out[name] = dict(losses=losses, grads=grads, model=model,
                             launched=K.LAUNCHES != before)
    return runs


def _grad_vectors(run):
    """Each run's first-step grads of every trainable leaf as one vector
    (a leaf without a grad as zeros)."""
    names = [n for n, p in run["port16"]["model"].named_parameters()
             if p.requires_grad]
    vec = {}
    for name in ("jax32", "jax16", "port32", "port16"):
        grads = run[name]["grads"]
        vec[name] = np.concatenate([
            np.zeros(run["jax32"]["grads"][n].shape).ravel()
            if grads[n] is None else _np(grads[n]).ravel() for n in names])
    return vec


def test_bf16_switched_train_step_within_jax_band(switched_runs):
    """One step of each switched configuration at each of SEEDS: all
    trainable leaves' grads of the port's bf16 step lie within 2 x
    gap(JAX bf16, JAX fp32) of JAX bf16 (max and mean), the port's own
    bf16-vs-fp32 gap is at least a quarter of JAX's, the parameters stay
    fp32; the loss pooled over the seeds: sum |port bf16 - JAX bf16| <= 2 x
    sum |JAX bf16 - JAX fp32|. Measured: the readings printed (CHANGES.md)."""
    err_sum = gap_sum = 0.0
    for run in switched_runs:
        model = run["port16"]["model"]
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert not run["port16"]["launched"]
        loss = {k: run[k]["losses"][0]
                for k in ("jax32", "jax16", "port32", "port16")}
        err_sum += abs(loss["port16"] - loss["jax16"])
        gap_sum += abs(loss["jax16"] - loss["jax32"])
        vec = _grad_vectors(run)
        gap = np.abs(vec["jax16"] - vec["jax32"])
        err = np.abs(vec["port16"] - vec["jax16"])
        own = np.abs(vec["port16"] - vec["port32"])
        msg = (f"{run['config']} seed {run['seed']}: loss err "
               f"{abs(loss['port16'] - loss['jax16']):.3e} gap "
               f"{abs(loss['jax16'] - loss['jax32']):.3e}; grads err max "
               f"{err.max():.3e} mean {err.mean():.3e}; JAX gap max "
               f"{gap.max():.3e} mean {gap.mean():.3e}; port gap max "
               f"{own.max():.3e}")
        print(msg)
        assert gap.max() > 0, msg
        assert err.max() <= 2 * gap.max(), msg
        assert err.mean() <= 2 * gap.mean(), msg
        assert own.max() >= 0.25 * gap.max(), msg
    print(f"loss pooled: err {err_sum:.3e} gap {gap_sum:.3e} ratio "
          f"{err_sum / gap_sum:.3f}")
    assert gap_sum > 0
    assert err_sum <= 2 * gap_sum, (err_sum, gap_sum)


def test_bf16_switched_three_step_ab_within_jax_band(switched_runs):
    """The A/B protocol of PARITY.md over STEPS clamp + AdamW steps at lr
    1e-3 from identical weights on identical batches, pooled over SEEDS:
    the sum of each seed's max |delta total loss| of port bf16 against JAX
    bf16 is at most twice the sum of JAX bf16's against JAX fp32, and every
    loss is finite."""
    err_sum = band_sum = 0.0
    for run in switched_runs:
        la = np.asarray(run["port16"]["losses"])
        lj = np.asarray(run["jax16"]["losses"])
        l32 = np.asarray(run["jax32"]["losses"])
        assert la.shape == lj.shape == (STEPS,)
        assert np.isfinite(la).all()
        err_sum += np.abs(la - lj).max()
        band_sum += np.abs(lj - l32).max()
    print(f"{switched_runs[0]['config']} A/B pooled: err {err_sum:.3e} band "
          f"{band_sum:.3e} ratio {err_sum / band_sum:.3f}")
    assert band_sum > 0
    assert err_sum <= 2 * band_sum, (err_sum, band_sum)


def test_bf16_layers_forward_is_the_block_forward():
    """G then H in bf16 (``fused_block_max_t`` 8, the 512^2 path) is B's
    bf16 forward split in two, as the JAX kernels are: on the CPU the tiny
    bf16 model gives the same mask and flow bits either way, in train mode
    and in eval mode."""
    jm32, _ = th.jax_tiny_short(drop_path_rate=0.0)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    seed = SEEDS[0]
    sd = state_dict_from_flax(th.random_variables(jm32, img, img, seed=seed),
                              th.DEPTHS, th.NUM_LAYERS)
    a, b, _ = _batches(seed, 1)[0]
    out = {}
    for name, gm in (("block", {}), ("layers", dict(fused_block_max_t=8))):
        model = th.torch_tiny_short(drop_path_rate=0.0, dtype=BF16, **gm)
        model.load_state_dict(sd, strict=True)
        for mode in (True, False):
            model.train(mode)
            with torch.no_grad():
                mask, fw, _ = model(th.nchw(a), th.nchw(b))
            out[name, mode] = (mask, fw[-1])
    for mode in (True, False):
        for x, y in zip(out["block", mode], out["layers", mode]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("shifted", [False, True])
def test_jax_bf16_block_and_layers_differ_only_by_excess_precision(shifted):
    """Why JAX's bf16 block (B) and its G then H give different bf16 losses
    where the port's two give the same bits. Both JAX kernels round x1 =
    x + bf16(msg) to bf16 in their source (``x + msg.astype(dt)``); G
    writes it to its bf16 output, but the block widens it again for the
    cross layer at once, and XLA's CPU compiler, allowed excess precision
    by default, drops that round trip. Compiled without excess precision
    the two JAX paths give the same bits; the port's block and its G then
    H (the same bits) lie within a bf16 ulp of them at under 1% of the
    elements (fp32 sums in another order), against about 40% for the
    block as XLA compiles it by default."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_block as jax_block,
    )
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_ffn_layer as jax_ffn_layer,
    )
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_layer as jax_layer,
    )

    x, _, _, sp, mask = _layer_case("G", shifted)
    _, t, _, cp, _ = _layer_case("H", shifted)
    jmask = None if mask is None else jnp.asarray(mask)
    jsp = {k: jnp.asarray(v) for k, v in sp.items()}
    jcp = {k: jnp.asarray(v) for k, v in cp.items()}

    def block(x, t):
        return jax_block(x, t, jsp, jcp, jmask)

    def layers(x, t):
        x1 = jax_layer(x, x, *(jsp[k] for k in _SELF), jmask, True)
        return jax_ffn_layer(x1, t, *(jcp[k] for k in _CROSS), jmask)

    def run(fn, **options):
        args = (_jb(x), _jb(t))
        return jax.jit(fn).lower(*args).compile(compiler_options=options)(
            *args)

    exact = {"xla_allow_excess_precision": False}
    want = run(layers, **exact)
    assert np.array_equal(_np(run(block, **exact)), _np(want))
    assert np.array_equal(_np(run(layers)), _np(want))
    tmask = None if mask is None else _t(mask)
    tsp = {k: _t(_torch_layout(v)) for k, v in sp.items()}
    tcp = {k: _t(_torch_layout(v)) for k, v in cp.items()}
    with torch.no_grad():
        got = K.fused_window_attention_block(_tb(x), _tb(t), tsp, tcp, tmask)
        x1 = K.fused_window_attention_layer(_tb(x), _tb(x), tsp, tmask)
        assert torch.equal(
            K.fused_window_attention_ffn_layer(x1, _tb(t), tcp, tmask), got)
    off = np.abs(_np(got) - _np(want))
    assert (off > 0).mean() < 1e-2
    assert off.max() <= 2.0 ** -7 * np.abs(_np(want)).max()
    assert (_np(run(block)) != _np(want)).mean() > 0.1


# --------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_bf16_dwconv_gelu_forward_matches_plain_version():
    """J's bf16 forward on the card against its plain bf16 version (1e-2
    of max|ref|) at the b5 stage shapes' widths and a ragged map, bf16 out,
    the same bits on a second call, one bf16 launch each and no fp32 one.
    (G's, H's and J's bf16 backwards are among the cases of
    tests/test_torch_bf16_train.py's test_cuda_bf16_backward_kernels_
    match_plain_versions.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = torch.Generator().manual_seed(13)

    def r(*s, scale=1.0, dtype=BF16):
        return (torch.randn(*s, generator=g) * scale).to(dtype).cuda()

    for b, h, w, f in ((2, 88, 88, 256), (2, 11, 11, 2048), (2, 7, 13, 256),
                       (1, 5, 6, 6)):
        u, taps = r(b, h * w, f), r(3, 3, f, scale=0.3)
        bias = r(f, scale=0.1, dtype=torch.float32)
        with torch.no_grad():
            before = dict(K.LAUNCHES)
            got = K.fused_dwconv_gelu(u, taps, bias, h, w)
            assert torch.equal(K.fused_dwconv_gelu(u, taps, bias, h, w), got)
            assert K.LAUNCHES["dwconv_gelu_bf16"] == before[
                "dwconv_gelu_bf16"] + 2
            assert K.LAUNCHES["dwconv_gelu"] == before["dwconv_gelu"]
            want = K.fused_dwconv_gelu_reference(u, taps, bias, h, w)
        assert got.dtype == want.dtype == BF16
        err = (got.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max(), ((b, h, w, f), err)
