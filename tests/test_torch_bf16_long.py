"""The bf16 long model and the bf16 windows of 512^2 against the JAX package
in bf16, on the CPU.

The JAX package's published ``compute_dtype`` is bfloat16 for the long
model too: ``EMIPLong(dtype=bfloat16)`` reads its fp32 memory ring with a
bf16 query key (kernel F on bf16 q, fp32 k, v and bias, fp32 out; dq bf16,
dk and dv fp32), and at windows above ``fused_block_max_t`` tokens (512^2)
the flow transformer runs G and H on bf16 windows. Here, on the same numpy
inputs and weights, with the JAX Pallas kernels in interpret mode:

- kernel F's bf16 forward and VJP against ``jax.vjp`` of the Pallas
  function, every output in JAX's dtype, within 8e-3 of max|ref| (two bf16
  ulps, as tests/test_torch_bf16.py holds kernels A-D);
- ``memory_read`` on the fp32 ring with a bf16 query, and the ring holding
  the pushed bf16 keys and values exactly;
- G's and H's plain bf16 versions against their Pallas kernels in bf16
  (8e-3), and their bf16 backward (the fp32 VJP at the upcast inputs, gx
  and gt rounded; held against ``jax.vjp`` in tests/test_torch_bf16_512.py);
- the tiny long model (tests/torch_helpers.py: b0 widths, depths (1, 1, 1,
  1), 64^2, a 3-slot ring) in bf16: ``step``, ``step_cached`` over three
  chained frames and ``scan_video`` within twice JAX's own bf16-vs-fp32 gap
  of JAX's bf16 model (max and mean), the port's own gap at least a quarter
  of JAX's (it really computes in bf16); the tiny short model with
  ``fused_block_max_t`` 8 (G and H on its 16-token windows) the same way;
- one bf16 long train step (loss and every trainable leaf's grad together)
  within twice JAX's gap of JAX's bf16 step, and a 3-step clamp + AdamW A/B
  (PARITY.md: max |delta loss| of port bf16 against JAX bf16 at most twice
  that of JAX bf16 against JAX fp32);
- ``train_long`` and ``test_long`` on a tiny YAML that says bfloat16 build
  a bf16 model and write fp32 checkpoints, and the short trainer trains in
  bf16 above ``fused_block_max_t`` (G's and H's bf16 backwards); a bf16
  EMIPLong with read-corr matching (kernel I on the fp32 volume) within
  JAX's band of JAX's.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch import kernels as K
from emip_tpu_torch.convert import state_dict_from_flax_long
from emip_tpu_torch.models.ltm import MemoryState, memory_read

BF16 = torch.bfloat16
KERNEL_REL = 8e-3
STEP_LR = 1e-3
STEPS = 3
H8 = th.SIZE // 8


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


def _band(got, jax16, jax32, port32) -> str:
    """Holds |got - JAX bf16| within twice |JAX bf16 - JAX fp32| (max and
    mean) and |got - port fp32| at least a quarter of JAX's gap; returns
    the readings."""
    got, jax16, jax32, port32 = (_np(a) for a in (got, jax16, jax32, port32))
    gap = np.abs(jax16 - jax32)
    err = np.abs(got - jax16)
    own = np.abs(got - port32)
    msg = (f"err max {err.max():.3e} mean {err.mean():.3e}; JAX gap max "
           f"{gap.max():.3e} mean {gap.mean():.3e}; port gap max "
           f"{own.max():.3e}")
    assert np.isfinite(got).all(), msg
    assert gap.max() > 0, msg
    assert err.max() <= 2 * gap.max(), msg
    assert err.mean() <= 2 * gap.mean(), msg
    assert own.max() >= 0.25 * gap.max(), msg
    return msg


# ------------------------------------------------------------ kernel F


def _read_inputs(b, m, slots, c, valid, seed):
    """q [b, m, c]; k, v [b, slots*m, c]; bias from per-clip valid slots
    (tests/test_torch_long.py's cases)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ok = np.zeros((b, slots), bool)
    for i, n in enumerate(valid):
        ok[i, slots - n:] = True
    bias = np.where(np.repeat(ok, m, axis=1), 0.0, -1e9).astype(np.float32)
    return 2 * f(b, m, c), f(b, slots * m, c), f(b, slots * m, c), bias, ok


@pytest.mark.parametrize("b,m,slots,c,valid", [
    (2, 16, 3, 32, (1, 3)), (1, 24, 5, 64, (2,)), (3, 8, 2, 128, (2, 1, 0))])
def test_memory_attention_bf16_and_vjp_match_pallas(b, m, slots, c, valid):
    """bf16 q, fp32 k, v and bias (slots partly and wholly valid, one clip
    with every slot empty): out fp32, dq bf16, dk and dv fp32, as the JAX
    kernel's; measured worst 8e-7 of max|ref| (both round P at the row
    max, their sums run in other orders)."""
    from emip_tpu.ops.pallas.memory_attention import masked_memory_attention

    q, k, v, bias, _ = _read_inputs(b, m, slots, c, valid, 300 + m)
    want, vjp = jax.vjp(lambda q, k, v: masked_memory_attention(q, k, v,
                                                                bias),
                        _jb(q), jnp.asarray(k), jnp.asarray(v))
    cot = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    leaves = [_tb(q).requires_grad_(True), _t(k).requires_grad_(True),
              _t(v).requires_grad_(True)]
    before = dict(K.LAUNCHES)
    got = K.masked_memory_attention(*leaves, _t(bias))
    assert got.grad_fn is not None
    assert _dtype_name(got) == _dtype_name(want) == "float32"
    assert _rel(got, want) <= KERNEL_REL
    plain = K.masked_memory_attention_reference(_tb(q), _t(k), _t(v),
                                                _t(bias))
    assert _rel(plain, want) <= KERNEL_REL
    got.backward(_t(cot))
    assert K.LAUNCHES == before  # the CPU path launches no kernel
    for name, a, w in zip("qkv", leaves, vjp(jnp.asarray(cot))):
        assert _dtype_name(a.grad) == _dtype_name(w), name
        assert _rel(a.grad, w) <= KERNEL_REL, name


def test_memory_attention_takes_only_the_bf16_mix():
    """bf16 q with fp32 k, v and bias is the one mixed call; a bf16 k, v or
    bias, or an fp16 q, is refused on the card's path (checked here
    through the argument check the CUDA path runs first)."""
    from emip_tpu_torch.kernels.memory_attention import _check

    q, k, v, bias, _ = _read_inputs(1, 8, 2, 64, (1,), 3)
    q, k, v, bias = _t(q), _t(k), _t(v), _t(bias)
    _check(q.to(BF16), k, v, bias)
    _check(q, k, v, bias)
    for args in ((q.to(BF16), k.to(BF16), v, bias),
                 (q.to(BF16), k, v.to(BF16), bias),
                 (q.to(BF16), k, v, bias.to(BF16)),
                 (q.half(), k, v, bias)):
        with pytest.raises(TypeError):
            _check(*args)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_memory_read_bf16_matches_jax(impl):
    """``memory_read`` with a bf16 query key and value on the fp32 ring
    against the JAX package's read (einsum chain and Pallas kernel): the
    result in the query value's dtype (bf16); the ring that
    ``MemoryState.push`` fills from bf16 keys and values holds them
    exactly, as the JAX ring does."""
    from emip_tpu.models.ltm import MemoryState as JState
    from emip_tpu.models.ltm import memory_read as jax_read

    b, h, w, c, slots = 2, 3, 4, 16, 3
    rng = np.random.default_rng(7)
    js = JState.zeros(b, slots, h, w, c, c)
    ts = MemoryState.zeros(b, slots, h, w, c, c)
    for _ in range(2):
        k, v = (rng.standard_normal((b, h, w, c)).astype(np.float32)
                for _ in range(2))
        js = js.push(_jb(k), _jb(v))
        ts = ts.push(_tb(k).reshape(b, h * w, c), _tb(v).reshape(b, h * w, c))
        assert ts.keys.dtype == ts.values.dtype == torch.float32
        assert str(js.keys.dtype) == "float32"
        np.testing.assert_array_equal(ts.keys[:, -1].numpy(),
                                      _tb(k).float().reshape(b, h * w, c))
        np.testing.assert_array_equal(
            ts.keys.numpy(), np.asarray(js.keys).reshape(b, slots, h * w, c))
        np.testing.assert_array_equal(
            ts.values.numpy(),
            np.asarray(js.values).reshape(b, slots, h * w, c))
    qk, qv = (rng.standard_normal((b, h, w, c)).astype(np.float32)
              for _ in range(2))
    want = jax_read(js, _jb(qk), _jb(qv), impl=impl)
    got = memory_read(ts, _tb(qk).permute(0, 3, 1, 2),
                      _tb(qv).permute(0, 3, 1, 2))
    assert got.shape == (b, 2 * c, h, w)
    assert _dtype_name(got) == _dtype_name(want) == "bfloat16"
    assert _rel(got.permute(0, 2, 3, 1), want) <= KERNEL_REL


# ------------------------------------------------------- kernels G, H


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


def _windows(rng, shifted, c=64):
    """bf16-rounded x, t [2, 4, 16, c] and the shift mask of an 8 x 8 map
    (windows of 16 tokens)."""
    from emip_tpu.ops.window import shifted_window_mask

    x = rng.standard_normal((2, 4, 16, c)).astype(np.float32)
    t = rng.standard_normal((2, 4, 16, c)).astype(np.float32)
    mask = np.asarray(shifted_window_mask(8, 8, 2)) if shifted else None
    return x, t, mask


def _port_params(p):
    return {k: _t(v.T if v.ndim == 2 else v) for k, v in p.items()}


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_layer_bf16_matches_pallas(shifted, add_residual):
    """G on bf16 windows with fp32 parameters: bf16 out; measured worst
    one bf16 ulp of an element near max|ref|."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_layer,
    )

    rng = np.random.default_rng(60 + 2 * shifted + add_residual)
    x, t, mask = _windows(rng, shifted)
    p = _layer_params(rng, 64)
    keys = ("wq", "wk", "wv", "wm", "s1", "b1")
    want = fused_window_attention_layer(
        _jb(x), _jb(t), *(p[k] for k in keys),
        None if mask is None else jnp.asarray(mask),
        add_residual=add_residual)
    got = K.fused_window_attention_layer(
        _tb(x), _tb(t), _port_params(p), None if mask is None else _t(mask),
        add_residual)
    assert _dtype_name(got) == _dtype_name(want) == "bfloat16"
    assert _rel(got, want) <= KERNEL_REL


@pytest.mark.parametrize("shifted", [False, True])
def test_window_ffn_layer_bf16_matches_pallas(shifted):
    """H on bf16 windows with fp32 parameters: the fp32 layer on the
    upcast inputs, bf16 out."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_ffn_layer,
    )

    rng = np.random.default_rng(70 + shifted)
    x, t, mask = _windows(rng, shifted)
    p = _layer_params(rng, 64, 128)
    keys = ("wq", "wk", "wv", "wm", "s1", "b1", "w0", "w2", "s2", "b2")
    want = fused_window_attention_ffn_layer(
        _jb(x), _jb(t), *(p[k] for k in keys),
        None if mask is None else jnp.asarray(mask))
    got = K.fused_window_attention_ffn_layer(
        _tb(x), _tb(t), _port_params(p), None if mask is None else _t(mask))
    assert _dtype_name(got) == _dtype_name(want) == "bfloat16"
    assert _rel(got, want) <= KERNEL_REL


@pytest.mark.parametrize("layer", ["G", "H"])
def test_window_layers_bf16_backward_is_refused(layer):
    """G and H have their bf16 backward (the name is from when it was
    refused): without a gradient the bf16 forward keeps no graph; with one,
    differentiating it returns gx and gt in bf16 and the parameter grads in
    fp32, the fp32 VJP of the layer at the upcast inputs rounded once."""
    from emip_tpu_torch.kernels import _common as cm

    rng = np.random.default_rng(80)
    x, t, mask = _windows(rng, True)
    p = _port_params(_layer_params(rng, 64, 128 if layer == "H" else None))
    fn = (K.fused_window_attention_layer if layer == "G"
          else K.fused_window_attention_ffn_layer)
    with torch.no_grad():
        assert fn(_tb(x), _tb(t), p, _t(mask)).grad_fn is None
    leaves = [_tb(x).requires_grad_(True), _tb(t).requires_grad_(True)]
    params = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = fn(*leaves, params, _t(mask))
    assert out.grad_fn is not None and out.dtype == BF16
    cot = _tb(rng.standard_normal(out.shape))
    names = list(params)
    grads = torch.autograd.grad(out, leaves + list(params.values()), cot)
    assert [g.dtype for g in grads] == [BF16, BF16] + [torch.float32] * len(
        names)

    def plain(x, t, *ps):
        return fn(x, t, dict(zip(names, ps)), _t(mask))

    want = cm.plain_vjp_fp32(plain, [a.detach() for a in leaves]
                             + [v.detach() for v in params.values()],
                             [True] * (2 + len(names)), cot)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


# ----------------------------------------------------- the long model


@pytest.fixture(scope="module")
def long_models():
    """The tiny EMIPLong of both packages in fp32 and bf16 on one set of
    seeded variables."""
    jm32 = th.jax_tiny_long()
    jm16 = th.jax_tiny_long(dtype=jnp.bfloat16)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm32, img, img, jm32.init_memory(1),
                                    seed=43, train=False)
    sd = state_dict_from_flax_long(variables, th.DEPTHS, th.NUM_LAYERS)
    out = dict(jax32=jm32, jax16=jm16, variables=variables)
    for name, dtype in (("port32", torch.float32), ("port16", BF16)):
        model = th.torch_tiny_long(dtype=dtype)
        model.load_state_dict(sd, strict=True)
        out[name] = model
    return out


def _frames(n, batch=2, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, th.SIZE, th.SIZE, 3)).astype(
        np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def long_steps(long_models):
    """Three chained ``step`` calls of each model (and the port's
    ``step_cached`` beside its ``step``): masks, short masks and rings."""
    m = long_models
    f = _frames(4)
    out = {}
    for name in ("jax32", "jax16"):
        jm = m[name]
        step = jax.jit(lambda v, a, b, s, jm=jm: jm.apply(v, a, b, s, False))
        mem, runs = jm.init_memory(2), []
        for t in range(1, 4):
            mask, short, mem = step(m["variables"], f[t - 1], f[t], mem)
            runs.append(dict(mask=mask, short=short, keys=mem.keys,
                             values=mem.values))
        out[name] = runs
    for name in ("port32", "port16"):
        model = m[name]
        mem, cmem, runs = model.init_memory(2), model.init_memory(2), []
        with torch.no_grad():
            enc = model.encode_frame(th.nchw(f[0]))
            for t in range(1, 4):
                mask, short, mem = model.step(th.nchw(f[t - 1]),
                                              th.nchw(f[t]), mem)
                cmask, enc, cmem = model.step_cached(enc, th.nchw(f[t]), cmem)
                b, s, _, c = mem.keys.shape
                runs.append(dict(
                    mask=mask.permute(0, 2, 3, 1),
                    short=short.permute(0, 2, 3, 1),
                    keys=mem.keys.reshape(b, s, H8, H8, c),
                    values=mem.values.reshape(b, s, H8, H8, c),
                    cached_mask=cmask, cached_keys=cmem.keys,
                    uncached_keys=mem.keys, dtype=mask.dtype,
                    ring_dtype=mem.keys.dtype))
        out[name] = runs
    return out


@pytest.mark.parametrize("output", ["mask", "short", "keys", "values"])
def test_long_steps_bf16_within_jax_band(long_steps, output):
    """Each of three chained steps: the long mask, the short mask of the
    previous frame and the ring after the step (its keys and values) of the
    port's bf16 model within twice JAX's bf16-vs-fp32 gap of JAX's bf16
    model; the masks fp32 and the ring fp32, as JAX's."""
    s = long_steps
    for t in range(3):
        got = s["port16"][t]
        assert got["dtype"] == torch.float32
        assert got["ring_dtype"] == torch.float32
        assert str(s["jax16"][t]["keys"].dtype) == "float32"
        print(output, t, _band(got[output], s["jax16"][t][output],
                               s["jax32"][t][output],
                               s["port32"][t][output]))


def test_long_step_cached_bf16_is_step(long_steps):
    """``step_cached`` with the carried encoding is the same bf16
    arithmetic as ``step``."""
    for run in long_steps["port16"]:
        torch.testing.assert_close(run["cached_mask"].permute(0, 2, 3, 1),
                                   run["mask"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(run["cached_keys"], run["uncached_keys"],
                                   rtol=1e-5, atol=1e-5)


def test_scan_video_bf16_within_jax_band(long_models):
    """A 3-frame clip through ``scan_video``: frame 0 from the short model,
    frames 1 and 2 from the long head, within JAX's band."""
    m = long_models
    f = np.stack(_frames(3, batch=1, seed=13), axis=1)
    want = {name: jax.jit(lambda v, x, jm=m[name]: jm.apply(
        v, x, method=jm.scan_video))(m["variables"], f)
        for name in ("jax32", "jax16")}
    got = {}
    for name in ("port32", "port16"):
        with torch.no_grad():
            got[name] = m[name].scan_video(
                torch.from_numpy(f).permute(0, 1, 4, 2, 3)).permute(
                    0, 1, 3, 4, 2)
    assert got["port16"].dtype == torch.float32
    print(_band(got["port16"], want["jax16"], want["jax32"], got["port32"]))


# ------------------------------------------------------- the train step


def _capturing(tx):
    """``tx`` after a transformation that keeps each step's raw grads in
    its state (the first element of the optimizer state)."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


@pytest.fixture(scope="module")
def long_train_runs(long_models):
    """STEPS per-frame long train steps (clamp + AdamW at STEP_LR) of each
    model on one clip of 2, from an empty ring: each step's loss and the
    first step's grads of the trainable leaves (the port's before its
    optimizer clamps them)."""
    from emip_tpu.train.long import make_long_train_step
    from emip_tpu.train.state import (
        SHORT_TERM_FREEZE,
        TrainState,
        build_optimizer,
        merge_params,
    )
    from emip_tpu_torch.train.long import CachedStep, long_train_step
    from emip_tpu_torch.train.state import build_long_optimizer

    m = long_models
    f = _frames(STEPS + 1, seed=17)
    rng = np.random.default_rng(18)
    gts = [(rng.uniform(size=(2, th.SIZE, th.SIZE, 1)) > 0.5).astype(
        np.float32) for _ in range(STEPS + 1)]
    variables = m["variables"]
    out = {}
    tx = _capturing(build_optimizer(learning_rate=STEP_LR, weight_decay=1e-7,
                                    clip_value=0.5))
    for name in ("jax32", "jax16"):
        jm = m[name]
        state = TrainState.create(variables, tx, SHORT_TERM_FREEZE)
        step = make_long_train_step(jm, tx, donate=False)
        mem, losses, grads = jm.init_memory(2), [], None
        for t in range(1, STEPS + 1):
            state, mem, metrics = step(state, mem, f[t - 1], f[t], gts[t])
            losses.append(float(metrics["loss"]))
            if grads is None:
                grads = state.opt_state[0]
        zeros = jax.tree_util.tree_map(np.zeros_like, state.frozen)
        full = merge_params(jax.tree_util.tree_map(np.asarray, grads), zeros)
        out[name] = dict(losses=losses, grads=state_dict_from_flax_long(
            {"params": full, "batch_stats": variables["batch_stats"]},
            th.DEPTHS, th.NUM_LAYERS))

    for name in ("port32", "port16"):
        model = copy.deepcopy(m[name])
        opt = build_long_optimizer(model, STEP_LR, 1e-7, 0.5)
        short0 = {k: v.clone() for k, v in model.short_term.state_dict().items()}
        trainable0 = {n: p.detach().clone()
                      for n, p in model.named_parameters() if p.requires_grad}
        grads = {}
        clamp_and_step = opt.step

        def step(closure=None, model=model, grads=grads,
                 clamp_and_step=clamp_and_step):
            if not grads:  # the first step's grads, before the clamp
                grads.update({n: p.grad.clone()
                              for n, p in model.named_parameters()
                              if p.requires_grad})
            return clamp_and_step(closure)

        opt.step = step
        losses = []
        mem = model.init_memory(2)
        enc = model.encode_frame(th.nchw(f[0]))
        for t in range(1, STEPS + 1):
            metrics, enc, mem = long_train_step(CachedStep(model), opt, enc,
                                                th.nchw(f[t]),
                                                th.nchw(gts[t]), mem)
            losses.append(float(metrics["loss"]))
        out[name] = dict(
            losses=losses, grads=grads, model=model,
            short_kept=all(torch.equal(v, short0[k]) for k, v in
                           model.short_term.state_dict().items()),
            moved=all(not torch.equal(p.detach(), trainable0[n])
                      for n, p in model.named_parameters()
                      if p.requires_grad),
            ring_dtype=mem.keys.dtype)
    return out


def test_bf16_long_train_step_within_jax_band(long_train_runs):
    """The first step: the port's bf16 loss within twice JAX's
    bf16-vs-fp32 loss gap of JAX's bf16 loss, and every trainable leaf's
    grad taken together (through kernel F's bf16 backward) within twice
    JAX's gap (max and mean), the port's own gap at least a quarter of
    JAX's; the short-term net bit-identical, every trainable leaf moved,
    fp32 parameters and ring."""
    r = long_train_runs
    model = r["port16"]["model"]
    names = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    assert names and not any(n.startswith("short_term.") for n in names)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert r["port16"]["short_kept"] and r["port16"]["moved"]
    assert r["port16"]["ring_dtype"] == torch.float32
    loss = {k: r[k]["losses"][0] for k in ("jax32", "jax16", "port32",
                                           "port16")}
    gap = abs(loss["jax16"] - loss["jax32"])
    assert gap > 0 and abs(loss["port16"] - loss["jax16"]) <= 2 * gap, loss
    vec = {k: np.concatenate([_np(r[k]["grads"][n]).ravel() for n in names])
           for k in ("jax32", "jax16", "port32", "port16")}
    print(_band(vec["port16"], vec["jax16"], vec["jax32"], vec["port32"]))


def test_bf16_long_three_step_ab_within_jax_band(long_train_runs):
    """The A/B protocol of PARITY.md over STEPS per-frame steps from
    identical weights on identical frames: max |delta loss| of port bf16
    against JAX bf16 at most twice that of JAX bf16 against JAX fp32."""
    la = np.asarray(long_train_runs["port16"]["losses"])
    lj = np.asarray(long_train_runs["jax16"]["losses"])
    l32 = np.asarray(long_train_runs["jax32"]["losses"])
    assert la.shape == lj.shape == (STEPS,) and np.isfinite(la).all()
    band = np.abs(lj - l32).max()
    assert band > 0
    assert np.abs(la - lj).max() <= 2 * band, (la, lj, l32)


# ------------------------------------------------- 512^2: G and H in bf16


@pytest.fixture(scope="module")
def layered_outputs():
    """The tiny EMIPShort of both packages in fp32 and bf16 with the block
    switch at 8 tokens, so that its 16-token windows take G and H (the JAX
    side under EMIP_FUSED_BLOCK_MAX_T, read when it traces): mask and flow
    of one pair."""
    from emip_tpu.models.emip_short import EMIPShort as JaxEMIPShort

    jm32, cfg = th.jax_tiny_short(drop_path_rate=0.0)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm32, img, img, seed=47)
    rng = np.random.default_rng(48)
    a, b = (rng.standard_normal((2, th.SIZE, th.SIZE, 3)).astype(np.float32)
            for _ in range(2))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMIP_FUSED_BLOCK_MAX_T", "8")
        for name, jm in (("jax32", jm32), ("jax16", JaxEMIPShort(
                config=cfg, dtype=jnp.bfloat16))):
            mask, fw, _ = jax.jit(jm.apply)(variables, a, b)
            out[name] = dict(mask=mask, flow=fw[-1])
    from emip_tpu_torch.convert import state_dict_from_flax

    sd = state_dict_from_flax(variables, th.DEPTHS, th.NUM_LAYERS)
    for name, dtype in (("port32", torch.float32), ("port16", BF16)):
        model = th.torch_tiny_short(drop_path_rate=0.0, dtype=dtype,
                                    fused_block_max_t=8)
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            mask, fw, _ = model(th.nchw(a), th.nchw(b))
        out[name] = dict(mask=mask.permute(0, 2, 3, 1),
                         flow=fw[-1].permute(0, 2, 3, 1))
    return out


@pytest.mark.parametrize("output", ["mask", "flow"])
def test_short_model_bf16_layers_within_jax_band(layered_outputs, output):
    """G and H in bf16 through the whole tiny short model (both packages
    at ``fused_block_max_t`` 8): the port's bf16 mask and flow within
    twice JAX's bf16-vs-fp32 gap of JAX's bf16 model, fp32 out."""
    o = layered_outputs
    assert o["port16"][output].dtype == torch.float32
    print(_band(o["port16"][output], o["jax16"][output], o["jax32"][output],
                o["port32"][output]))


def test_bf16_builds_refuse_only_missing_kernels(long_models):
    """Every bf16 build runs (the name is from when some were refused; none
    is now): at windows above ``fused_block_max_t`` a bf16 EMIPShort
    builds, and a bf16 EMIPLong with read-corr matching builds and runs
    kernel I on the fp32 correlation volume, as the JAX package's: its
    long mask and the previous frame's short mask after one step from an
    empty ring lie within twice JAX's bf16-vs-fp32 gap of JAX's bf16
    read-corr model (the JAX side under EMIP_GLOBAL_MATCH_QK=0, read when
    it traces)."""
    from emip_tpu_torch.dtypes import compute_dtype
    from emip_tpu_torch.models.emip_short import EMIPShort

    cfg = th.torch_tiny_short(fused_block_max_t=8).config
    assert compute_dtype(EMIPShort(cfg, dtype=BF16)) == BF16
    m = long_models
    f = _frames(2, seed=21)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMIP_GLOBAL_MATCH_QK", "0")
        for name in ("jax32", "jax16"):
            jm = m[name]
            mask, short, _ = jax.jit(
                lambda v, a, b, s, jm=jm: jm.apply(v, a, b, s, False))(
                    m["variables"], f[0], f[1], jm.init_memory(2))
            want[name] = dict(mask=mask, short=short)
    sd = m["port32"].state_dict()
    got = {}
    for name, dtype in (("port32", torch.float32), ("port16", BF16)):
        model = th.torch_tiny_long(dtype=dtype, global_match_qk_fused=False)
        model.load_state_dict(sd, strict=True)
        before = dict(K.LAUNCHES)
        with torch.no_grad():
            mask, short, _ = model.step(th.nchw(f[0]), th.nchw(f[1]),
                                        model.init_memory(2))
        assert K.LAUNCHES == before  # the CPU runs the plain versions
        got[name] = dict(mask=mask.permute(0, 2, 3, 1),
                         short=short.permute(0, 2, 3, 1))
    assert got["port16"]["mask"].dtype == torch.float32
    for output in ("mask", "short"):
        print(output, _band(got["port16"][output], want["jax16"][output],
                            want["jax32"][output], got["port32"][output]))


# ------------------------------------------------------- entry points


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    from emip_tpu_torch.data import make_synthetic_video_root

    return make_synthetic_video_root(
        str(tmp_path_factory.mktemp("bf16_long") / "data"), num_videos=2,
        frames_per_video=3, size=(56, 64))


def test_long_entry_points_honour_bfloat16(tmp_path, monkeypatch,
                                           synthetic_root):
    """``train_long`` and ``test_long`` on a tiny YAML that says bfloat16
    build a bf16 EMIPLong (a spy on its constructor), keep a fp32 ring,
    write fp32 checkpoints (model and AdamW state) and one PNG per
    frame."""
    import emip_tpu_torch.train.long as long_mod
    from emip_tpu_torch.test_long import main as test_long_main
    from emip_tpu_torch.train_long import main as train_long_main

    built = []
    real = long_mod.EMIPLong

    def spy(*args, **kwargs):
        model = real(*args, **kwargs)
        built.append(kwargs.get("dtype"))
        return model

    monkeypatch.setattr(long_mod, "EMIPLong", spy)
    save = str(tmp_path / "run")
    cfg = th.tiny_yaml(tmp_path / "c.yaml", synthetic_root, save,
                       compute_dtype="bfloat16", memory_size=2)
    summary = train_long_main(["--config", cfg, "--max_videos_per_epoch", "2",
                               "--device", "cpu"])
    assert built == [BF16]
    assert summary["steps"] == 4 and 0.0 <= summary["best_sm"] <= 1.0
    ckpt = torch.load(os.path.join(save, "ckpt_long", "ckpt.pt"))
    assert all(v.dtype == torch.float32 for v in ckpt["model"].values()
               if v.is_floating_point())
    for st in ckpt["optimizer"]["state"].values():
        assert all(v.dtype == torch.float32 for v in st.values()
                   if torch.is_tensor(v) and v.is_floating_point())
    out = tmp_path / "pred"
    frames = test_long_main(["--config", cfg, "--ckpt",
                             os.path.join(save, "ckpt_long"), "--save_path",
                             str(out), "--data", f"MoCA_test={synthetic_root}",
                             "--device", "cpu"])
    assert built == [BF16, BF16]
    assert frames == 6 and len(list(out.rglob("*.png"))) == 6


def test_short_trainer_refuses_bf16_above_block_switch(tmp_path,
                                                       synthetic_root):
    """The short trainer trains a bf16 model at windows above
    ``fused_block_max_t`` (the name is from when it refused them): on the
    CPU through G's and H's bf16 backwards, one step, a finite validation
    MAE, an fp32 checkpoint."""
    import yaml

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.train.loops import train_short

    save = str(tmp_path / "run")
    cfg = th.tiny_yaml(tmp_path / "c.yaml", synthetic_root, save,
                       compute_dtype="bfloat16")
    raw = yaml.safe_load(open(cfg))
    raw["model"]["args"]["GMFlow"]["fused_block_max_t"] = 8
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    model, summary = train_short(load_config(cfg), max_steps_per_epoch=1,
                                 device="cpu")
    assert model.GMFlow.transformer.layers[0].fused_block_max_t == 8
    assert summary["steps"] == 1 and np.isfinite(summary["best_mae"])
    state = torch.load(os.path.join(save, "ckpt", "ckpt.pt"))["model"]
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in state.values())


# --------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_bf16_long_kernels_match_plain_versions():
    """F's bf16 forward and backward and G's and H's bf16 forwards on the
    card against their plain bf16 versions (1e-2 of max|ref|), the same
    bits on a second call, their own launch counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from emip_tpu_torch.kernels.memory_attention import (
        masked_memory_attention_bwd_reference,
    )
    from emip_tpu_torch.ops.window import shifted_window_mask

    g = torch.Generator().manual_seed(11)

    def r(*s, scale=1.0, dtype=torch.float32):
        return (torch.randn(*s, generator=g) * scale).to(dtype).cuda()

    q, k, v = r(2, 1936, 128, dtype=BF16), r(2, 9680, 128), r(2, 9680, 128)
    bias = torch.zeros(2, 9680, device="cuda")
    bias[1, :3872] = -1e9
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    before = dict(K.LAUNCHES)
    out = K.masked_memory_attention(q, k, v, bias)
    want = K.masked_memory_attention_reference(q.detach(), k.detach(),
                                               v.detach(), bias)
    assert out.dtype == torch.float32
    assert (out - want).abs().max() <= 1e-2 * want.abs().max()
    cot = r(*out.shape)
    grads = torch.autograd.grad(out, (q, k, v), cot)
    ref = masked_memory_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), bias, out.detach(), cot)
    for got, w in zip(grads, ref):
        assert got.dtype == w.dtype
        assert (got.float() - w.float()).abs().max() <= (
            1e-2 * w.float().abs().max())
    assert K.LAUNCHES["memory_attention_bf16"] == before[
        "memory_attention_bf16"] + 1
    assert K.LAUNCHES["memory_attention_bwd_bf16"] == before[
        "memory_attention_bwd_bf16"] + 1
    assert K.LAUNCHES["memory_attention"] == before["memory_attention"]

    def params(c, f):
        w = lambda *s: r(*s, scale=s[1] ** -0.5)  # noqa: E731
        p = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
                 s1=r(c, scale=0.1) + 1, b1=r(c, scale=0.05),
                 w0=w(f, 2 * c), w2=w(c, f))
        p.update(s2=p["s1"], b2=p["b1"])
        return p

    p = params(128, 1024)
    mask = shifted_window_mask(64, 64, 2, device="cuda")
    x, t = r(2, 4, 1024, 128, dtype=BF16), r(2, 4, 1024, 128, dtype=BF16)
    with torch.no_grad():
        for name, fn, ref in (
                ("window_attention_layer_bf16",
                 K.fused_window_attention_layer,
                 K.fused_window_attention_layer_reference),
                ("window_attention_ffn_layer_bf16",
                 K.fused_window_attention_ffn_layer,
                 K.fused_window_attention_ffn_layer_reference)):
            before = K.LAUNCHES[name]
            got = fn(x, t, p, mask)
            assert torch.equal(fn(x, t, p, mask), got), name
            assert K.LAUNCHES[name] == before + 2, name
            want = ref(x, t, p, mask)
            assert got.dtype == want.dtype == BF16, name
            err = (got.float() - want.float()).abs().max()
            assert err <= 1e-2 * want.float().abs().max(), (name, err)
