"""The port's long-term (LTM) model against the JAX package, on the CPU.

Kernel F's plain version against the public Pallas function in interpret
mode (as tests/test_pallas_kernels.py runs it) and against the JAX
package's einsum read, forward and VJP. Then the memory ring, the LTM
heads, ``EMIPLong.step`` / ``step_cached`` over three chained frames, the
weights round trip, one per-frame train step, and the host code (clip
loader, streaming inference, both entry points), all at the tiny size of
tests/torch_helpers.py (b0 widths, PVT depths (1, 1, 1, 1), 64^2 frames,
64-d flow features, 2 transformer blocks, a 3-slot memory) with identical
weights through ``state_dict_from_flax_long``.

Tolerances: kernel F rtol / atol 1e-4 as for kernels A-D
(tests/test_torch_kernels.py); model outputs those of
tests/test_torch_slice.py (rtol 1e-3, atol 1e-2 on mask logits); grads by
max|got - want| / max|want| ("relmax") with the scale floor of
tests/test_grad_parity.py, each stated beside its test.
"""

import copy
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests import torch_helpers as th

from emip_tpu_torch import kernels as K
from emip_tpu_torch.convert import state_dict_from_flax_long
from emip_tpu_torch.models.ltm import MemoryState, memory_read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
VJP_REL = 1e-4   # measured <= 2e-6
MASK_TOL = dict(rtol=1e-3, atol=1e-2)
H8 = th.SIZE // 8


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, copy=True)).requires_grad_(grad)


def _relmax(got, want, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-30)


# ------------------------------------------------------------ kernel F


def _read_inputs(b, m, slots, c, valid, seed):
    """q [b, m, c]; k, v [b, slots*m, c]; bias from per-clip valid slots."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ok = np.zeros((b, slots), bool)
    for i, n in enumerate(valid):
        ok[i, slots - n:] = True
    bias = np.where(np.repeat(ok, m, axis=1), 0.0, -1e9).astype(np.float32)
    return 2 * f(b, m, c), f(b, slots * m, c), f(b, slots * m, c), bias, ok


@pytest.mark.parametrize("b,m,slots,c,valid", [
    (2, 16, 3, 32, (1, 3)), (1, 24, 5, 64, (2,)), (3, 8, 2, 128, (2, 1, 0))])
def test_memory_attention_and_vjp_match_pallas(b, m, slots, c, valid):
    """B > 1, M != N, partial validity (and one clip with every slot
    empty: the plain mean of the values)."""
    from emip_tpu.ops.pallas.memory_attention import masked_memory_attention

    q, k, v, bias, _ = _read_inputs(b, m, slots, c, valid, 300 + m)
    want, vjp = jax.vjp(lambda q, k, v: masked_memory_attention(q, k, v, bias),
                        q, k, v)
    cot = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    before = dict(K.LAUNCHES)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = K.masked_memory_attention(tq, tk, tv, _t(bias))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        K.masked_memory_attention_reference(_t(q), _t(k), _t(v),
                                            _t(bias)).numpy(),
        np.asarray(want), **TOL)
    got.backward(_t(cot))
    for g, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(cot))):
        assert _relmax(g, w) <= VJP_REL
    assert K.LAUNCHES == before  # the CPU path launches no kernel


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("valid,splits", [((0, 0), 1), ((1, 1), 1),
                                          ((3, 3), 1), ((0, 2), 3)])
def test_memory_attention_bwd_tiled_walk(valid, splits, product):
    """The algorithm of the CUDA backward of the memory read (row max and
    row sum from the forward, query-tiled dq over key tiles of 32,
    key-tiled dk / dv on transposed tiles, 128 resident rows, ragged last
    tiles at M = 100, N = 300, the streamed side in three chunks) with no,
    one and every slot written, against torch.autograd.grad of the plain
    version and the JAX VJP (Pallas in interpret mode). With every slot
    empty the row max is -1e9 and the weights are uniform. relmax <= 1e-5:
    the same fp32 formula summed tile by tile (measured <= 3e-6)."""
    from emip_tpu.ops.pallas.memory_attention import masked_memory_attention
    from emip_tpu_torch.kernels import tf32

    b, m, slots, c = 2, 100, 3, 128
    q, k, v, bias, _ = _read_inputs(b, m, slots, c, valid, 500 + sum(valid))
    want_out, vjp = jax.vjp(
        lambda q, k, v: masked_memory_attention(q, k, v, bias), q, k, v)
    cot = np.random.default_rng(3).standard_normal(want_out.shape).astype(
        np.float32)
    want_jax = vjp(jnp.asarray(cot))
    leaves = [_t(a, True) for a in (q, k, v)]
    out = K.masked_memory_attention_reference(*leaves, _t(bias))
    want = torch.autograd.grad(out, leaves, _t(cot))
    row_max, row_sum = tf32.attention_row_stats(_t(q), _t(k), _t(bias))
    if 0 in valid:
        assert float(row_max[valid.index(0)].max()) == -1e9
    walk = lambda which: tf32.attention_bwd_tiled(  # noqa: E731
        _t(q), _t(k), _t(v), _t(bias), out.detach(), row_max, row_sum,
        _t(cot), which=which, res_rows=128, stream_rows=32, splits=splits,
        matmul=tf32.matmul_3xtf32 if product == "3xtf32" else torch.matmul)
    got = walk((0, 1, 2))
    for name, a, w, wj in zip("qkv", got, want, want_jax):
        assert _relmax(a, w) <= 1e-5, name
        assert _relmax(a, wj) <= 1e-5, name
    dq, dk, dv = walk((0,))  # the long train step without a fresh slot
    assert dk is None and dv is None and torch.equal(dq, got[0])


@pytest.mark.parametrize("product", ["fp32", "3xtf32"])
@pytest.mark.parametrize("valid,c,splits", [((0, 0), 128, 1), ((1, 1), 128, 1),
                                            ((3, 3), 128, 1), ((0, 2), 128, 4),
                                            ((1, 3), 64, 2)])
def test_memory_attention_fwd_tiled_walk(valid, c, splits, product):
    """The algorithm of the CUDA forward of the memory read (key tiles of
    32 with the bias added before the running max, ragged last tiles at
    M = 100, N = 300, the keys split in chunks merged in order; width 128 and pvt_v2_b0's 64) with no, one and every
    slot written, against the plain version and the JAX Pallas kernel in
    interpret mode: within 4e-6 of max|ref| (measured <= 2.0e-6, where the
    plain version and the JAX kernel differ from each other by up to
    1.9e-6: sums of ~300 terms in fp32, in other orders). With every
    slot empty the row max is -1e9 and the result the plain mean of the
    values. The kept row max and sum equal attention_row_stats' to fp32
    rounding and give the tiled backward the grads of
    torch.autograd.grad."""
    from emip_tpu.ops.pallas.memory_attention import masked_memory_attention
    from emip_tpu_torch.kernels import tf32

    b, m, slots = 2, 100, 3
    q, k, v, bias, _ = _read_inputs(b, m, slots, c, valid, 700 + sum(valid))
    cot = np.random.default_rng(4).standard_normal((b, m, c)).astype(
        np.float32)
    want_jax = np.asarray(masked_memory_attention(q, k, v, bias))
    want = K.masked_memory_attention_reference(_t(q), _t(k), _t(v),
                                               _t(bias))
    matmul = tf32.matmul_3xtf32 if product == "3xtf32" else torch.matmul
    got, row_max, row_sum = tf32.attention_fwd_tiled(
        _t(q), _t(k), _t(v), _t(bias), splits=splits, matmul=matmul,
        keep_stats=True)
    assert _relmax(got, want) <= 4e-6
    assert _relmax(got, want_jax) <= 4e-6
    if 0 in valid:
        i = valid.index(0)
        assert float(row_max[i].max()) == -1e9
        torch.testing.assert_close(
            got[i], _t(v)[i].mean(0).expand(m, c), rtol=0, atol=1e-6)
    ref_max, ref_sum = tf32.attention_row_stats(_t(q), _t(k), _t(bias))
    torch.testing.assert_close(row_max, ref_max, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(row_sum, ref_sum, rtol=1e-5, atol=0)
    leaves = [_t(a, True) for a in (q, k, v)]
    grads = torch.autograd.grad(
        K.masked_memory_attention_reference(*leaves, _t(bias)), leaves,
        _t(cot))
    walk = tf32.attention_bwd_tiled(_t(q), _t(k), _t(v), _t(bias), got,
                                    row_max, row_sum, _t(cot), res_rows=128,
                                    stream_rows=32)
    for name, a, w in zip("qkv", walk, grads):
        assert _relmax(a, w) <= 1e-5, name


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_memory_read_and_vjp_match_jax(impl):
    """``memory_read`` on the token-major ring against the JAX package's
    read (einsum chain and Pallas kernel) on its [B, T, H, W, C] ring."""
    from emip_tpu.models.ltm import MemoryState as JState
    from emip_tpu.models.ltm import memory_read as jax_read

    b, h, w, c, slots = 2, 3, 4, 16, 3
    q, k, v, _, ok = _read_inputs(b, h * w, slots, c, (2, 1), 7)
    qv = np.random.default_rng(8).standard_normal((b, h, w, c)).astype(
        np.float32)

    def jread(q, k, v):
        st = JState(k.reshape(b, slots, h, w, c), v.reshape(b, slots, h, w, c),
                    jnp.asarray(ok))
        return jax_read(st, q.reshape(b, h, w, c), qv, impl=impl)

    want, vjp = jax.vjp(jread, q, k, v)
    cot = np.random.default_rng(9).standard_normal(want.shape).astype(
        np.float32)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    state = MemoryState(tk.reshape(b, slots, h * w, c),
                        tv.reshape(b, slots, h * w, c), _t(ok))
    got = memory_read(state, tq.reshape(b, h, w, c).permute(0, 3, 1, 2),
                      th.nchw(qv))
    assert got.shape == (b, 2 * c, h, w)
    np.testing.assert_allclose(th.nhwc(got), np.asarray(want), **TOL)
    got.backward(th.nchw(cot))
    for g, w_ in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(cot))):
        assert _relmax(g, w_) <= VJP_REL


def test_memory_state_push_ring_order_and_validity():
    from emip_tpu.models.ltm import MemoryState as JState

    rng = np.random.default_rng(2)
    js = JState.zeros(2, 3, 2, 2, 4, 4)
    ts = MemoryState.zeros(2, 3, 2, 2, 4, 4)
    assert ts.keys.shape == (2, 3, 4, 4) and not ts.valid.any()
    for _ in range(4):  # one more push than slots: the oldest is evicted
        k = rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
        v = rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
        js = js.push(k, v)
        old = ts
        ts = ts.push(_t(k).reshape(2, 4, 4), _t(v).reshape(2, 4, 4))
        assert ts.keys is not old.keys  # out of place
        np.testing.assert_array_equal(
            ts.keys.numpy(), np.asarray(js.keys).reshape(2, 3, 4, 4))
        np.testing.assert_array_equal(
            ts.values.numpy(), np.asarray(js.values).reshape(2, 3, 4, 4))
        np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
        np.testing.assert_array_equal(ts.keys[:, -1].numpy(),
                                      k.reshape(2, 4, 4))
    assert ts.valid.all()


# -------------------------------------------------------- the long model


@pytest.fixture(scope="module")
def long_pair():
    """(JAX EMIPLong, variables, port EMIPLong) with identical weights."""
    jm = th.jax_tiny_long()
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    mem = jm.init_memory(1)
    variables = th.random_variables(jm, img, img, mem, seed=41, train=False)
    port = th.torch_tiny_long()
    port.load_state_dict(
        state_dict_from_flax_long(variables, th.DEPTHS, th.NUM_LAYERS),
        strict=True)
    return jm, variables, port


def _frames(n, batch=2, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, th.SIZE, th.SIZE, 3)).astype(
        np.float32) for _ in range(n)]


def _ring(state: MemoryState):
    """The port's ring in the JAX package's [B, T, H, W, C] layout."""
    b, t, _, c = state.keys.shape
    return (state.keys.reshape(b, t, H8, H8, c).numpy(),
            state.values.reshape(b, t, H8, H8, c).numpy(),
            state.valid.numpy())


def test_long_weights_round_trip(long_pair):
    """JAX variables -> port state_dict -> load(strict) -> the JAX
    package's own ``convert_emip_long_state`` -> the same variables."""
    from emip_tpu.convert.torch_import import convert_emip_long_state

    _, variables, port = long_pair
    back = convert_emip_long_state(port.state_dict(), depths=th.DEPTHS,
                                   num_layers=th.NUM_LAYERS)
    for coll in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(variables[coll])
        got = traverse_util.flatten_dict(back[coll])
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=str(k))


def test_ltm_memorize_and_read_match_jax(long_pair):
    jm, variables, port = long_pair
    rng = np.random.default_rng(11)
    feat, prompt, query = (rng.standard_normal((2, H8, H8, th.FDIM)).astype(
        np.float32) for _ in range(3))

    def jax_ltm(mod, feat, prompt, query, state):
        k, v = mod.ltm.memorize(feat, prompt, False)
        return k, v, mod.ltm.read(state.push(k, v), query)

    jk, jv, jread = jm.apply(variables, feat, prompt, query,
                             jm.init_memory(2), method=jax_ltm)
    with torch.no_grad():
        k, v = port.LTM.memorize(th.nchw(feat), th.nchw(prompt))
        read = port.LTM.read(port.init_memory(2).push(k, v), th.nchw(query))
    b = 2
    np.testing.assert_allclose(k.numpy(), np.asarray(jk).reshape(b, -1, th.FDIM),
                               **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv).reshape(b, -1, th.FDIM),
                               **TOL)
    np.testing.assert_allclose(th.nhwc(read), np.asarray(jread), **TOL)


def test_long_step_and_step_cached_match_jax(long_pair):
    """Three chained frames: the long masks, the short mask of the
    previous frame and the memory after each step; ``step_cached`` with
    the carried encoding equals ``step``."""
    jm, variables, port = long_pair
    f = _frames(4)
    jstep = jax.jit(lambda v, a, b, s: jm.apply(v, a, b, s, False))
    jmem, mem, cmem = jm.init_memory(2), port.init_memory(2), port.init_memory(2)
    with torch.no_grad():
        enc = port.encode_frame(th.nchw(f[0]))
        for t in range(1, 4):
            jmask, jshort, jmem = jstep(variables, f[t - 1], f[t], jmem)
            mask, short, mem = port.step(th.nchw(f[t - 1]), th.nchw(f[t]), mem)
            cmask, enc, cmem = port.step_cached(enc, th.nchw(f[t]), cmem)
            assert mask.shape == (2, 1, th.SIZE, th.SIZE)
            np.testing.assert_allclose(th.nhwc(mask), np.asarray(jmask),
                                       **MASK_TOL)
            np.testing.assert_allclose(th.nhwc(short), np.asarray(jshort),
                                       **MASK_TOL)
            keys, values, valid = _ring(mem)
            np.testing.assert_allclose(keys, np.asarray(jmem.keys), rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(values, np.asarray(jmem.values),
                                       rtol=1e-3, atol=1e-3)
            np.testing.assert_array_equal(valid, np.asarray(jmem.valid))
            # the cached path is the same arithmetic
            torch.testing.assert_close(cmask, mask, rtol=1e-5, atol=1e-5)
            for a, b in zip(cmem, mem):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert valid.all() and not mem.keys.requires_grad


def test_scan_video_follows_the_reference_protocol(long_pair):
    """Frame 0 from the short-term mask of (f0, f1), frames 1.. from the
    long head with the memory carried."""
    _, _, port = long_pair
    f = [th.nchw(x) for x in _frames(3, batch=1, seed=13)]
    with torch.no_grad():
        masks = port.scan_video(torch.stack(f, dim=1))
        mem = port.init_memory(1)
        m1, short0, mem = port.step(f[0], f[1], mem)
        m2, _, mem = port.step(f[1], f[2], mem)
    assert masks.shape == (1, 3, 1, th.SIZE, th.SIZE)
    for got, want in zip(masks[0], (short0[0], m1[0], m2[0])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_mode_leaves_short_term_in_eval(long_pair):
    _, _, port = long_pair
    model = copy.deepcopy(port)
    assert model.train() is model
    assert model.training and model.LTM.training and model.decoder.training
    assert not any(m.training for m in model.short_term.modules())
    assert not any(p.requires_grad for p in model.short_term.parameters())
    # a train-mode step leaves every short-term tensor and buffer as it was
    before = {k: v.clone() for k, v in model.short_term.state_dict().items()}
    f = _frames(2)
    mask, _, _ = model.step(th.nchw(f[0]), th.nchw(f[1]), model.init_memory(2))
    mask.sum().backward()
    for k, v in model.short_term.state_dict().items():
        assert torch.equal(v, before[k]), k
    model.eval()
    assert not any(m.training for m in model.modules())


# ------------------------------------------------------- the train step

# one clamp + AdamW step at lr 1e-3: every element within Adam's bound of
# 2 lr, and the share within 1e-3 lr as tests/test_torch_train.py holds the
# short step (measured 99.98% of the 1.3M trainable elements)
STEP_LR = 1e-3
STEP_AGREE_SHARE = 0.995
# head grads through LTM, kernel F's backward, long_dr, the injector, dr1
# and the decoder; measured worst leaf relmax 3.3e-5 with the 1e-6 scale
# floor
HEAD_GRAD_REL = 1e-3


@pytest.fixture(scope="module")
def jax_long_train(long_pair):
    """One JAX per-frame long train step on a memory that already holds a
    frame, and the loss grads of the trainable tree from one forward."""
    from emip_tpu.losses.seg import hybrid_e_loss
    from emip_tpu.train.long import make_long_train_step
    from emip_tpu.train.state import (
        SHORT_TERM_FREEZE,
        TrainState,
        build_optimizer,
        merge_params,
    )

    jm, variables, _ = long_pair
    f = _frames(3, seed=17)
    gt = (np.random.default_rng(18).uniform(size=(2, th.SIZE, th.SIZE, 1))
          > 0.5).astype(np.float32)
    tx = build_optimizer(learning_rate=STEP_LR, weight_decay=1e-7,
                         clip_value=0.5)
    state = TrainState.create(variables, tx, SHORT_TERM_FREEZE)
    _, _, mem = jax.jit(lambda v, a, b, s: jm.apply(v, a, b, s, False))(
        variables, f[0], f[1], jm.init_memory(2))

    @jax.jit
    def loss_and_grads(trainable):
        def fn(tr):
            (mask, _, _), _ = jm.apply(
                {"params": merge_params(tr, state.frozen),
                 "batch_stats": state.batch_stats},
                f[1], f[2], mem, True, mutable=["batch_stats"])
            return hybrid_e_loss(mask, gt)
        return jax.value_and_grad(fn)(trainable)

    loss, grads = loss_and_grads(state.params)
    step = make_long_train_step(jm, tx, donate=False)
    new_state, new_mem, metrics = step(state, mem, f[1], f[2], gt)
    # the same compiled step on two frames more (the three-step A/B)
    extra = _frames(2, seed=19)
    clip = [f[2]] + extra
    ab_state, ab_mem, ab_losses = new_state, new_mem, [float(metrics["loss"])]
    for prev, cur in zip(clip[:-1], clip[1:]):
        ab_state, ab_mem, m = step(ab_state, ab_mem, prev, cur, gt)
        ab_losses.append(float(m["loss"]))
    return dict(state=state, new_state=new_state, new_mem=new_mem,
                metrics=metrics, loss=float(loss), grads=grads,
                frames=f, gt=gt, ab_frames=extra, ab_losses=ab_losses,
                ab_state=ab_state)


def _as_port_keys(long_pair, trainable, frozen, batch_stats):
    from emip_tpu.train.state import merge_params

    full = merge_params(jax.tree_util.tree_map(np.asarray, trainable),
                        jax.tree_util.tree_map(np.asarray, frozen))
    return state_dict_from_flax_long(
        {"params": full,
         "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)},
        th.DEPTHS, th.NUM_LAYERS)


def test_one_long_train_step_matches_jax(long_pair, jax_long_train):
    from emip_tpu_torch.train.long import CachedStep, long_train_step
    from emip_tpu_torch.train.state import build_long_optimizer

    _, variables, port = long_pair
    j = jax_long_train
    f = [th.nchw(x) for x in j["frames"]]
    gt = th.nchw(j["gt"])
    model = copy.deepcopy(port)
    opt = build_long_optimizer(model, STEP_LR, 1e-7, 0.5)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and not any(n.startswith("short_term.")
                                 for n in trainable)
    assert {n.split(".")[0] for n in trainable} == {
        "LTM", "long_dr", "injector1", "decoder", "dr1"}
    with torch.no_grad():
        _, _, mem = model.step(f[0], f[1], model.init_memory(2))
        enc = model.encode_frame(f[1])

    # loss and head grads from one train-mode forward
    probe = copy.deepcopy(model).train()
    mask, _, _ = probe.step_cached(enc, f[2], mem)
    from emip_tpu_torch.losses.seg import hybrid_e_loss

    loss = hybrid_e_loss(mask, gt)
    np.testing.assert_allclose(float(loss.detach()), j["loss"], rtol=1e-5)
    names = sorted(trainable)
    params = dict(probe.named_parameters())
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    zeros = jax.tree_util.tree_map(np.zeros_like, j["state"].frozen)
    want = _as_port_keys(long_pair, j["grads"], zeros,
                         variables["batch_stats"])
    scale = max(float(want[n].abs().max()) for n in names)
    worst = [(_relmax(g, want[n], 1e-6 * scale), n)
             for n, g in zip(names, grads)]
    assert max(worst)[0] <= HEAD_GRAD_REL, sorted(worst)[-5:]

    # the step itself
    bn_inputs = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=n: bn_inputs.__setitem__(
            name, inp[0].shape))
        for n, m in model.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics, enc2, new_mem = long_train_step(CachedStep(model), opt, enc,
                                             f[2], gt, mem)
    for hk in hooks:
        hk.remove()
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j["metrics"]["loss"]), rtol=1e-5)
    new = j["new_state"]
    want = _as_port_keys(long_pair, new.params, new.frozen, new.batch_stats)
    got = model.state_dict()
    # the short-term net: every tensor and buffer bit-identical
    for k, v in got.items():
        if k.startswith("short_term."):
            assert torch.equal(v, before[k]), k
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(),
                                          err_msg=k)
    total = agree = 0
    for n in trainable:
        d = (got[n] - want[n]).abs()
        assert float(d.max()) <= 2 * STEP_LR * (1 + 1e-3), n
        assert not torch.equal(got[n], before[n]), n  # every leaf moved
        total += d.numel()
        agree += int((d <= 1e-3 * STEP_LR).sum())
    assert agree >= STEP_AGREE_SHARE * total, agree / total
    # BatchNorm statistics of the long heads: the running mean and
    # variance as flax's (the biased batch variance)
    heads = [n for n in bn_inputs if not n.startswith("short_term.")]
    assert len(heads) == 13  # fusion 1, long_dr 2, dr1 2, decoder 8
    for name in heads:
        rm, rv = f"{name}.running_mean", f"{name}.running_var"
        np.testing.assert_allclose(got[rm].numpy(), want[rm].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=rm)
        np.testing.assert_allclose(got[rv].numpy(), want[rv].numpy(),
                                   rtol=1e-4, err_msg=rv)
    # the memory that is carried on: the new frame pushed, detached
    keys, values, valid = _ring(new_mem)
    np.testing.assert_allclose(keys, np.asarray(j["new_mem"].keys),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(values, np.asarray(j["new_mem"].values),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(valid, np.asarray(j["new_mem"].valid))
    assert not new_mem.keys.requires_grad
    assert not new_mem.values.requires_grad
    assert set(enc2) == {"fea", "inj"}


# ------------------------------------------------------------ host code


# the fp32 A/B of PARITY.md on the long model: three per-frame clamp +
# AdamW steps at STEP_LR from identical weights along one clip (the first
# is the one-step test's): the losses to AB_LOSS_RTOL, and the long heads'
# BatchNorm statistics after the three steps to AB_STATS_REL of each
# buffer's max|ref|
AB_LOSS_RTOL = 1e-4
AB_STATS_REL = 1e-4


def test_three_long_train_steps_match_jax(long_pair, jax_long_train):
    from emip_tpu_torch.train.long import CachedStep, long_train_step
    from emip_tpu_torch.train.state import build_long_optimizer

    _, _, port = long_pair
    j = jax_long_train
    f = [th.nchw(x) for x in j["frames"] + j["ab_frames"]]
    gt = th.nchw(j["gt"])
    model = copy.deepcopy(port)
    opt = build_long_optimizer(model, STEP_LR, 1e-7, 0.5)
    with torch.no_grad():
        _, _, mem = model.step(f[0], f[1], model.init_memory(2))
        enc = model.encode_frame(f[1])
    losses = []
    for cur in f[2:]:
        metrics, enc, mem = long_train_step(CachedStep(model), opt, enc,
                                            cur, gt, mem)
        losses.append(float(metrics["loss"]))
    want = j["ab_losses"]
    assert len(losses) == len(want) == 3 and np.isfinite(losses).all()
    delta = np.abs(np.asarray(losses) - np.asarray(want))
    assert delta.max() <= AB_LOSS_RTOL * np.abs(want).max(), (losses, want)
    new = j["ab_state"]
    ref = _as_port_keys(long_pair, new.params, new.frozen, new.batch_stats)
    got = model.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))
             and not k.startswith("short_term.")]
    assert stats
    worst = max((float((got[k] - ref[k]).abs().max() / ref[k].abs().max()),
                 k) for k in stats)
    assert worst[0] <= AB_STATS_REL, worst


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    from emip_tpu_torch.data import make_synthetic_video_root

    return make_synthetic_video_root(
        str(tmp_path_factory.mktemp("long") / "data"), num_videos=3,
        frames_per_video=4, size=(56, 64))


def test_clip_loader_order_and_shapes(synthetic_root):
    from emip_tpu.data.pipeline import ClipLoader as JaxClipLoader
    from emip_tpu_torch.data import ClipLoader, scan_clips

    clips = scan_clips(synthetic_root, synthetic_root)
    assert [c.video for c in clips] == ["video_00", "video_01", "video_02"]
    assert clips[0].frame_names == ("00000", "00001", "00002", "00003")
    assert len(clips[0].gts) == 4
    ours = ClipLoader(synthetic_root, synthetic_root, size=32, shuffle=True,
                      seed=3)
    theirs = JaxClipLoader(synthetic_root, synthetic_root, size=32,
                           shuffle=True, seed=3, use_native=False)
    assert len(ours) == len(theirs) == 3
    for _ in range(2):  # the order changes with the epoch, seeded
        for a, b in zip(ours, theirs):
            assert a["video"] == b["video"]
            assert a["frames"].shape == (4, 32, 32, 3)
            assert a["masks"].shape == (4, 32, 32, 1)
            assert a["gts"][0].shape == (56, 64)
            assert tuple(a["frame_names"]) == tuple(b["frame_names"])
            np.testing.assert_array_equal(a["frames"], b["frames"])
            np.testing.assert_array_equal(a["masks"], b["masks"])
    no_gt = next(iter(ClipLoader(synthetic_root, None, size=32,
                                 with_gt=False)))
    assert "masks" not in no_gt and no_gt["video"] == "video_00"


def test_predict_clips_long_writes_native_size_pngs(tmp_path, long_pair,
                                                    synthetic_root):
    from PIL import Image

    from emip_tpu_torch.infer import predict_clips_long

    _, _, port = long_pair
    n = predict_clips_long(port, synthetic_root, str(tmp_path / "out"),
                           size=th.SIZE, device="cpu")
    assert n == 12
    pngs = sorted(p.relative_to(tmp_path / "out").as_posix()
                  for p in (tmp_path / "out").rglob("*.png"))
    assert pngs == [f"video_{v:02d}/{t:05d}.png" for v in range(3)
                    for t in range(4)]
    for p in pngs:
        im = Image.open(tmp_path / "out" / p)
        assert im.mode == "L" and im.size == (64, 56)


def _write_tiny_yaml(path, root, save, epoch=2):
    import yaml

    ds = dict(image_path=root, gt_path=root, inp_size=th.SIZE, batch_size=1)
    cfg = dict(
        train_dataset=ds, val_dataset=ds,
        model=dict(args=dict(
            inp_size=th.SIZE, channel=th.CHANNEL, backbone_name="pvt_v2_b0",
            include_dead_modules=False,
            GMFlow=dict(feature_channels=th.FDIM,
                        num_transformer_layers=th.NUM_LAYERS))),
        optimizer=dict(lr=1e-4, weight_decay=1e-7), memory_size=2,
        long_frames_per_dispatch=4,  # read and ignored
        seed=5, epoch=epoch, epoch_val=1, epoch_save=1, save_path=save)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def test_long_entry_points_train_checkpoint_and_predict(tmp_path,
                                                        synthetic_root):
    """``python -m emip_tpu_torch.train`` (2 steps) -> ``train_long
    --short_ckpt`` (2 videos x 3 frames: 4 per-frame steps, validation,
    checkpoints) -> ``test_long --ckpt`` (PNGs), in process on the CPU."""
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.test_long import main as test_long_main
    from emip_tpu_torch.train.__main__ import main as train_main
    from emip_tpu_torch.train_long import main as train_long_main

    cfg = tmp_path / "tiny.yaml"
    save = str(tmp_path / "run")
    _write_tiny_yaml(cfg, synthetic_root, save)
    loaded = load_config(str(cfg))
    assert loaded.memory_size == 2 and loaded.val_dataset_cad is None
    train_main(["--config", str(cfg), "--max_steps_per_epoch", "2",
                "--device", "cpu"])
    summary = train_long_main([
        "--config", str(cfg), "--short_ckpt", os.path.join(save, "ckpt"),
        "--max_videos_per_epoch", "2", "--max_frames_per_video", "3",
        "--device", "cpu"])
    assert summary["steps"] == 4 and summary["best_epoch"] == 1
    assert 0.0 <= summary["best_sm"] <= 1.0
    short = torch.load(os.path.join(save, "ckpt", "ckpt.pt"))["model"]
    ckpt = torch.load(os.path.join(save, "ckpt_long", "ckpt.pt"))
    assert ckpt["epoch"] == 1
    for k, v in short.items():  # loaded under short_term. and kept frozen
        assert torch.equal(ckpt["model"]["short_term." + k], v), k
    assert {float(s["step"]) for s in ckpt["optimizer"]["state"].values()
            } == {4.0}
    assert os.path.exists(os.path.join(save, "ckpt_long_best", "ckpt.pt"))

    out = str(tmp_path / "pred")
    frames = test_long_main([
        "--config", str(cfg), "--ckpt", os.path.join(save, "ckpt_long"),
        "--save_path", out, "--data", f"MoCA_test={synthetic_root}",
        "--device", "cpu"])
    assert frames == 12
    assert len(list((tmp_path / "pred" / "MoCA_test").rglob("*.png"))) == 12


@pytest.mark.parametrize("script,extra", [
    ("test_long", {"--device"}),
    ("train_long", {"--device", "--max_videos_per_epoch",
                    "--max_frames_per_video"})])
def test_long_cli_flags_mirror_root_scripts(script, extra):
    """The root script's flags plus --device (default: the card) and, for
    the trainer, the caps the short entry point has for tests."""
    import importlib

    mod = importlib.import_module(f"emip_tpu_torch.{script}")
    with open(os.path.join(REPO, f"{script}.py")) as f:
        root_flags = set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))
    args = mod.parse_args([])
    assert {f"--{k}" for k in vars(args)} == root_flags | extra
    assert args.device == "cuda" and args.config == "configs/emip.yaml"
    proc = subprocess.run([sys.executable, "-m", f"emip_tpu_torch.{script}",
                           "--help"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert all(flag in proc.stdout for flag in root_flags | extra)


@pytest.mark.parametrize("entry", ["predict_pairs", "predict_clips_long",
                                   "test", "test_long", "train", "train_long",
                                   "train_short_fn", "train_long_fn"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        entry, monkeypatch, tmp_path, synthetic_root):
    """No entry point falls back to the CPU: with the default device and
    no GPU each raises before it does any work."""
    from emip_tpu_torch import infer, test, test_long, train_long
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.train import __main__ as train_main
    from emip_tpu_torch.train.long import train_long as train_long_fn
    from emip_tpu_torch.train.loops import train_short

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "tiny.yaml"
    _write_tiny_yaml(cfg, synthetic_root, str(tmp_path / "run"))
    calls = {
        "predict_pairs": lambda: infer.predict_pairs(
            None, synthetic_root, str(tmp_path / "o")),
        "predict_clips_long": lambda: infer.predict_clips_long(
            None, synthetic_root, str(tmp_path / "o")),
        "test": lambda: test.main(["--data", f"a={synthetic_root}"]),
        "test_long": lambda: test_long.main(["--config", str(cfg)]),
        "train": lambda: train_main.main(["--config", str(cfg)]),
        "train_long": lambda: train_long.main(["--config", str(cfg)]),
        "train_short_fn": lambda: train_short(load_config(str(cfg))),
        "train_long_fn": lambda: train_long_fn(load_config(str(cfg))),
    }
    with pytest.raises(RuntimeError, match="no fallback to the CPU"):
        calls[entry]()
    assert not (tmp_path / "run").exists() and not (tmp_path / "o").exists()
