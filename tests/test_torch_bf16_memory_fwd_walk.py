"""Kernel F's bf16 forward as its CUDA kernel computes it, on the CPU.

``emip_memory_attention_bf16`` (``csrc/memory_attention.cu``) runs both
products of the long-term memory read on bf16 tensor cores: each fp32 value
of the ring's k and v is split exactly into three bf16 parts (hi, mid, lo),
so that q k^T and P v against the ring are sums of exact bf16 products in
fp32; the keys stream in tiles of 32 with the bias added before the running
max, P = e^(s - m) rounded to bf16 for P v, the keys split across blocks as
the kernel plans them and the partials merged in order by their max and
sum. ``emip_tpu_torch/kernels/tf32.py`` states that order in plain tensor
code (``bf16_parts``, ``matmul_bf16x3``, ``key_splits``,
``memory_attention_fwd_bf16_walk``). Here, at small sizes on numpy-seeded
inputs:

- the three parts sum to x bit for bit, over fp32's normal range;
- the split plan is the kernel's at the model's shapes (``tc_splits`` of
  ``csrc/mma_tf32.cuh`` with blocks of 128 query rows, one an SM);
- the walk holds the card's bf16 gates against the plain bf16 version
  (``masked_memory_attention_reference``, which rounds e^(s - row max)):
  within 1e-2 of max|ref|, and its error against fp64 on the same inputs
  at most 1.5x the plain version's (an error under 1e-5 of max|ref|
  counting as 1e-5: ``BF16_KERNEL_REL``, ``BF16_FP64_RATIO`` and
  ``BF16_FP64_FLOOR`` of ``chip_smoke.py``); at widths 64 and 128, N no
  multiple of the 32-key tile, every slot written, some and none (a ring
  with no slot written reads the plain mean of the values), one split and
  several;
- it holds the JAX package's Pallas kernel (interpret mode) on the bf16 q
  within 8e-3 of max|ref| (two bf16 ulps: both round P, at another max and
  in another order);
- the row statistics it keeps (row max and the sum of the unrounded P) are
  those of the scores: the max within 1e-6 of max|m| and the sum within
  1e-5 relative of ``attention_row_stats`` on the upcast q, the same with
  the keys split, so the backward reads them as it reads the fp32
  forward's.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch import kernels as K
from emip_tpu_torch.kernels import tf32

BF16 = torch.bfloat16
KERNEL_REL = 1e-2
FP64_RATIO = 1.5
FP64_FLOOR = 1e-5
JAX_REL = 8e-3


def _np(x) -> np.ndarray:
    """A torch or JAX array as fp64 numpy."""
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


@functools.lru_cache(maxsize=None)
def _case(b: int, m: int, slots: int, c: int, valid: tuple):
    """bf16 q [b, m, c] (as numpy fp32 and torch bf16), fp32 k, v [b, slots
    m, c] and the bias (the last ``valid[i]`` slots of clip i written, the
    rest at -1e9)."""
    rng = np.random.default_rng(900 + b + m + c + sum(valid))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ok = np.zeros((b, slots), bool)
    for i, n in enumerate(valid):
        ok[i, slots - n:] = True
    bias = np.where(np.repeat(ok, m, axis=1), 0.0, -1e9).astype(np.float32)
    q = 2 * f(b, m, c)
    t = lambda a: torch.from_numpy(np.array(a, copy=True))  # noqa: E731
    return q, t(q).to(BF16), t(f(b, slots * m, c)), t(f(b, slots * m, c)), \
        t(bias)


def _fp64(q, k, v, bias):
    """The read in fp64 on the same inputs; an empty slot's key scores -1e9
    exactly, as in fp32, where the bias absorbs the score."""
    s = q.double() @ k.double().transpose(-1, -2) / q.shape[-1] ** 0.5
    s = torch.where(bias[:, None, :] < 0, bias[:, None, :].double(), s)
    return torch.softmax(s, -1) @ v.double()


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 1e-33])
def test_bf16_parts_sum_exactly(scale):
    """hi + mid + lo == x bit for bit, each part a bf16 value, |mid| at most
    half a bf16 ulp of hi and |lo| of mid, from fp32's largest magnitudes
    down to 2^-110 (below it lo is a subnormal bf16 value and drops bits
    under 2^-133: the error there is checked to stay so small)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal(4096) * scale)
                         .astype(np.float32))
    x = x[torch.isfinite(x)]
    hi, mid, lo = tf32.bf16_parts(x)
    tiny = x.abs() < 2.0 ** -110
    assert ((hi + mid + lo - x)[tiny].abs() <= 2.0 ** -133).all()
    x, hi, mid, lo = (t[~tiny] for t in (x, hi, mid, lo))
    assert x.numel() > 1000
    assert torch.equal(hi + mid + lo, x)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(BF16).float(), part)
    assert (mid.abs() <= hi.abs() * 2 ** -8).all()
    assert (lo.abs() <= mid.abs() * 2 ** -8).all()
    # the products of a bf16 operand with the parts sum to the fp32 product
    # to within fp32 rounding
    a = torch.randn(8, 64, generator=torch.Generator().manual_seed(3))
    b = torch.randn(64, 16, generator=torch.Generator().manual_seed(4))
    want = a.to(BF16).double() @ b.double()
    got = tf32.matmul_bf16x3(a, b)
    assert (got.double() - want).abs().max() <= 1e-6 * want.abs().max()


def test_key_splits_are_the_kernels_plan():
    """The model's cases: 1 clip (16 blocks of 128 query rows over 303 key
    tiles of 32) 8 splits; 4 clips (64 blocks) 2; 512^2 (32 blocks, 640
    tiles) 4: each fills the card's last wave (128 of 132 SMs); the ragged
    check [2, 100] x [2, 300] splits its 10 tiles 10 ways."""
    assert tf32.key_splits(16, 303) == 8
    assert tf32.key_splits(64, 303) == 2
    assert tf32.key_splits(32, 640) == 4
    assert tf32.key_splits(2, 10) == 10
    assert tf32.key_splits(1, 1) == 1


@pytest.mark.parametrize("b,m,slots,c,valid,splits", [
    (2, 20, 3, 64, (1, 3), None),      # N = 60: two tiles, the last ragged
    (1, 40, 5, 128, (5,), 1),          # every slot written, one split
    (1, 40, 5, 128, (5,), None),       # the same, 7 tiles in 7 splits
    (3, 16, 2, 128, (2, 1, 0), 2),     # partly and wholly empty rings
    (2, 36, 3, 64, (0, 0), None),      # no slot written: the mean of v
])
def test_memory_fwd_bf16_walk_holds_the_gates(b, m, slots, c, valid,
                                              splits):
    """The walk against the plain bf16 version and fp64 (the card's gates),
    against the Pallas kernel on the bf16 q, and its statistics against
    those of the scores."""
    from emip_tpu.ops.pallas.memory_attention import masked_memory_attention

    qn, q, k, v, bias = _case(b, m, slots, c, valid)
    out, row_max, row_sum = tf32.memory_attention_fwd_bf16_walk(
        q, k, v, bias, splits=splits, keep_stats=True)
    assert out.dtype == torch.float32 and out.shape == q.shape
    plain = K.masked_memory_attention_reference(q, k, v, bias)
    ref64 = _fp64(q, k, v, bias)
    assert _rel(out, plain) <= KERNEL_REL
    e_walk = max(_rel(out, ref64), FP64_FLOOR)
    e_plain = max(_rel(plain, ref64), FP64_FLOOR)
    assert e_walk <= FP64_RATIO * e_plain, (e_walk, e_plain)
    want = masked_memory_attention(jnp.asarray(qn, jnp.bfloat16),
                                   jnp.asarray(k.numpy()),
                                   jnp.asarray(v.numpy()),
                                   jnp.asarray(bias.numpy()))
    assert _rel(out, want) <= JAX_REL
    m_ref, l_ref = tf32.attention_row_stats(q.float(), k, bias)
    assert (row_max - m_ref).abs().max() <= 1e-6 * m_ref.abs().max()
    assert ((row_sum - l_ref).abs() / l_ref).max() <= 1e-5
    for i, n in enumerate(valid):
        if n == 0:  # every slot empty: the plain mean of the values
            mean = v[i].double().mean(0)
            assert (out[i].double() - mean).abs().max() <= 1e-6 * (
                mean.abs().max())


def test_memory_fwd_bf16_walk_splits_agree():
    """One split and eight (a ring of N = 9 x 32 + 8 keys): each split
    rounds P against its own running max, so the output moves within the
    bf16 band (8e-3 of max|ref|; measured 8.5e-4); the merge by max and sum
    keeps the row max bit for bit and the row sum to 1e-5."""
    _, q, k, v, bias = _case(1, 24, 12, 64, (12,))
    one = tf32.memory_attention_fwd_bf16_walk(q, k, v, bias, splits=1,
                                              keep_stats=True)
    many = tf32.memory_attention_fwd_bf16_walk(q, k, v, bias, splits=8,
                                               keep_stats=True)
    assert _rel(many[0], one[0]) <= JAX_REL
    assert torch.equal(many[1], one[1])
    assert ((many[2] - one[2]).abs() / one[2]).max() <= 1e-5
