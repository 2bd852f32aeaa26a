"""The bf16 attention of kernels C, G and B's self layer, and G's bf16
forward, as their CUDA kernels compute them, on the CPU.

``csrc/attention_bf16.cu`` runs the bf16 attention on Hopper's warpgroup
tensor cores: key tiles of 64, the running max and sum, P = e^(s - m)
rounded to bf16 unnormalised for P v where v is bf16, C's 2-wide P v in
fp32. ``emip_window_layer_bf16`` runs G's bf16 forward in three launches:
q, k, v as one bf16 product, that attention, then o Wm^T with LN1, the
rounding of msg, the residual and the last rounding in its epilogue.
``emip_tpu_torch/kernels/tf32.py`` states both orders in plain tensor code
(``attention_bf16_walk``, ``window_layer_fwd_bf16_walk``); the kernels are
held against their plain versions and the walks on the card
(``chip_smoke.py``, the ``cuda`` tests of tests/test_torch_kernels.py).
Here each walk is held, on numpy-seeded inputs, by the card's own gates:

- against its plain bf16 version (``fused_flow_attention_reference``,
  ``attention_bf16_reference``, ``_layer_reference_bf16``, which round the
  normalised P): max|err| within 1e-2 of max|ref| (``BF16_KERNEL_REL`` of
  ``chip_smoke.py``);
- against an fp64 evaluation of the same function on the same
  bf16-rounded inputs and weights: its error at most 1.5x the plain
  version's (``BF16_FP64_RATIO``), an error under 1e-5 of max|ref| counting
  as 1e-5 (``BF16_FP64_FLOOR``: C's arithmetic after the bf16 inputs is
  fp32 on both sides);
- against the JAX package on the same inputs and weights: C through
  ``fused_flow_attention`` (Pallas in interpret mode), within 1e-5 of
  max|ref| (fp32 on both sides after the bf16 inputs, the exponentials and
  sums in another order); G through ``fused_window_attention_layer`` in
  bf16, compiled without XLA's excess precision (ROADMAP ground rule 5),
  within 8e-3 of max|ref| (two bf16 ulps: both sides round at the same
  points, msg and the output each once, their sums run in another order).

The cases cover widths 64 (pvt_v2_b0) and 128 (b5), token counts that are
no multiple of the 64-key tile or the 128-row block, and the shift mask
with and without the residual. The table of the mask's all-zero tiles,
which the kernel neither loads nor adds, is held to a loop over the tiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch.kernels import attention as att
from emip_tpu_torch.kernels import flow_attention as fa
from emip_tpu_torch.kernels import tf32
from emip_tpu_torch.kernels import window_attention as wa

BF16 = torch.bfloat16
KERNEL_REL = 1e-2
FP64_RATIO = 1.5
FP64_FLOOR = 1e-5
FLOW_JAX_REL = 1e-5
LAYER_JAX_REL = 8e-3


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _gates(walk, plain, ref64) -> None:
    """The card's bf16 gates: the walk within 1e-2 of max|plain| of the
    plain version, and its fp64 error at most 1.5x the plain version's."""
    assert walk.dtype == plain.dtype
    assert _rel(walk, plain) <= KERNEL_REL
    e_walk = max(_rel(walk, ref64), FP64_FLOOR)
    e_plain = max(_rel(plain, ref64), FP64_FLOOR)
    assert e_walk <= FP64_RATIO * e_plain, (e_walk, e_plain)


def _tb(a) -> torch.Tensor:
    """numpy fp32 -> torch bf16 (round to nearest even, as JAX rounds)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


@pytest.mark.parametrize("b,l,c", [(2, 64, 64), (2, 100, 128),
                                   (1, 257, 128), (3, 130, 64)])
def test_flow_attention_bf16_walk(b, l, c):
    """C's form: bf16 q, k, fp32 2-wide v, fp32 out; against the plain
    version, fp64 and the Pallas kernel on bf16 q and k."""
    from emip_tpu.ops.pallas import fused_flow_attention

    rng = np.random.default_rng(700 + l + c)
    q = rng.standard_normal((b, l, c)).astype(np.float32)
    k = rng.standard_normal((b, l, c)).astype(np.float32)
    v = (rng.standard_normal((b, l, 2)) * 10).astype(np.float32)
    qb, kb, vt = _tb(q), _tb(k), torch.from_numpy(v)
    walk = tf32.attention_bf16_walk(qb, kb, vt)
    assert walk.dtype == torch.float32 and walk.shape == (b, l, 2)
    plain = fa.fused_flow_attention_reference(qb, kb, vt)
    ref64 = fa.fused_flow_attention_reference(qb.double(), kb.double(),
                                              vt.double())
    _gates(walk, plain, ref64)
    want = fused_flow_attention(jnp.asarray(q, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16), v)
    assert _rel(walk, want) <= FLOW_JAX_REL


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("side,shifted", [(8, True), (24, False),
                                          (24, True), (22, True)])
def test_window_attention_bf16_walk(c, side, shifted):
    """The windows' form: bf16 q, k, v, bf16 out, windows of (side / 2)^2
    tokens (16, 144: two key tiles and a ragged 16, and 121, B's windows
    at multi-scale GMFlow's fine scale: a ragged 57 and a mask whose rows
    the kernel reads padded), with and without the shift mask; against the
    plain version and fp64."""
    from emip_tpu_torch.ops.window import shifted_window_mask

    tok = (side // 2) ** 2
    rng = np.random.default_rng(710 + side + c + shifted)
    q, k, v = (rng.standard_normal((8, tok, c)).astype(np.float32)
               for _ in range(3))
    qb, kb, vb = _tb(q), _tb(k), _tb(v)
    mask = shifted_window_mask(side, side, 2) if shifted else None
    walk = tf32.attention_bf16_walk(qb, kb, vb, mask)
    assert walk.dtype == BF16 and walk.shape == (8, tok, c)
    plain = att.attention_bf16_reference(qb, kb, vb, mask)
    # the function in fp64 on the same bf16 inputs, nothing rounded after
    s = qb.double() @ kb.double().transpose(-1, -2) / c**0.5
    if mask is not None:
        s = s + mask[torch.arange(8) % mask.shape[0]].double()
    ref64 = torch.softmax(s, -1) @ vb.double()
    _gates(walk, plain, ref64)


def _layer_case(c, side, shifted):
    """bf16-exact x, t [2, 4, T, c], flax-layout parameters, the mask."""
    from emip_tpu.ops.window import shifted_window_mask

    tok = (side // 2) ** 2
    rng = np.random.default_rng(720 + c + side + shifted)
    x = rng.standard_normal((2, 4, tok, c)).astype(np.float32)
    t = rng.standard_normal((2, 4, tok, c)).astype(np.float32)

    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    p = dict(wq=w(c, c), wk=w(c, c), wv=w(c, c), wm=w(c, c),
             s1=rng.uniform(0.7, 1.3, c).astype(np.float32),
             b1=rng.normal(0, 0.05, c).astype(np.float32))
    mask = np.asarray(shifted_window_mask(side, side, 2)) if shifted else None
    return x, t, p, mask


@pytest.mark.parametrize("c,side,shifted,add_residual", [
    (64, 8, False, True), (64, 8, True, False), (64, 24, True, True),
    (64, 24, False, False), (128, 8, True, True), (128, 24, False, True),
    (128, 24, True, True), (128, 24, True, False), (128, 22, True, True)])
def test_window_layer_fwd_bf16_walk(c, side, shifted, add_residual):
    """G's bf16 forward: the walk against the plain bf16 version, fp64 (the
    layer in fp64 on the bf16 x, t and the weights rounded as the kernel
    casts them) and the Pallas kernel in bf16."""
    from emip_tpu.ops.pallas.window_attention import (
        fused_window_attention_layer,
    )

    x, t, p, mask = _layer_case(c, side, shifted)
    keys = ("wq", "wk", "wv", "wm", "s1", "b1")
    tp = {k: torch.from_numpy(np.ascontiguousarray(v.T if v.ndim == 2
                                                   else v))
          for k, v in p.items()}
    tmask = None if mask is None else torch.from_numpy(np.array(mask))
    xb, tb = _tb(x), _tb(t)
    walk = tf32.window_layer_fwd_bf16_walk(xb, tb, tp, tmask, add_residual)
    assert walk.dtype == BF16 and walk.shape == x.shape
    plain = wa.fused_window_attention_layer_reference(xb, tb, tp, tmask,
                                                      add_residual)
    rounded = {k: (v.to(BF16) if k in keys[:4] else v).double()
               for k, v in tp.items()}
    ref64 = wa.fused_window_attention_layer_reference(
        xb.double(), tb.double(), rounded,
        None if tmask is None else tmask.double(), add_residual)
    _gates(walk, plain, ref64)

    jmask = None if mask is None else jnp.asarray(mask)

    def layer(x, t):
        return fused_window_attention_layer(
            x, t, *(jnp.asarray(p[k]) for k in keys), jmask,
            add_residual=add_residual)

    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16))
    want = jax.jit(layer).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    assert str(want.dtype) == "bfloat16"
    assert _rel(walk, want) <= LAYER_JAX_REL


@pytest.mark.parametrize("side", [64, 44, 24, 22, 14])
def test_mask_zero_tiles(side):
    """The table of all-zero mask tiles the bf16 attention skips
    (``attention.mask_zero_tiles``) against a loop over the shift mask's
    [128 query rows, 64 keys] tiles, ragged at T = 484, 144, 121 and 49; the
    shares of the model's windows (T 1024 and 484); kept beside the mask
    and made again after the mask changes in place."""
    from emip_tpu_torch.ops.window import shifted_window_mask

    mask = shifted_window_mask(side, side, 2).clone()
    nw, t, _ = mask.shape
    want = torch.tensor([[[bool((mask[w, i:i + 128, j:j + 64] == 0).all())
                           for j in range(0, t, 64)]
                          for i in range(0, t, 128)] for w in range(nw)])
    got = att.mask_zero_tiles(mask)
    assert got.dtype == torch.uint8 and torch.equal(got.bool(), want)
    share = {64: 0.375, 44: 0.3359375}.get(side)
    if share is not None:
        assert got.float().mean().item() == share
    assert att.mask_zero_tiles(mask) is got
    mask[0, 0, 0] = -100.0
    again = att.mask_zero_tiles(mask)
    assert again is not got and not again[0, 0, 0] and got[0, 0, 0]
    assert att.mask_zero_tiles(None) is None


@pytest.mark.parametrize("side,splits", [(88, 8), (44, 2)])
def test_mask_rows16(side, splits):
    """The shift mask as the bf16 attention reads its rows (TMA boxes,
    strides of whole 16 bytes): at T = 121 (88^2 split 8 ways, multi-scale
    GMFlow's fine windows) a copy with rows of 124, zeros past the 121
    keys, kept beside the mask and made again after it changes in place;
    at T = 484 the mask itself."""
    from emip_tpu_torch.ops.window import shifted_window_mask

    mask = shifted_window_mask(side, side, splits).clone()
    nw, t, _ = mask.shape
    rows, stride = att.mask_rows16(mask)
    if t % 4 == 0:
        assert rows is mask and stride == t
        return
    assert (t, stride) == (121, 124) and rows.shape == (nw, t, 124)
    assert rows.is_contiguous() and (4 * stride) % 16 == 0
    assert torch.equal(rows[..., :t], mask)
    assert not rows[..., t:].any()
    assert att.mask_rows16(mask)[0] is rows
    mask[1, 2, 3] = -7.0
    again, _ = att.mask_rows16(mask)
    assert again is not rows and again[1, 2, 3] == -7.0
    assert att.mask_rows16(None) == (None, 0)
