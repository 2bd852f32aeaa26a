"""Kernel J's bf16 backward: its plan and order on the CPU, its kernel on
the card.

``emip_dwconv_gelu_bwd_bf16`` (``csrc/dwconv_gelu.cu``) walks the fp32
backward's tiling on bf16 storage: four channels a lane (one where F is no
multiple of 4), tiles of up to 10 columns by strips of up to 16 rows, about
one persistent block an SM, each column's tap and bias sums kept in fp32
over the block's tiles, the blocks' partials added in order by a last pass
that rounds the tap grad to bf16 once. ``kernels/dwconv_gelu.py`` states
the plan (``dwconv_bwd_plan``) and the order (``dwconv_gelu_bwd_tiled``).
Here:

- the plan at the four PVT stages of pvt_v2_b5 at 352^2, B 8, and at F
  that is no multiple of 4;
- the walk on bf16 inputs (widened, its gu and tap grad rounded to bf16
  once) against the JAX package's backward kernel, ``_backward_pallas`` in
  interpret mode, on the same bf16 u, taps and cotangent: gu and the tap
  grad within 8e-3 of max|ref| (two bf16 ulps: both round once, from sums
  in another order), the bias grad (fp32) within 1e-5; a ragged 7 x 13
  map, F a multiple of 8, of 4 and of neither;
- on the card (``cuda``), the kernel against its plain version (the fp32
  VJP at the widened inputs, each grad rounded to its input's dtype) within
  1e-2 of max|ref| per grad, the same bits on a second call, and gu, the
  tap and the bias grads in their dtypes, at a stage-1 shape, the ragged
  map, and F of 12 and 6 (the four- and one-channel walks).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch import kernels as K
from emip_tpu_torch.kernels import dwconv_gelu as dw

BF16 = torch.bfloat16
BAND = 8e-3
BIAS_REL = 1e-5


def _bf16_case(b, h, w, f, seed):
    """bf16 u [b, h w, f], taps [3, 3, f] and cotangent; fp32 bias."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    u = t(rng.standard_normal((b, h * w, f))).to(BF16)
    taps = t(rng.standard_normal((3, 3, f)) * 0.3).to(BF16)
    bias = t(rng.standard_normal(f) * 0.1)
    cot = t(rng.standard_normal((b, h * w, f))).to(BF16)
    return u, taps, bias, cot


def _rel(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("b,h,w,f,lanes,plan", [
    (8, 88, 88, 256, 4, (15, 10, 62, 2)),
    (8, 44, 44, 512, 4, (15, 9, 30, 4)),
    (8, 22, 22, 1280, 4, (11, 8, 12, 10)),
    (8, 11, 11, 2048, 4, (11, 6, 8, 16)),
    (2, 7, 13, 6, 1, (7, 7, 4, 1)),
])
def test_dwconv_bwd_plan_is_the_kernels(b, h, w, f, lanes, plan):
    """(rows, columns, blocks a group, channel groups) of the backward's
    tiling: strips and column tiles evened out over the map, about one
    block an SM (132) over the groups, every block at least one tile."""
    got = dw.dwconv_bwd_plan(b, h, w, f, lanes)
    assert (got["rows"], got["cols"], got["blocks"], got["groups"]) == plan
    tiles = b * -(-h // got["rows"]) * -(-w // got["cols"])
    assert got["blocks"] <= tiles
    assert got["blocks"] * got["groups"] <= 132


@pytest.mark.parametrize("b,h,w,f", [(2, 7, 13, 16), (1, 11, 11, 64),
                                     (2, 5, 6, 12), (2, 7, 13, 6)])
def test_bf16_bwd_walk_matches_pallas(b, h, w, f):
    """The walk at the kernel's plan (four channels a lane where F allows
    it, else one) on bf16 inputs against ``_backward_pallas`` on the same
    bf16 inputs (interpret mode), each grad in JAX's dtype."""
    import jax.numpy as jnp

    from emip_tpu.ops.pallas.mixffn import _backward_pallas

    u, taps, bias, cot = _bf16_case(b, h, w, f, 500 + h * w + f)
    gu, gwdw, gbdw = dw.dwconv_gelu_bwd_tiled(u.float(), taps.float(), bias,
                                              cot.float(), h, w)
    gu, gwdw = gu.to(BF16), gwdw.to(BF16)
    jb = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa
    want = _backward_pallas((jb(u), jb(taps), jnp.asarray(bias.numpy()),
                             h * w, w), jb(cot))
    assert [str(x.dtype) for x in want] == ["bfloat16", "bfloat16",
                                            "float32"]
    f32 = [np.asarray(jnp.asarray(x, jnp.float32)) for x in want]
    assert _rel(gu.float().numpy(), f32[0]) <= BAND
    assert _rel(gwdw.float().numpy(), f32[1]) <= BAND
    assert _rel(gbdw.numpy(), f32[2]) <= BIAS_REL


@pytest.mark.cuda
def test_cuda_bf16_dwconv_gelu_backward_matches_plain_version():
    """J's bf16 backward on the card against its plain version (the fp32
    VJP at the widened inputs, rounded to each input's dtype) within 1e-2
    of max|ref| per grad, the same bits on a second call, one bf16 backward
    launch a call; at a stage-1 shape, a ragged map and F of 12 (four
    channels a lane) and 6 (one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    for b, h, w, f in ((2, 88, 88, 256), (2, 7, 13, 256), (2, 5, 6, 12),
                       (1, 7, 13, 6)):
        u, taps, bias, cot = _bf16_case(b, h, w, f, 600 + h * w + f)
        leaves = [x.cuda().requires_grad_(True) for x in (u, taps, bias)]
        out = K.fused_dwconv_gelu(*leaves, h, w)
        before = K.LAUNCHES["dwconv_gelu_bwd_bf16"]
        got = torch.autograd.grad(out, leaves, cot.cuda(), retain_graph=True)
        again = torch.autograd.grad(out, leaves, cot.cuda())
        torch.cuda.synchronize()
        assert K.LAUNCHES["dwconv_gelu_bwd_bf16"] == before + 2
        cpu = [x.clone().requires_grad_(True) for x in (u, taps, bias)]
        want = torch.autograd.grad(K.fused_dwconv_gelu(*cpu, h, w), cpu, cot)
        for name, a, a2, e, x in zip(("gu", "gwdw", "gbdw"), got, again,
                                     want, (u, taps, bias)):
            assert a.dtype == e.dtype == x.dtype, name
            assert torch.equal(a, a2), name
            err = (a.cpu().float() - e.float()).abs().max()
            assert err <= 1e-2 * e.float().abs().max(), ((b, h, w, f), name)
