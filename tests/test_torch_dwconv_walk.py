"""Kernel J's algorithm, walked on the CPU.

The CUDA kernels of ``csrc/dwconv_gelu.cu`` need a card; their walks in
``emip_tpu_torch/kernels/dwconv_gelu.py`` follow them step by step: the
forward's strips of rows with running output rows, the backward's tiles
per block in the kernel's order with gd recomputed on each tile's halo and
the per-block tap and bias partials added in order. Each walk is held
against the plain version (and ``torch.autograd.grad`` of it) and against
the JAX package's Pallas kernels in interpret mode (``fused_dwconv_gelu``,
and ``dwconv_gelu_bwd_fused`` under ``jax.vjp``) at maps whose tiles are
ragged: H and W no multiple of the tile, one row, one column, W wider than
a tile, several images. Inputs come from numpy seeds; fp32. Tolerance:
max|err| <= 1e-5 * max|ref| per output (sums in another order; the Pallas
kernels take erf by a rational fit, |err| <= 1.5e-7).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from emip_tpu_torch import kernels as K

dw = importlib.import_module("emip_tpu_torch.kernels.dwconv_gelu")

REL = 1e-5

# (images, H, W, F, rows of a strip or tile, columns of a tile, blocks)
SHAPES = [(2, 7, 13, 8, 3, 4, 3),     # ragged both ways, W > a tile
          (1, 1, 9, 4, 2, 4, 2),      # one row
          (2, 9, 1, 5, 4, 3, 5),      # one column, F no multiple of 4
          (3, 5, 6, 12, 16, 10, 1),   # one tile an image, one block
          (2, 11, 11, 16, 4, 6, 4)]   # stage 4's map, ragged tiles


def _inputs(b, h, w, f):
    rng = np.random.default_rng(100 + b * h * w + f)
    u = rng.standard_normal((b, h * w, f)).astype(np.float32)
    wdw = (rng.standard_normal((3, 3, f)) * 0.3).astype(np.float32)
    bdw = (rng.standard_normal(f) * 0.1).astype(np.float32)
    cot = rng.standard_normal((b, h * w, f)).astype(np.float32)
    return u, wdw, bdw, cot


def _assert_rel(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= REL, (what, err)


@pytest.mark.parametrize("b,h,w,f,rows,cols,blocks", SHAPES)
def test_dwconv_gelu_forward_strips_walk(b, h, w, f, rows, cols, blocks):
    from emip_tpu.ops.pallas.mixffn import fused_dwconv_gelu

    u, wdw, bdw, _ = _inputs(b, h, w, f)
    tu, tw, tb = (torch.from_numpy(a) for a in (u, wdw, bdw))
    got = dw.fused_dwconv_gelu_strips(tu, tw, tb, h, w, rows)
    _assert_rel(got, K.fused_dwconv_gelu_reference(tu, tw, tb, h, w),
                "plain")
    _assert_rel(got, fused_dwconv_gelu(u, wdw, bdw, h, w), "pallas")


@pytest.mark.parametrize("b,h,w,f,rows,cols,blocks", SHAPES)
def test_dwconv_gelu_backward_tiled_walk(b, h, w, f, rows, cols, blocks):
    from emip_tpu.ops.pallas.mixffn import (
        dwconv_gelu_bwd_fused,
        fused_dwconv_gelu,
    )

    u, wdw, bdw, cot = _inputs(b, h, w, f)
    tu, tw, tb, tg = (torch.from_numpy(a) for a in (u, wdw, bdw, cot))
    got = dw.dwconv_gelu_bwd_tiled(tu, tw, tb, tg, h, w, rows, cols, blocks)
    leaves = [x.clone().requires_grad_(True) for x in (tu, tw, tb)]
    want = torch.autograd.grad(
        K.fused_dwconv_gelu_reference(*leaves, h, w), leaves, tg)
    for name, a, e in zip(("gu", "gwdw", "gbdw"), got, want):
        _assert_rel(a, e, f"plain {name}")
    for jfn in (fused_dwconv_gelu, dwconv_gelu_bwd_fused):
        _, vjp = jax.vjp(lambda x, k, c: jfn(x, k, c, h, w), u, wdw, bdw)
        for name, a, e in zip(("gu", "gwdw", "gbdw"), got, vjp(cot)):
            _assert_rel(a, e, f"{jfn.__name__} {name}")


# b5's four MixFFN maps at 352^2 and batch 8 -> (rows, strips, blocks) of
# the staged bf16 forward (``staged_tiling`` of ``csrc/dwconv_gelu.cu``)
BF16_STAGES = [((8, 88, 88, 256), (30, 3, 264)),
               ((8, 44, 44, 512), (9, 5, 480)),
               ((8, 22, 22, 1280), (11, 2, 240)),
               ((8, 11, 11, 2048), (6, 2, 256))]


@pytest.mark.parametrize("shape,want", BF16_STAGES)
def test_dwconv_gelu_bf16_forward_staged_walk(shape, want):
    """The bf16 forward's strips at b5's maps, walked on bf16 inputs (the
    map at 16 channels and one image) against the plain bf16 version and
    the Pallas kernel in bf16: 1e-2 of max|ref|, the bf16 band's gate (an
    output may round to the other side of a bf16 step)."""
    from emip_tpu.ops.pallas.mixffn import fused_dwconv_gelu

    plan = dw.dwconv_fwd_bf16_plan(*shape)
    assert (plan["rows"], plan["strips"], plan["blocks"]) == want
    _, h, w, _ = shape
    u, wdw, bdw, _ = _inputs(1, h, w, 16)
    tu, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (u, wdw))
    tb = torch.from_numpy(bdw)
    got = dw.fused_dwconv_gelu_strips(tu.float(), tw.float(), tb, h, w,
                                      plan["rows"]).to(torch.bfloat16)
    ref = K.fused_dwconv_gelu_reference(tu, tw, tb, h, w)
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= 1e-2, err
    bf16 = jax.numpy.bfloat16
    pallas = fused_dwconv_gelu(jax.numpy.asarray(tu.float().numpy(), bf16),
                               jax.numpy.asarray(tw.float().numpy(), bf16),
                               bdw, h, w)
    pallas = torch.from_numpy(np.asarray(pallas, np.float32))
    err = (got.float() - pallas).abs().max() / pallas.abs().max()
    assert err <= 1e-2, err
