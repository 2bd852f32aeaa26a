"""Kernels E and I's backward: their algorithms walked on the CPU, and E's
gradient.

The CUDA kernels of ``csrc/splat.cu`` and ``csrc/softmax_expectation.cu``
need a card; their walks follow them step by step.
``splat_density_tiled`` (``emip_tpu_torch/kernels/splat.py``) splits the
sources into the blocks' tiles, sums the corners that land in a block's
window there and sends the others to the image, all as 64-bit fixed-point
integers: held against the plain version, an fp64 sum, the Pallas kernel
in interpret mode and its XLA reference, and to the same bits when the
sources are permuted. ``softmax_expectation_bwd_tiled``
(``kernels/softmax_expectation.py``) walks the register tile (each
thread's columns, two block reductions), the per-block dvalues partials
and their ordered column sum, and the streaming instantiation past the
tile: held against autograd of the plain version and the Pallas VJP at
ragged N. ``K.splat_density``'s gradient (a gather at each source's
corners, the same on the card) is held against ``jax.vjp`` of the Pallas
kernel. Inputs come from numpy seeds; fp32.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401  (caps torch threads)

from emip_tpu_torch import kernels as K

sp = importlib.import_module("emip_tpu_torch.kernels.splat")
se = importlib.import_module("emip_tpu_torch.kernels.softmax_expectation")

SPLAT_CASES = ["random", "integer", "edges", "coherent"]


def _splat_coords(case, n=2, h=8, w=12):
    """The coordinates of ``tests/test_torch_kernels.py``'s kernel E test,
    and a coherent field: a shift of (2.5, -1.25) px and a 2 degree
    rotation about the centre, part of it off the image."""
    rng = np.random.default_rng(60)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xx, yy], -1)[None].astype(np.float32)
    if case == "random":
        return grid + (rng.standard_normal((n, h, w, 2)) * 3).astype(
            np.float32)
    if case == "integer":  # corners of weight exactly 0 and 1
        return grid + rng.integers(-3, 4, (n, h, w, 2)).astype(np.float32)
    if case == "edges":  # negative, on and past every edge
        vals = np.array([-1.5, -1.0, -0.5, 0.0, 0.25, w - 1.0, w - 0.5, w,
                         w + 0.7, h - 1.0, h - 0.5, h], np.float32)
        return rng.choice(vals, (n, h, w, 2)).astype(np.float32)
    th = np.deg2rad(2.0)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    x = cx + np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + 2.5
    y = cy + np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) - 1.25
    return np.broadcast_to(np.stack([x, y], -1), (n, h, w, 2)).astype(
        np.float32)


def _fp64_density(coords: torch.Tensor) -> torch.Tensor:
    """The fp32 corner weights the kernel forms, summed in fp64."""
    n, h, w, _ = coords.shape
    x, y = coords[..., 0].reshape(n, -1), coords[..., 1].reshape(n, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    out = torch.zeros(n, h * w, dtype=torch.float64)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = x0 + dx, y0 + dy
        wt = (wx1 if dx else 1 - wx1) * (wy1 if dy else 1 - wy1)
        ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        idx = torch.where(ok, cy * w + cx, 0).long()
        out.scatter_add_(1, idx, torch.where(ok, wt, 0.0).double())
    return out.reshape(n, h, w)


# (tile rows, tile columns, halo): the kernel's, and small ragged tiles
# with many blocks an image
TILES = [(32, 32, 2), (3, 5, 1), (4, 4, 0)]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", SPLAT_CASES)
def test_splat_walk_matches_pallas_xla_and_plain(case, tile):
    from emip_tpu.ops.pallas.splat import _xla_reference, splat_density_pallas

    coords = _splat_coords(case)
    got = sp.splat_density_tiled(torch.from_numpy(coords), tile[:2],
                                 tile[2]).numpy()
    np.testing.assert_allclose(
        got, K.splat_density_reference(torch.from_numpy(coords)).numpy(),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(splat_density_pallas(coords)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(_xla_reference(coords)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", SPLAT_CASES)
def test_splat_walk_is_order_independent_and_near_fp64(case):
    """Moving the sources to other pixels (other tiles, other windows,
    another order of the adds) leaves every bit of the density as it was;
    the fixed-point sum is within 1e-6 of the fp64 sum of the weights."""
    coords = torch.from_numpy(_splat_coords(case, h=20, w=28))
    n, h, w, _ = coords.shape
    got = sp.splat_density_tiled(coords, (4, 8), 1)
    perm = torch.from_numpy(np.random.default_rng(61).permutation(h * w))
    moved = coords.reshape(n, h * w, 2)[:, perm].reshape(n, h, w, 2)
    assert torch.equal(sp.splat_density_tiled(moved, (4, 8), 1), got)
    assert torch.equal(sp.splat_density_tiled(moved), got)
    err = (got.double() - _fp64_density(coords)).abs().max().item()
    assert err <= 1e-6, err


def test_splat_walk_keeps_a_coherent_field_in_the_windows():
    """Under the coherent field every corner that lands in the image lands
    in its block's window (the windows follow the flow), so the global
    adds are the windows' flushes alone; scattered targets leave them."""
    coherent = torch.from_numpy(_splat_coords("coherent", h=40, w=56))
    _, share = sp.splat_density_tiled(coherent, (8, 8), 2, with_share=True)
    assert share == 1.0
    rng = np.random.default_rng(62)
    uniform = torch.from_numpy(
        rng.uniform(-4, 60, (2, 40, 56, 2)).astype(np.float32))
    _, share = sp.splat_density_tiled(uniform, (8, 8), 2, with_share=True)
    assert share < 0.2


@pytest.mark.parametrize("case", ["random", "coherent"])
def test_splat_density_gradient_matches_jax_vjp(case):
    """``torch.autograd.grad`` through ``K.splat_density`` (its backward is
    :func:`splat_density_vjp`, the card's too) against ``jax.vjp`` of the
    Pallas kernel at non-integer coordinates."""
    from emip_tpu.ops.pallas.splat import splat_density_pallas

    coords = _splat_coords(case)
    assert np.all(coords != np.floor(coords))
    cot = np.random.default_rng(63).standard_normal(
        coords.shape[:3]).astype(np.float32)
    want, vjp = jax.vjp(splat_density_pallas, coords)
    leaf = torch.from_numpy(coords).requires_grad_(True)
    got = K.splat_density(leaf)
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (grad,) = torch.autograd.grad(got, leaf, torch.from_numpy(cot))
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(cot)[0]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", SPLAT_CASES)
def test_splat_density_vjp_is_the_plain_versions_gradient(case):
    """The gather VJP equals autograd of the plain scatter_add_ version at
    every coordinate, the integer ones (the hat's kinks) included."""
    coords = torch.from_numpy(_splat_coords(case)).requires_grad_(True)
    cot = torch.from_numpy(np.random.default_rng(64).standard_normal(
        coords.shape[:3]).astype(np.float32))
    want = torch.autograd.grad(K.splat_density_reference(coords), coords,
                               cot)[0]
    got = sp.splat_density_vjp(coords.detach(), cot)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# (B, M, N, float4 loads, at most this many blocks): N = 1, N no multiple
# of 4 (single floats), N of the 352^2 matching as float4 and as single
# floats with several rows a block, N at the register tile and past it
# (the streaming instantiation)
SOFTMAX_SHAPES = [(1, 1, 1, None, None), (2, 5, 91, None, None),
                  (2, 7, 1001, None, 3), (2, 6, 1936, True, 4),
                  (2, 6, 1936, False, 5), (1, 3, 4096, None, None),
                  (2, 3, 4100, None, 2)]


@pytest.mark.parametrize("b,m,n,vec,blocks", SOFTMAX_SHAPES)
def test_softmax_expectation_bwd_walk(b, m, n, vec, blocks):
    """dcorr and dvalues of the walk against autograd of the plain version
    and the Pallas VJP: max|err| <= 1e-5 * max(max|ref|, 1) (at N = 1
    dcorr is 0 up to rounding)."""
    from emip_tpu.ops.pallas import softmax_expectation

    rng = np.random.default_rng(70 + n)
    corr = (rng.standard_normal((b, m, n)) * 3).astype(np.float32)
    values = (rng.standard_normal((n, 2)) * 20).astype(np.float32)
    cot = rng.standard_normal((b, m, 2)).astype(np.float32)
    got = se.softmax_expectation_bwd_tiled(
        torch.from_numpy(corr), torch.from_numpy(values),
        torch.from_numpy(cot), vec=vec, max_blocks=blocks)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (corr, values)]
    plain = torch.autograd.grad(K.softmax_expectation_reference(*leaves),
                                leaves, torch.from_numpy(cot))
    _, vjp = jax.vjp(softmax_expectation, corr, values)
    for ref in ([g.numpy() for g in plain], vjp(cot)):
        for name, a, e in zip(("dcorr", "dvalues"), got, ref):
            e = np.asarray(e, np.float64)
            err = np.abs(a.numpy() - e).max()
            assert err <= 1e-5 * max(np.abs(e).max(), 1.0), (name, err)
