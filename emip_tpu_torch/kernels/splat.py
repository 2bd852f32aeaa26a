"""Kernel E: forward bilinear splat density and its gradient.

Port of :func:`emip_tpu.ops.pallas.splat.splat_density_pallas`; the CUDA
source is ``csrc/splat.cu``. :func:`splat_density` is one
``torch.autograd.Function``: CPU tensors take the plain version, CUDA
tensors the kernel, and on both the backward is :func:`splat_density_vjp`,
torch ops as the JAX package's VJP is XLA. Its one consumer on the model's
path thresholds the density into the occlusion mask from a detached flow
(:func:`emip_tpu_torch.ops.warp.occlusion_mask_backward`), so the train step
never calls the backward.

The kernel needs a card, so its algorithm is also written out here in
plain tensor code that the CPU tests hold against the plain version, an
fp64 sum and the Pallas kernel: :func:`splat_density_tiled` walks the
blocks' tiles, each block's shared window at its tile moved by the tile's
mean displacement, the corners that leave it, and the 64-bit fixed-point
sum that makes the result independent of the order of the adds. It runs
on no model's path.
"""

from __future__ import annotations

import functools

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["splat_density", "splat_density_reference", "splat_density_vjp",
           "splat_density_tiled"]

_NAME = "splat_density"
# csrc/splat.cu: a block's tile of source pixels (rows, columns), and the
# displacement beyond the tile's mean that its window still catches
TILE = (32, 32)
HALO = 4
FIX = 2.0**32  # corner weights are added as multiples of 2^-32


def _corners(coords: torch.Tensor):
    """x, y [N, H*W] of the targets, their floors, the fractions, and
    whether both are finite."""
    n = coords.shape[0]
    x = coords[..., 0].reshape(n, -1).float()
    y = coords[..., 1].reshape(n, -1).float()
    finite = torch.isfinite(x) & torch.isfinite(y)
    x0, y0 = torch.floor(x), torch.floor(y)
    return x0, y0, x - x0, y - y0, finite


def _cell(cx, cy, h: int, w: int, finite):
    """(flat cell index, in the image) of corners cx, cy; 0 where not."""
    valid = finite & (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
    return torch.where(valid, cy * w + cx, 0).long(), valid


def splat_density_reference(coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`splat_density`: a ``scatter_add_``
    of the four bilinear corners, out-of-range corners and sources with a
    non-finite coordinate dropped."""
    n, h, w, _ = coords.shape
    x0, y0, wx1, wy1, finite = _corners(coords)
    out = torch.zeros((n, h * w), dtype=torch.float32, device=coords.device)
    for cx, cy, wt in ((x0, y0, (1 - wx1) * (1 - wy1)),
                       (x0 + 1, y0, wx1 * (1 - wy1)),
                       (x0, y0 + 1, (1 - wx1) * wy1),
                       (x0 + 1, y0 + 1, wx1 * wy1)):
        idx, valid = _cell(cx, cy, h, w, finite)
        out.scatter_add_(1, idx, torch.where(valid, wt, 0.0))
    return out.reshape(n, h, w)


def splat_density_vjp(coords: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of the density w.r.t. ``coords`` for the cotangent ``g``
    [N, H, W]: the derivative of the hat weights, so each source gathers
    ``g`` at its own four corners (no scatter, no atomics); the port of
    the JAX package's VJP, which differentiates its XLA formulation.

    At an integer coordinate (a kink of the hat) this takes the one-sided
    derivative of the floor split, as autograd of the plain version does;
    JAX's ``abs`` and ``maximum`` pick other values of the same
    subdifferential there. Non-finite sources get 0.
    """
    n, h, w, _ = coords.shape
    x0, y0, fx, fy, finite = _corners(coords)
    gf = g.reshape(n, h * w).float()

    def at(cx, cy):
        idx, valid = _cell(cx, cy, h, w, finite)
        return torch.where(valid, gf.gather(1, idx), 0.0)

    g00, g10 = at(x0, y0), at(x0 + 1, y0)
    g01, g11 = at(x0, y0 + 1), at(x0 + 1, y0 + 1)
    dx = (1 - fy) * (g10 - g00) + fy * (g11 - g01)
    dy = (1 - fx) * (g01 - g00) + fx * (g11 - g10)
    grad = torch.where(finite[..., None], torch.stack((dx, dy), -1), 0.0)
    return grad.reshape(coords.shape).to(coords.dtype)


def splat_density_tiled(coords: torch.Tensor, tile=TILE, halo: int = HALO,
                        with_share: bool = False):
    """The kernel's algorithm in plain tensor code, for the CPU tests.

    Blocks own ``tile`` (rows, columns) of source pixels. A block's window
    holds (rows + 2 halo + 1) x (columns + 2 halo + 1) cells placed at the
    tile moved by the mean displacement of its finite sources; the corners
    that land in it are summed there, the others go straight to the
    image's accumulator, and the windows' non-zero cells inside the image
    are added at the end. Every corner weight is rounded to a multiple of
    2^-32 and summed as an int64, and each cell is converted once: the
    result depends neither on the order of the adds nor on where the
    windows sit. With ``with_share`` also returns the share of the image's
    corners that landed in their block's window.
    """
    n, h, w, _ = coords.shape
    th, tw = tile
    win_h, win_w = th + 2 * halo + 1, tw + 2 * halo + 1
    ty, tx = -(-h // th), -(-w // tw)
    xs = coords[..., 0].float().clamp(-2.0, w + 1.0)
    ys = coords[..., 1].float().clamp(-2.0, h + 1.0)
    finite = torch.isfinite(coords[..., 0]) & torch.isfinite(coords[..., 1])
    # each source pixel's block, and each block's window's first cell: the
    # tile moved by the floor of its sources' mean displacement
    by = (torch.arange(h) // th)[:, None]
    bx = (torch.arange(w) // tw)[None, :]
    block = (torch.arange(n)[:, None, None] * ty + by) * tx + bx
    nb, blk, bid = n * ty * tx, block.flatten(), torch.arange(n * ty * tx)
    count = torch.zeros(nb).index_add_(0, blk, finite.flatten().float())

    def origin(d, pos, first):
        shift = torch.zeros(nb, dtype=torch.float64).index_add_(
            0, blk, torch.where(finite, d - pos, 0.0).flatten().double())
        return first + torch.floor(shift / count.clamp(min=1)).long() - halo

    ox = origin(xs, torch.arange(w), bid % tx * tw)
    oy = origin(ys, torch.arange(h)[:, None], bid // tx % ty * th)

    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx1, wy1 = xs - x0, ys - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    acc = torch.zeros(n * h * w, dtype=torch.int64)
    win = torch.zeros(n * ty * tx * win_h * win_w, dtype=torch.int64)
    image = torch.arange(n)[:, None, None] * (h * w)
    local = total = 0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        jx, jy = x0.long() + dx, y0.long() + dy
        wt = (wx1 if dx else wx0) * (wy1 if dy else wy0)  # fp32
        fixed = torch.round(wt.double() * FIX).long()
        keep = (finite & (jx >= 0) & (jx < w) & (jy >= 0) & (jy < h)
                & (fixed > 0))
        lx, ly = jx - ox[block], jy - oy[block]
        mine = keep & (lx >= 0) & (lx < win_w) & (ly >= 0) & (ly < win_h)
        far = keep & ~mine
        win.index_add_(0, ((block * win_h + ly) * win_w + lx)[mine],
                       fixed[mine])
        acc.index_add_(0, (image + jy * w + jx)[far], fixed[far])
        local += int(mine.sum())
        total += int(keep.sum())
    # the flush: every window's non-zero cells inside the image
    cy = oy[:, None, None] + torch.arange(win_h)[:, None]
    cx = ox[:, None, None] + torch.arange(win_w)
    win = win.reshape(nb, win_h, win_w)
    flush = (win != 0) & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    cell = (bid // (ty * tx) * (h * w))[:, None, None] + cy * w + cx
    acc.index_add_(0, cell[flush], win[flush])
    density = (acc.double() / FIX).float().reshape(n, h, w)
    return (density, local / max(total, 1)) if with_share else density


@functools.lru_cache(maxsize=None)
def _workspace_floats(n: int, h: int, w: int) -> int:
    """Floats of the kernel's 64-bit accumulator at this shape."""
    return library().emip_splat_density_workspace(n, h, w)


def _density(coords: torch.Tensor) -> torch.Tensor:
    """The forward: the plain version on the CPU, the kernel on the card."""
    if cm.on_cpu(_NAME, coords):
        return splat_density_reference(coords)
    cm.check_kernel_args(_NAME, coords=coords)
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"{_NAME}: coords must be [N, H, W, 2]")
    if coords.data_ptr() % 8:  # the kernel reads (x, y) as one float2
        coords = coords.clone()
    n, h, w, _ = coords.shape
    out = torch.empty((n, h, w), device=coords.device, dtype=torch.float32)
    ws = torch.empty(_workspace_floats(n, h, w), device=coords.device,
                     dtype=torch.float32)
    rc = library().emip_splat_density(
        coords.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), n, h,
        w, cm.stream_handle(coords.device))
    cm.raise_on_error(_NAME, rc)
    cm.LAUNCHES["splat_density"] += 1
    return out


class _SplatDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords):
        ctx.save_for_backward(coords)
        return _density(coords)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        return splat_density_vjp(coords, g)


def splat_density(coords: torch.Tensor) -> torch.Tensor:
    """coords [N, H, W, 2] of (x, y) targets -> [N, H, W] fp32 density.

    Differentiable in coords (:func:`splat_density_vjp`); a call that
    needs no gradient (the occlusion mask's) skips the autograd Function.
    On the card the density has the same bits on every call.
    """
    if cm.grad_wanted(coords):
        return _SplatDensity.apply(coords)
    return _density(coords)
