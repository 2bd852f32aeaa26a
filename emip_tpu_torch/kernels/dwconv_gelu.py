"""Kernel J: gelu_exact(dwconv3x3(u) + b) of the PVTv2 MixFFN on flat
channel-last tokens, forward and backward.

Port of :func:`emip_tpu.ops.pallas.mixffn.fused_dwconv_gelu` and
:func:`emip_tpu.ops.pallas.mixffn.dwconv_gelu_bwd_fused` (exact GELU; the
polynomial GELUs of the JAX package are not ported); the CUDA source is
``csrc/dwconv_gelu.cu``. :func:`fused_dwconv_gelu` is one
``torch.autograd.Function``: CPU tensors take the plain version (and its
autograd backward), CUDA tensors the forward and backward kernels. With
``library_forward`` the CUDA forward is the library's grouped convolution
and GELU and only the backward is the kernel, as ``dwconv_gelu_bwd_fused``
keeps XLA's forward.

In the bf16 band (bf16 ``u`` and taps, fp32 bias, as the JAX MixFFN hands
them to the kernel) the kernels are the JAX ones with a bf16 storage
dtype: the stencil and the GELU in fp32 on the widened values, the output
rounded to bf16; the backward recomputes in fp32, and returns gu and the
tap grad rounded to bf16 (the tap grad is summed in fp32 and returned in
the taps' dtype) and the bias grad fp32 (``emip_dwconv_gelu_bf16``,
``emip_dwconv_gelu_bwd_bf16``). With ``library_forward`` the bf16 forward
is JAX's ``_xla_fwd`` in bf16: the library's bf16 convolution, the bias
cast to bf16 and added, the GELU in bf16.

The CUDA kernels cannot run without a card, so their algorithm is also
written out here in plain tensor code that the CPU tests hold against the
plain version, its autograd backward and the Pallas kernels:
:func:`fused_dwconv_gelu_strips` walks the forward (strips of rows, each
input row added into three running output rows; the bf16 forward cuts its
strips as :func:`dwconv_fwd_bf16_plan` says and stages the rows in shared
memory) and
:func:`dwconv_gelu_bwd_tiled` the backward (tiles walked per block in the
kernel's order, :func:`dwconv_bwd_plan`, gd recomputed on each tile and its
one-pixel halo, each column's tap and bias sums kept over the block's
tiles, the per-block partials added in order). Neither runs on a model's
path.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_dwconv_gelu", "fused_dwconv_gelu_reference",
           "fused_dwconv_gelu_strips", "dwconv_gelu_bwd_tiled",
           "dwconv_bwd_plan", "dwconv_fwd_bf16_plan"]

_NAME = "fused_dwconv_gelu"


def fused_dwconv_gelu_reference(u, wdw, bdw, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_dwconv_gelu` (with bf16 ``u``
    that of its bf16 kernel: fp32 on the widened u and taps, the output
    rounded once)."""
    if u.dtype == torch.bfloat16:
        return fused_dwconv_gelu_reference(u.float(), wdw.float(), bdw, h,
                                           w).to(u.dtype)
    b, hw, f = u.shape
    x = u.transpose(1, 2).reshape(b, f, h, w)
    y = F.conv2d(x, wdw.permute(2, 0, 1)[:, None], bdw, padding=1, groups=f)
    return F.gelu(y).flatten(2).transpose(1, 2)


def _library_forward(u, wdw, bdw, h: int, w: int) -> torch.Tensor:
    """The forward of ``library_forward``: the library's convolution and
    GELU in u's dtype (in bf16 JAX's ``_xla_fwd``: the bf16 convolution,
    then the bias cast to bf16 and added, then the GELU)."""
    if u.dtype != torch.bfloat16:
        return fused_dwconv_gelu_reference(u, wdw, bdw, h, w)
    b, hw, f = u.shape
    x = u.transpose(1, 2).reshape(b, f, h, w)
    y = F.conv2d(x, wdw.permute(2, 0, 1)[:, None], None, padding=1, groups=f)
    y = y + bdw.to(u.dtype)[:, None, None]
    return F.gelu(y).flatten(2).transpose(1, 2)


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU."""
    phi = torch.exp(-0.5 * x * x) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + x * phi


def _cols3(row: torch.Tensor, w: int):
    """The left, centre and right neighbours of every column of ``row``
    [..., W, F], zero off the image."""
    p = F.pad(row, (0, 0, 1, 1))
    return p[..., :w, :], p[..., 1:w + 1, :], p[..., 2:, :]


def fused_dwconv_gelu_strips(u, wdw, bdw, h: int, w: int,
                             rows: int) -> torch.Tensor:
    """The forward kernel's walk: each strip of ``rows`` output rows walks
    input rows y0 - 1 .. y1, each row added into the running sums of output
    rows r + 1, r and r - 1 through tap rows 0, 1 and 2; output row r - 1
    is then whole and goes out through the GELU."""
    b, _, f = u.shape
    img = u.reshape(b, h, w, f)
    out = torch.empty_like(img)
    zero = img.new_zeros(b, w, f)
    for y0 in range(0, h, rows):
        y1 = min(h, y0 + rows)
        sums = [zero, zero, zero]  # output rows r - 1, r, r + 1
        for r in range(y0 - 1, y1 + 1):
            nb = _cols3(img[:, r], w) if 0 <= r < h else (zero,) * 3
            for i, k in ((2, 0), (1, 1), (0, 2)):
                sums[i] = sums[i] + sum(t * wdw[k, j]
                                        for j, t in enumerate(nb))
            if r - 1 >= y0:
                out[:, r - 1] = F.gelu(sums[0] + bdw)
            sums = [sums[1], sums[2], zero]
    return out.reshape(b, h * w, f)


def dwconv_fwd_bf16_plan(b: int, h: int, w: int, f: int) -> dict:
    """How the staged bf16 forward kernel cuts its work at this shape
    (``staged_tiling`` of ``csrc/dwconv_gelu.cu``, taken where F is a
    multiple of 8 and the pointers are 16-byte aligned): blocks of one
    channel group of 256 channels (eight a lane) by up to 8 columns (one
    warp each), the columns evened out over the image; the strips whose
    grid takes the fewest row steps, a block's steps being its rows and its
    two halo rows, the grid running in waves of two blocks on each of the
    H100's 132 SMs (the fewest strips among equals). Each strip walks input
    rows y0 - 1 .. y1 through a ring of rows in shared memory, as
    :func:`fused_dwconv_gelu_strips` walks them."""
    groups = -(-(f // 8) // 32)
    col_tiles = -(-w // 8)
    cols = -(-w // col_tiles)
    per_strip = b * groups * col_tiles
    best = None
    for s in range(1, h + 1):
        rows = -(-h // s)
        if -(-h // rows) != s:  # the same cut as fewer strips
            continue
        steps = -(-per_strip * s // (2 * 132)) * (rows + 2)
        if best is None or steps < best[0]:
            best = (steps, rows, s)
    _, rows, strips = best
    return dict(rows=rows, strips=strips, cols=cols, col_tiles=col_tiles,
                groups=groups, blocks=per_strip * strips)


def dwconv_bwd_plan(b: int, h: int, w: int, f: int,
                    lane_channels: int = 4) -> dict:
    """How the backward kernel cuts its work at this shape (``tiling`` and
    ``bwd_blocks_per_group`` of ``csrc/dwconv_gelu.cu``): ``lane_channels``
    channels a lane (4, or 1 where F is no multiple of 4 or a pointer is
    not aligned for 4), so a warp's group of 32 lanes covers 32 x that many
    channels; tiles of up to 10 columns by strips of up to 16 rows, evened
    out over the image; about one persistent block an SM (the H100's 132)
    over all groups, each group's tiles evened out over its blocks. The
    plan sets the order in which the tap and bias partials are summed."""
    groups = -(-(f // lane_channels) // 32)
    col_tiles = -(-w // 10)
    cols = -(-w // col_tiles)
    strips = -(-h // 16)
    rows = -(-h // strips)
    tiles = b * strips * col_tiles
    want = max(1, 132 // groups)
    blocks = -(-tiles // -(-tiles // want))
    return dict(rows=rows, cols=cols, blocks=blocks, groups=groups)


def dwconv_gelu_bwd_tiled(u, wdw, bdw, g, h: int, w: int,
                          rows: int | None = None, cols: int | None = None,
                          blocks: int | None = None):
    """The backward kernel's walk -> (gu, gwdw, gbdw).

    The images are cut into tiles of ``rows`` x ``cols`` pixels, numbered
    image-major, then strip, then column tile; block p of ``blocks`` walks
    tiles p, p + blocks, ... in order (by default as the kernel plans them,
    four channels a lane where F is a multiple of 4, else one:
    :func:`dwconv_bwd_plan`; every channel group takes the same plan, so
    every channel's sums run in the same order). On each tile it recomputes the pre-activation and gd = g *
    gelu'(pre) on the tile and its one-pixel halo (u read with a two-pixel
    halo, zero off the image) and writes gu on the tile by the transposed
    taps. Column i of the tile (warp i + 1 of the block) adds u(p + d) *
    gd(p) (taps) and gd(p) (bias) over its pixels, row by row, into a sum it
    keeps over all of the block's tiles; the block's partial is those sums
    added in column order; a last pass adds partials i, i + 8, ... in order
    for each i < 8, then those 8 sums in order.
    """
    b, _, f = u.shape
    if rows is None or cols is None or blocks is None:
        plan = dwconv_bwd_plan(b, h, w, f, 4 if f % 4 == 0 else 1)
        rows, cols, blocks = (plan[k] if v is None else v for k, v in (
            ("rows", rows), ("cols", cols), ("blocks", blocks)))
    up = F.pad(u.reshape(b, h, w, f), (0, 0, 2, 2, 2, 2))
    gp = F.pad(g.reshape(b, h, w, f), (0, 0, 1, 1, 1, 1))
    gu = torch.empty(b, h, w, f, dtype=u.dtype)
    strips, col_tiles = -(-h // rows), -(-w // cols)
    tiles = [(i, s, c) for i in range(b) for s in range(strips)
             for c in range(col_tiles)]
    taps = [(dy, dx) for dy in range(3) for dx in range(3)]
    part = u.new_zeros(blocks, 10, f)
    for p in range(blocks):
        col_sums = u.new_zeros(cols, 10, f)  # column i's, over the tiles
        for i, s, c in tiles[p::blocks]:
            y0, x0 = s * rows, c * cols
            nr, nc = min(h, y0 + rows) - y0, min(w, x0 + cols) - x0
            # u at rows y0 - 2 .. y1 + 1 and columns x0 - 2 .. x1 + 1
            ut = up[i, y0:y0 + nr + 4, x0:x0 + nc + 4]
            pre = bdw + sum(ut[dy:dy + nr + 2, dx:dx + nc + 2] * wdw[dy, dx]
                            for dy, dx in taps)
            gd = gp[i, y0:y0 + nr + 2, x0:x0 + nc + 2] * _gelu_grad(pre)
            gu[i, y0:y0 + nr, x0:x0 + nc] = sum(
                gd[2 - dy:2 - dy + nr, 2 - dx:2 - dx + nc] * wdw[dy, dx]
                for dy, dx in taps)
            own = gd[1:-1, 1:-1]  # [nr, nc, f]
            for r in range(nr):
                for k, (dy, dx) in enumerate(taps):
                    col_sums[:nc, k] += ut[1 + dy + r, 1 + dx:1 + dx + nc] \
                        * own[r]
                col_sums[:nc, 9] += own[r]
        for i in range(cols):
            part[p] += col_sums[i]
    # the last pass: partials i, i + 8, ... in order, then the 8 runs
    runs = [sum(part[i::8], torch.zeros_like(part[0])) for i in range(8)]
    total = sum(runs[1:], runs[0])
    return gu.reshape(b, h * w, f), total[:9].reshape(3, 3, f), total[9]


@functools.lru_cache(maxsize=None)
def _partial_floats(b: int, h: int, w: int, f: int) -> int:
    """Floats of the backward's per-block tap and bias partials, as the
    kernel plans them at this shape."""
    return library().emip_dwconv_gelu_bwd_workspace(b, h, w, f)


def _check(u, wdw, bdw, h, w) -> None:
    """u and wdw in u's dtype (fp32 or bf16), bdw fp32."""
    cm.check_kernel_args(_NAME, u.dtype, u=u, wdw=wdw)
    cm.check_kernel_args(_NAME, bdw=bdw)
    if u.dim() != 3:
        raise ValueError(f"{_NAME}: u must be [B, H*W, F]")
    b, hw, f = u.shape
    if hw != h * w or min(b, h, w, f) < 1:
        raise ValueError(f"{_NAME}: u has {hw} tokens, expected {h} x {w}")
    if hw * f >= 2**31:
        raise ValueError(f"{_NAME}: an image of {hw} x {f} elements needs "
                         f"64-bit offsets")
    cm.check_shape(_NAME, "wdw", wdw, (3, 3, f))
    cm.check_shape(_NAME, "bdw", bdw, (f,))


class _DWConvGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, wdw, bdw, h, w, keep, library_forward):
        ctx.cpu = cm.on_cpu(_NAME, u, wdw, bdw)
        ctx.hw = (h, w)
        if keep:
            ctx.save_for_backward(u, wdw, bdw)
        if library_forward:
            if not ctx.cpu:
                _check(u, wdw, bdw, h, w)
            return _library_forward(u, wdw, bdw, h, w).contiguous()
        if ctx.cpu:
            return fused_dwconv_gelu_reference(u, wdw, bdw, h, w)
        _check(u, wdw, bdw, h, w)
        bf16 = u.dtype == torch.bfloat16
        out = torch.empty_like(u)
        fn = (library().emip_dwconv_gelu_bf16 if bf16
              else library().emip_dwconv_gelu)
        rc = fn(u.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), out.data_ptr(),
                u.shape[0], h, w, u.shape[2], cm.stream_handle(u.device))
        cm.raise_on_error(_NAME + (" (bf16)" if bf16 else ""), rc)
        cm.LAUNCHES["dwconv_gelu_bf16" if bf16 else "dwconv_gelu"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        u, wdw, bdw = ctx.saved_tensors
        h, w = ctx.hw
        bf16 = u.dtype == torch.bfloat16
        if ctx.cpu:
            # bf16: the fp32 VJP at the widened inputs, each grad rounded to
            # its input's dtype, as the JAX backward kernel computes it
            vjp = cm.plain_vjp_fp32 if bf16 else cm.plain_vjp
            grads = vjp(lambda *a: fused_dwconv_gelu_reference(*a, h, w),
                        (u, wdw, bdw), needs, g)
            return (*grads, None, None, None, None)
        g = g.contiguous()
        b, _, f = u.shape
        gu, gwdw, gbdw = (cm.empty_if(nd, t)
                          for nd, t in zip(needs, (u, wdw, bdw)))
        ws = None
        if gwdw is not None or gbdw is not None:
            ws = torch.empty(_partial_floats(b, h, w, f), device=u.device,
                             dtype=torch.float32)
        fn = (library().emip_dwconv_gelu_bwd_bf16 if bf16
              else library().emip_dwconv_gelu_bwd)
        rc = fn(u.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), g.data_ptr(),
                cm.ptr(gu), cm.ptr(gwdw), cm.ptr(gbdw), cm.ptr(ws),
                cm.numel(ws), b, h, w, f, cm.stream_handle(u.device))
        cm.raise_on_error(_NAME + " backward" + (" (bf16)" if bf16 else ""),
                          rc)
        cm.LAUNCHES["dwconv_gelu_bwd" + ("_bf16" if bf16 else "")] += 1
        return gu, gwdw, gbdw, None, None, None, None


def fused_dwconv_gelu(u: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor,
                      h: int, w: int,
                      library_forward: bool = False) -> torch.Tensor:
    """u: [B, H*W, F] tokens of an H x W image; wdw: [3, 3, F] depthwise
    taps (cross-correlation, zero padding); bdw: [F]. Returns [B, H*W, F].

    Differentiable in u, wdw and bdw; the backward recomputes the
    pre-activation and computes only the grads that are asked for. With
    ``library_forward`` the forward runs the library's convolution and GELU
    instead of the kernel; the backward is the kernel either way. bf16
    ``u`` and ``wdw`` with an fp32 ``bdw`` take the bf16 kernels: bf16 out,
    gu and gwdw bf16, gbdw fp32.
    """
    return _DWConvGelu.apply(u, wdw, bdw, h, w, cm.grad_wanted(u, wdw, bdw),
                             bool(library_forward))
