"""Kernel I: softmax(corr, -1) @ values over a stored correlation volume,
forward and backward.

Port of :func:`emip_tpu.ops.pallas.corr_softmax.softmax_expectation`; the
CUDA source is ``csrc/softmax_expectation.cu``. :func:`softmax_expectation`
is one ``torch.autograd.Function``: CPU tensors take the plain version (and
its autograd backward), CUDA tensors the forward and backward kernels. The
kernels read rows: a caller that wants the expectation along corr's other
axis passes a contiguous transpose.

The backward kernel cannot run without a card, so its algorithm is also
written out here in plain tensor code that the CPU tests hold against the
plain version's autograd and the Pallas VJP:
:func:`softmax_expectation_bwd_tiled` walks a row as the kernel holds it
(each thread's columns, the two reductions: a warp's butterfly, then the
warps in order), the block's dvalues partial kept per thread across its
run of rows, the ordered column sum of the partials, and the streaming
instantiation for rows longer than the register tile. It runs on no
model's path.
"""

from __future__ import annotations

import functools

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["softmax_expectation", "softmax_expectation_reference",
           "softmax_expectation_bwd_tiled"]

_NAME = "softmax_expectation"
_VALUE_WIDTH = 2
# csrc/softmax_expectation.cu: threads of a backward block, the floats a
# row may have to stay in their registers, and the SMs the blocks fill
BWD_THREADS = 256
BWD_TILE = 16 * BWD_THREADS
_SM_COUNT = 132


def softmax_expectation_reference(corr, values) -> torch.Tensor:
    """Plain PyTorch version of :func:`softmax_expectation`."""
    return torch.softmax(corr, dim=-1) @ values


def _bwd_plan(rows: int, n: int, vec: bool, max_blocks: int | None):
    """(floats a load, loads a thread, blocks, rows a block) as the
    backward kernel plans them; 0 loads: the streaming instantiation."""
    v = p = 0
    if n <= BWD_TILE:
        if vec:
            v, p = 4, -(-n // (4 * BWD_THREADS))
        else:
            v, p = 1, next(k for k in (4, 8, 16) if n <= k * BWD_THREADS)
    if max_blocks is None:
        max_blocks = ((3 if v * p <= 8 else 2) if v else 4) * _SM_COUNT
    blocks = min(rows, max_blocks)
    per = -(-rows // blocks)
    return v, p, -(-rows // per), per


def _butterfly(x: torch.Tensor, op) -> torch.Tensor:
    """A warp's xor-shuffle reduction over the last axis (32 lanes): every
    lane ends with the same value."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = op(x, x[..., lane ^ o])
    return x


def _block_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """[..., threads] -> [...]: the warps' butterflies, then the warps'
    results in order, as every thread of the block reads them."""
    warps = _butterfly(x.reshape(*x.shape[:-1], -1, 32), op)[..., 0]
    total = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        total = op(total, warps[..., w])
    return total


def _colsum(part: torch.Tensor) -> torch.Tensor:
    """Sum of the rows of ``part`` [rows, C] in the order of the column sum
    of ``csrc/primitives.cuh``: chunks of rows, eight interleaved runs in a
    chunk, then the chunks."""
    rows = part.shape[0]
    chunks = min(256, max(1, -(-rows // 64)))
    per = -(-rows // chunks)
    out = torch.zeros_like(part[0])
    for r0 in range(0, rows, per):
        t = torch.zeros_like(part[0])
        for j in range(8):
            s = torch.zeros_like(part[0])
            for r in range(r0 + j, min(rows, r0 + per), 8):
                s = s + part[r]
            t = t + s
        out = out + t
    return out


def _merge(a, b):
    """Two online-softmax states (max, sum, two value sums) as one."""
    m = torch.maximum(a[0], b[0])
    ca = torch.where(a[0] == -torch.inf, 0.0, torch.exp(a[0] - m))
    cb = torch.where(b[0] == -torch.inf, 0.0, torch.exp(b[0] - m))
    return (m, *(x * ca + y * cb for x, y in zip(a[1:], b[1:])))


def softmax_expectation_bwd_tiled(corr, values, g, vec: bool | None = None,
                                  max_blocks: int | None = None):
    """The backward kernel's algorithm in plain tensor code, for the CPU
    tests: (dcorr, dvalues) of :func:`softmax_expectation` for the
    cotangent ``g`` [B, M, 2].

    Rows of up to :data:`BWD_TILE` floats sit in the register tile: thread
    t owns the loads t, t + 256, ... of ``vec`` floats (4 by default where
    N is a multiple of 4, else 1), the same columns on every row; the max
    is one block reduction, the sum of e = exp(x - max) and of e v a
    second, each a warp's butterfly and then the warps in order; g . out
    comes from the row's own sums. Each thread keeps its columns' p g over
    its block's run of rows, and the blocks' partials (``max_blocks`` of
    them at most; by default as the kernel plans them) are added by the
    ordered column sum. Longer rows take the streaming instantiation: an
    online softmax over each thread's strided elements, merged the same
    way, then dcorr and the partial, row after row.
    """
    b, m, n = corr.shape
    rows = b * m
    x = corr.reshape(rows, n).float()
    gr = g.reshape(rows, 2).float()
    vals = values.float()
    if vec is None:
        vec = n % 4 == 0
    v, p, blocks, per = _bwd_plan(rows, n, vec, max_blocks)
    t = BWD_THREADS
    if v:
        # [rows, threads, slots]: slot k * v + e of thread t is column
        # v * (t + k * threads) + e
        cols = v * p * t
        own = lambda a, fill: torch.nn.functional.pad(  # noqa: E731
            a, (0, cols - n), value=fill).reshape(
                *a.shape[:-1], p, t, v).transpose(-3, -2).reshape(
                    *a.shape[:-1], t, p * v)
        xt = own(x, -torch.inf)
        vx, vy = own(vals[:, 0], 0.0), own(vals[:, 1], 0.0)
        mx = _block_reduce(xt.amax(-1), torch.maximum)
        e = torch.exp(xt - mx[:, None, None])
        sums = []
        for w in (None, vx, vy):
            acc = torch.zeros(rows, t)
            for i in range(p * v):
                acc = acc + (e[..., i] if w is None else e[..., i] * w[:, i])
            sums.append(_block_reduce(acc, torch.add))
        s, a0, a1 = sums
        inv = 1.0 / s
        inner = (gr[:, 0] * a0 + gr[:, 1] * a1) * inv
        prob = e * inv[:, None, None]
        d = prob * (gr[:, 0, None, None] * vx + gr[:, 1, None, None] * vy
                    - inner[:, None, None])
        back = lambda a: a.reshape(rows, t, p, v).transpose(  # noqa: E731
            1, 2).reshape(rows, cols)[:, :n]
        prob, dcorr = back(prob), back(d)
    else:
        xs = torch.nn.functional.pad(x, (0, -n % t), value=-torch.inf)
        xs = xs.reshape(rows, -1, t)  # [rows, k, thread]: column k t + thread
        vp = torch.nn.functional.pad(vals.T, (0, -n % t)).reshape(2, -1, t)
        zero = torch.zeros(rows, t)
        state = (torch.full((rows, t), -torch.inf), zero, zero, zero)
        for k in range(xs.shape[1]):
            el = xs[:, k]
            state = _merge(state, (el, torch.ones_like(el), vp[0, k],
                                   vp[1, k]))
        lane = torch.arange(32)
        st = tuple(a.reshape(rows, -1, 32) for a in state)
        for o in (16, 8, 4, 2, 1):
            st = _merge(st, tuple(a[..., lane ^ o] for a in st))
        st = tuple(a[..., 0] for a in st)
        mx, s, a0, a1 = (a[:, 0] for a in st)
        tot = (mx, s, a0, a1)
        for w in range(1, st[0].shape[1]):
            tot = _merge(tot, tuple(a[:, w] for a in st))
        mx, s, a0, a1 = tot
        inv = 1.0 / s
        inner = (gr[:, 0] * a0 + gr[:, 1] * a1) * inv
        prob = torch.exp(x - mx[:, None]) * inv[:, None]
        dcorr = prob * (gr[:, :1] * vals[:, 0] + gr[:, 1:] * vals[:, 1]
                        - inner[:, None])
    # each block's partial, row after row of its run, then in order
    part = torch.zeros(blocks, n, 2)
    for j in range(per):
        rs = torch.arange(blocks) * per + j
        ok = rs < rows
        pg = prob[rs.clamp(max=rows - 1), :, None] * gr[rs.clamp(
            max=rows - 1), None, :]
        part = part + torch.where(ok[:, None, None], pg, 0.0)
    dvalues = _colsum(part.reshape(blocks, 2 * n)).reshape(n, 2)
    return dcorr.reshape(b, m, n), dvalues


@functools.lru_cache(maxsize=None)
def _workspace_floats(rows: int, n: int) -> int:
    """Floats of the backward's dvalues partials and their column sum, as
    the kernel plans them at this shape."""
    return library().emip_softmax_expectation_bwd_workspace(rows, n)


def _check(corr, values) -> None:
    cm.check_kernel_args(_NAME, corr=corr, values=values)
    if corr.dim() != 3:
        raise ValueError(f"{_NAME}: corr must be [B, M, N]")
    if corr.shape[-1] == 0:
        raise ValueError(f"{_NAME}: empty softmax axis")
    cm.check_shape(_NAME, "values", values, (corr.shape[-1], _VALUE_WIDTH))


class _SoftmaxExpectation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr, values, keep):
        ctx.cpu = cm.on_cpu(_NAME, corr, values)
        if keep:
            ctx.save_for_backward(corr, values)
        if ctx.cpu:
            return softmax_expectation_reference(corr, values)
        _check(corr, values)
        b, m, n = corr.shape
        out = torch.empty((b, m, _VALUE_WIDTH), device=corr.device,
                          dtype=corr.dtype)
        rc = library().emip_softmax_expectation(
            corr.data_ptr(), values.data_ptr(), out.data_ptr(), b * m, n,
            cm.stream_handle(corr.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["softmax_expectation"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:2]
        corr, values = ctx.saved_tensors
        if ctx.cpu:
            return (*cm.plain_vjp(softmax_expectation_reference,
                                  (corr, values), needs, g), None)
        g = g.contiguous()
        b, m, n = corr.shape
        dcorr, dvalues = (cm.empty_if(nd, t)
                          for nd, t in zip(needs, (corr, values)))
        ws = None
        if dvalues is not None:
            ws = torch.empty(_workspace_floats(b * m, n), device=corr.device,
                             dtype=torch.float32)
        rc = library().emip_softmax_expectation_bwd(
            corr.data_ptr(), values.data_ptr(), g.data_ptr(), cm.ptr(dcorr),
            cm.ptr(dvalues), cm.ptr(ws), cm.numel(ws), b * m, n,
            cm.stream_handle(corr.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["softmax_expectation_bwd"] += 1
        return dcorr, dvalues, None


def softmax_expectation(corr: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """corr: [B, M, N]; values: [N, 2]. Returns [B, M, 2] (fp32).

    Differentiable in corr and values; the backward recomputes the
    probabilities and computes only the grads that are asked for.
    """
    return _SoftmaxExpectation.apply(corr, values,
                                     cm.grad_wanted(corr, values))
