"""Plain PyTorch statement of what ``csrc/mma_tf32.cuh`` computes.

The CUDA kernels of the attention backward (kernels C and F) cannot run
without a card, so their arithmetic and their algorithm are written out
here in plain tensor code that the CPU tests hold against fp64 and against
``torch.autograd.grad`` of the plain versions:

* :func:`tf32_round` rounds fp32 to TF32 as ``cvt.rna.tf32.f32`` does and
  :func:`tf32_truncate` cuts it as the tensor core does to an operand's
  low bits; :func:`matmul_tf32` is one tensor-core product of rounded
  operands and :func:`matmul_3xtf32` the three-term product the kernels
  use.
* :func:`attention_row_stats` gives the row max and row sum a forward
  keeps, and :func:`attention_bwd_tiled` walks the two passes of
  ``attention_bwd_tc`` tile by tile (query-tiled dq; key-tiled dk and dv
  on transposed score tiles; ragged last tiles; the streamed side split in
  chunks whose partials are summed in order).

Nothing here runs on a model's path.
"""

from __future__ import annotations

import torch

__all__ = ["tf32_round", "tf32_truncate", "matmul_tf32", "matmul_3xtf32",
           "attention_row_stats", "attention_bwd_tiled"]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), nearest with ties away from zero,
    returned as fp32 with the low 13 mantissa bits cleared. Finite inputs."""
    bits = x.contiguous().view(torch.int32)
    # sign-magnitude: adding half an ulp to the magnitude rounds ties away
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 toward zero: what a tensor core makes of an fp32 bit
    pattern handed to it as a TF32 operand (it reads the upper 19 bits)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: rounded operands, fp32 sum."""
    return tf32_round(a) @ tf32_round(b)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products with an fp32 sum: with x = hi + lo,
    hi = tf32(x) rounded, lo = tf32(x - hi) truncated (the kernels hand the
    fp32 difference to the tensor core), the sum lo.hi + hi.lo + hi.hi
    (small terms first); the dropped lo.lo term is ~2^-22 of each
    product."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def attention_row_stats(q, k, bias=None):
    """(row max, row sum of exp(score - max)), each [B, Nq], of the scores
    q k^T / sqrt(C) (+ bias [B, Nk] per key): what a forward keeps."""
    scores = q @ k.transpose(-1, -2) / q.shape[-1]**0.5
    if bias is not None:
        scores = scores + bias[:, None, :]
    row_max = scores.max(-1).values
    return row_max, torch.exp(scores - row_max[..., None]).sum(-1)


def _chunks(n_tiles: int, splits: int):
    """Tile ranges of ``splits`` even chunks, none empty."""
    per = -(-n_tiles // max(1, min(splits, n_tiles)))
    return [(t, min(n_tiles, t + per)) for t in range(0, n_tiles, per)]


def attention_bwd_tiled(q, k, v, bias, out, row_max, row_sum, g,
                        which=(0, 1, 2), res_rows=64, stream_rows=64,
                        splits=1, matmul=torch.matmul):
    """(dq, dk, dv) of ``softmax(q k^T / sqrt(C) + bias) v`` for the
    cotangent ``g``, computed as ``attention_bwd_tc`` does; a grad whose
    index is not in ``which`` is None.

    q, g, out: [B, Nq, .]; k, v: [B, Nk, .]; bias [B, Nk] or None; row_max,
    row_sum [B, Nq] from the forward. A block owns ``res_rows`` rows of one
    side and streams the other in tiles of ``stream_rows``; with ``splits``
    > 1 the streamed tiles are cut in chunks whose partial sums are added
    in order. ``matmul`` is the product used for every tile
    (:func:`matmul_3xtf32` to follow the kernels' arithmetic).
    """
    b, nq, c = q.shape
    nk = k.shape[1]
    scale = 1.0 / c**0.5
    if bias is None:
        bias = q.new_zeros(b, nk)
    delta = (g * out).sum(-1)
    t = lambda x: x.transpose(-1, -2)  # noqa: E731

    dq = dk = dv = None
    if 0 in which:
        dq = torch.zeros_like(q)
        tiles = -(-nk // stream_rows)
        for q0 in range(0, nq, res_rows):
            rows = slice(q0, min(nq, q0 + res_rows))
            qt, gt = q[:, rows], g[:, rows]
            mx, inv = row_max[:, rows, None], 1.0 / row_sum[:, rows, None]
            dl = delta[:, rows, None]
            for t0, t1 in _chunks(tiles, splits):
                acc = torch.zeros_like(qt)
                for tile in range(t0, t1):
                    keys = slice(tile * stream_rows,
                                 min(nk, (tile + 1) * stream_rows))
                    kt, vt = k[:, keys], v[:, keys]
                    s = matmul(qt, t(kt)) * scale + bias[:, None, keys]
                    p = torch.exp(s - mx) * inv
                    ds = p * (matmul(gt, t(vt)) - dl)
                    acc = acc + matmul(ds, kt)
                dq[:, rows] += acc * scale
    if 1 in which or 2 in which:
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        tiles = -(-nq // stream_rows)
        for k0 in range(0, nk, res_rows):
            keys = slice(k0, min(nk, k0 + res_rows))
            kt, vt = k[:, keys], v[:, keys]
            for t0, t1 in _chunks(tiles, splits):
                acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
                for tile in range(t0, t1):
                    rows = slice(tile * stream_rows,
                                 min(nq, (tile + 1) * stream_rows))
                    qt, gt = q[:, rows], g[:, rows]
                    # transposed tiles: rows are keys, columns queries
                    st = matmul(kt, t(qt)) * scale + bias[:, keys, None]
                    pt = (torch.exp(st - row_max[:, None, rows])
                          / row_sum[:, None, rows])
                    dst = pt * (matmul(vt, t(gt)) - delta[:, None, rows])
                    acc_v = acc_v + matmul(pt, gt)
                    acc_k = acc_k + matmul(dst, qt)
                dk[:, keys] += acc_k * scale
                dv[:, keys] += acc_v
        dk = dk if 1 in which else None
        dv = dv if 2 in which else None
    return dq, dk, dv
