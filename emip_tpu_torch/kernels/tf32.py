"""Plain PyTorch statement of what ``csrc/mma_tf32.cuh`` and
``csrc/gemm_tf32.cuh`` compute.

The CUDA kernels on the tensor cores (the attention forward and backward
of kernels A, B, C, F, G and H, and the GEMM of A, B, G and H) cannot run without a card, so their arithmetic and their
algorithm are written out here in plain tensor code that the CPU tests
hold against fp64, the plain versions, ``torch.autograd.grad`` of them
and the JAX package's Pallas kernels:

* :func:`tf32_round` rounds fp32 to TF32 as ``cvt.rna.tf32.f32`` does and
  :func:`tf32_truncate` cuts it as the tensor core does to an operand's
  low bits; :func:`matmul_tf32` is one tensor-core product of rounded
  operands and :func:`matmul_3xtf32` the three-term product the kernels
  use; :func:`matmul_3xtf32_exact` leaves out the terms of an operand
  that is exact in TF32 (a bf16 one), as the kernels do with bf16
  operands, and equals :func:`matmul_3xtf32` on such operands.
* :func:`gemm_tiled` walks the GEMM: K in tiles of 32, the split-K
  partials summed in order, then the epilogue (bias, exact GELU or its
  derivative).
* :func:`attention_fwd_tiled` walks ``attention_fwd_tc`` tile by tile
  (streamed key tiles, the online max and sum, ragged last tiles, the
  keys split in chunks whose partials are merged in order by their max
  and sum), per head and with an additive score mask where the kernels of
  A, B, G and H have them;
* :func:`attention_row_stats` gives the row max and row sum a forward
  keeps, and :func:`attention_bwd_tiled` walks the two passes of
  ``attention_bwd_tc`` tile by tile (query-tiled dq; key-tiled dk and dv
  on transposed score tiles; ragged last tiles; the streamed side split in
  chunks whose partials are summed in order), per head and with an
  additive score mask where the kernels of A, B, G and H have them.
* :func:`flow_attention_bwd_bf16_walk`, :func:`sr_attention_bwd_bf16_walk`,
  :func:`memory_attention_bwd_bf16_walk` and
  :func:`window_block_bwd_bf16_walk` walk the bf16 backwards of kernels C,
  A, F and B: bf16 operands read as they are, each product counting its
  TF32 terms by its operands' exactness, and the bf16 grads rounded once
  where the kernels' epilogues round them.
* :func:`sr_attention_fwd_bf16_walk` walks kernel A's fused bf16 forward
  (``emip_sr_attention_bf16``; bf16 products on the tensor cores, fp32
  sums): per head q from K tiles of 32, the online softmax over key tiles
  of 32 with P rounded to bf16, o rounded, the output columns by head.
* :func:`wgmma_linear_walk` walks the wgmma product of B's and H's bf16
  forwards (``csrc/gemm_wgmma.cuh``): sources in order along K, K tiles of
  32 each summed on its own and folded into the running sum, two TF32
  terms where the source is bf16, three where fp32, then the epilogue
  (GELU, a row LayerNorm, or LayerNorm + residual rounded to bf16 once);
  :func:`window_ffn_bf16_walk` walks H's bf16 forward on it
  (``cross_ffn_bf16``: q, k, v, the 3xTF32 attention, msg in Wm's
  LayerNorm epilogue, W0 in two halves, out in W2's epilogue) and
  :func:`window_block_fwd_bf16_walk` B's: the unchanged bf16 self layer,
  then that walk on its x1.
* :func:`attention_bf16_walk` walks the bf16 attention of C, G and B's
  self layer (``csrc/attention_bf16.cu``): key tiles of 64, the running
  max and sum, P rounded to bf16 unnormalised for P v where v is bf16, P v
  in fp32 where v is C's 2-wide fp32; :func:`window_layer_fwd_bf16_walk`
  walks G's bf16 forward on it (``emip_window_layer_bf16``): q, k, v as one
  bf16 product rounded to bf16, the attention walk, then o Wm^T with LN1,
  the rounding of msg, the residual and the last rounding in its epilogue.
* :func:`memory_attention_fwd_bf16_walk` walks F's bf16 forward
  (``emip_memory_attention_bf16``): :func:`bf16_parts` splits each fp32
  value of the ring exactly into three bf16 parts, :func:`matmul_bf16x3`
  sums a bf16 operand's products with them (lo, mid, hi) in fp32, and
  :func:`attention_fwd_tiled` walks the keys in tiles of 32 with P rounded
  to bf16 for P v, the keys split as :func:`key_splits` plans them and the
  partials merged in order, keeping the row max and sum.
* :func:`window_layer_bwd_bf16_walk` and
  :func:`window_ffn_layer_bwd_bf16_walk` walk G's and H's bf16 backwards
  (``emip_window_layer_bwd_bf16``, ``emip_window_ffn_layer_bwd_bf16``):
  the recompute and the input grads go, gt and gh W0 on the wgmma product
  (:func:`wgmma_linear_walk`, dy W on the transposed weight), gx and H's
  gh on the GEMM (:func:`gemm_tiled`), the 3xTF32 attention keeping its
  row statistics and its backward, the weight grads on the GEMM, gx and gt
  rounded once in their products' epilogues.

Nothing here runs on a model's path.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

__all__ = ["tf32_round", "tf32_truncate", "matmul_tf32", "matmul_3xtf32",
           "matmul_3xtf32_exact", "gemm_tiled", "attention_fwd_tiled",
           "attention_row_stats", "attention_bwd_tiled",
           "flow_attention_bwd_bf16_walk", "sr_attention_bwd_bf16_walk",
           "memory_attention_bwd_bf16_walk", "window_block_bwd_bf16_walk",
           "sr_attention_fwd_bf16_walk", "wgmma_linear_walk",
           "window_ffn_bf16_walk", "window_block_fwd_bf16_walk",
           "window_layer_bwd_bf16_walk", "window_ffn_layer_bwd_bf16_walk",
           "attention_bf16_walk", "window_layer_fwd_bf16_walk",
           "bf16_parts", "matmul_bf16x3", "key_splits",
           "memory_attention_fwd_bf16_walk"]


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


def matmul_3xtf32_exact(a: torch.Tensor, b: torch.Tensor,
                        a_exact: bool = False,
                        b_exact: bool = False) -> torch.Tensor:
    """:func:`matmul_3xtf32` with the terms of an exact operand left out,
    as ``mma_3xtf32`` does with ``A_EXACT`` / ``B_EXACT``: an operand whose
    values are exact in TF32 (a bf16 value is) is its own hi and its lo is
    zero, so a.lo b.hi (``a_exact``) or a.hi b.lo (``b_exact``) adds
    nothing; with both exact one TF32 product is left. On such operands
    it equals :func:`matmul_3xtf32`."""
    a_hi = a if a_exact else tf32_round(a)
    b_hi = b if b_exact else tf32_round(b)
    small = []
    if not a_exact:
        small.append(tf32_truncate(a - a_hi) @ b_hi)
    if not b_exact:
        small.append(a_hi @ tf32_truncate(b - b_hi))
    big = a_hi @ b_hi
    return big if not small else sum(small[1:], small[0]) + big


def _split_heads(x, heads: int):
    """[B, N, H * W] -> [B * H, N, W]: batch row z = b * H + h is head h of
    batch b, read at columns h * W, as the kernels read it."""
    b, n, c = x.shape
    return (x.reshape(b, n, heads, c // heads).transpose(1, 2)
            .reshape(b * heads, n, c // heads))


def _merge_heads(x, heads: int):
    """Inverse of :func:`_split_heads`."""
    z, n, w = x.shape
    return (x.reshape(z // heads, heads, n, w).transpose(1, 2)
            .reshape(z // heads, n, heads * w))


def _score_terms(b: int, heads: int, nq: int, nk: int, bias, mask, like):
    """Per batch row z = b * H + h: the key bias [B * H, Nk] (from [B, Nk])
    and the score mask [B * H, Nq, Nk] (window b reads mask[b % nw])."""
    if bias is None:
        bias = like.new_zeros(b, nk)
    bias = bias.repeat_interleave(heads, 0)
    if mask is None:
        return bias, like.new_zeros(1, 1, 1).expand(b * heads, nq, nk)
    windows = torch.arange(b, device=mask.device) % mask.shape[0]
    return bias, mask[windows].repeat_interleave(heads, 0)


def attention_row_stats(q, k, bias=None, heads: int = 1, mask=None):
    """(row max, row sum of exp(score - max)), each [B * H, Nq], of the
    scores q_h k_h^T / sqrt(W) (+ bias [B, Nk] per key, + mask [nw, Nq, Nk]
    with batch b reading mask[b % nw]) of every head h of width W: what a
    forward keeps."""
    b, nq, _ = q.shape
    bias, mask = _score_terms(b, heads, nq, k.shape[1], bias, mask, q)
    qh, kh = _split_heads(q, heads), _split_heads(k, heads)
    scores = (qh @ kh.transpose(-1, -2) / qh.shape[-1]**0.5
              + bias[:, None, :] + mask)
    row_max = scores.max(-1).values
    return row_max, torch.exp(scores - row_max[..., None]).sum(-1)


def gemm_tiled(a, b, bias=None, tile_k: int = 32, splits: int = 1,
               matmul=torch.matmul, epilogue: str | None = None, aux=None):
    """``a @ b (+ bias)`` computed as ``gemm_tc_kernel`` does; returns the
    product, or with ``epilogue="gelu"`` the pair (gelu(y), y), and with
    ``epilogue="gelu_grad"`` y * gelu'(aux).

    K is walked in tiles of ``tile_k``, each tile's product added to an
    fp32 accumulator; with ``splits`` > 1 the tiles are cut in chunks (a
    weight gradient's split-K), each chunk summed on its own and the
    partials added in order, the bias left out (the kernels give a split
    product none). ``matmul`` is each tile's product
    (:func:`matmul_3xtf32` to follow the kernel's arithmetic). The order of
    the sums inside one tile is the tensor core's and is not stated.
    """
    k = a.shape[1]
    tiles = -(-k // tile_k)
    parts = []
    for t0, t1 in _chunks(tiles, splits):
        acc = a.new_zeros(a.shape[0], b.shape[1])
        for tile in range(t0, t1):
            ks = slice(tile * tile_k, min(k, (tile + 1) * tile_k))
            acc = acc + matmul(a[:, ks], b[ks])
        parts.append(acc)
    out = sum(parts[1:], parts[0])
    if bias is not None:
        out = out + bias
    if epilogue == "gelu":
        return torch.nn.functional.gelu(out), out
    if epilogue == "gelu_grad":
        return out * _gelu_grad(aux)
    return out


def _gelu_grad(h):
    """``gelu_grad`` of primitives.cuh: d/dh of the exact GELU."""
    phi = torch.exp(-0.5 * h * h) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(h * 0.7071067811865476)) + h * phi


def _chunks(n_tiles: int, splits: int):
    """Tile ranges of ``splits`` even chunks, none empty."""
    per = -(-n_tiles // max(1, min(splits, n_tiles)))
    return [(t, min(n_tiles, t + per)) for t in range(0, n_tiles, per)]


def attention_fwd_tiled(q, k, v, bias=None, stream_rows=32, splits=1,
                        matmul=torch.matmul, keep_stats=False,
                        heads: int = 1, mask=None):
    """``softmax(q k^T / sqrt(W) + bias + mask) v`` per head computed as
    ``attention_fwd_tc`` does; with ``keep_stats`` also the row max and row
    sum ([B * H, Nq] each) it keeps for the backward.

    q: [B, Nq, H * W]; k, v: [B, Nk, H * .], head h at columns h * width
    (batch row z = b * H + h, as the kernel reads it); bias [B, Nk] or
    None; mask [nw, Nq, Nk] or None (batch b reads mask[b % nw]). Query
    rows are independent, so the kernel's resident query tiles change no
    bit and every row is walked at once. The keys stream in tiles of
    ``stream_rows`` (the last one ragged, its missing keys at -inf) with a
    running max m and sum l: per tile m' = max(m, rowmax S), l = l e^(m -
    m') + rowsum e^(S - m'), O = O e^(m - m') + e^(S - m') v. With
    ``splits`` > 1 the key tiles are cut in chunks, each chunk's output
    normalised by its own sum, and the chunks merged in order with weights
    l_z e^(m_z - max m). ``matmul`` is the product of q k^T and, with a
    value as wide as the keys, of P v (:func:`matmul_3xtf32` to follow the
    kernel's arithmetic); a 2-wide value's P v runs in fp32, as on the CUDA
    cores.
    """
    b, nq, _ = q.shape
    nk = k.shape[1]
    bias, mask = _score_terms(b, heads, nq, nk, bias, mask, q)
    q, k, v = (_split_heads(x, heads) for x in (q, k, v))
    scale = 1.0 / q.shape[-1]**0.5
    pv = matmul if v.shape[-1] == q.shape[-1] else torch.matmul
    tiles = -(-nk // stream_rows)
    parts = []
    for t0, t1 in _chunks(tiles, splits):
        m = q.new_full(q.shape[:2], float("-inf"))
        l = q.new_zeros(q.shape[:2])
        acc = q.new_zeros(*q.shape[:2], v.shape[-1])
        for tile in range(t0, t1):
            keys = slice(tile * stream_rows,
                         min(nk, (tile + 1) * stream_rows))
            s = (matmul(q, k[:, keys].transpose(-1, -2)) * scale
                 + bias[:, None, keys] + mask[:, :, keys])
            m_new = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + pv(p, v[:, keys])
            m = m_new
        parts.append((acc / l[..., None], m, l))
    if len(parts) == 1:
        out, m, l = parts[0]
    else:
        m = torch.stack([p[1] for p in parts]).max(0).values
        w = [pl * torch.exp(pm - m) for _, pm, pl in parts]
        l = sum(w[1:], w[0])
        out = sum((wz[..., None] * pz for wz, (pz, _, _) in
                   zip(w[1:], parts[1:])), w[0][..., None] * parts[0][0])
        out = out / l[..., None]
    out = _merge_heads(out, heads)
    return (out, m, l) if keep_stats else out


def attention_bwd_tiled(q, k, v, bias, out, row_max, row_sum, g,
                        which=(0, 1, 2), res_rows=64, stream_rows=64,
                        splits=1, matmul=torch.matmul, heads: int = 1,
                        mask=None, matmul_qk=None, matmul_dsk=None,
                        matmul_kq=None, matmul_dsq=None):
    """(dq, dk, dv) of ``softmax(q k^T / sqrt(W) + bias + mask) v`` per
    head for the cotangent ``g``, computed as ``attention_bwd_tc`` does; a
    grad whose index is not in ``which`` is None.

    q, g, out: [B, Nq, H * .]; k, v: [B, Nk, H * .], head h at columns h *
    width (W = q's width / H); bias [B, Nk] or None; mask [nw, Nq, Nk] or
    None (batch b reads mask[b % nw]); row_max, row_sum [B * H, Nq] from
    the forward. Batch row z = b * H + h is head h of batch b. A block
    owns ``res_rows`` rows of one side and streams the other in tiles of
    ``stream_rows``; with ``splits`` > 1 the streamed tiles are cut in
    chunks whose partial sums are added in order. ``matmul`` is the product
    used for every tile (:func:`matmul_3xtf32` to follow the kernels'
    arithmetic); ``matmul_qk`` (the scores q k^T) and ``matmul_dsk`` (dS k
    and dS^T q, the B operand k or q), where given, take the place of
    ``matmul`` in those products; ``matmul_kq`` (the key-tiled pass's
    scores k q^T) and ``matmul_dsq`` (its dS^T q), where given, take the
    place of those two in the key-tiled pass.
    """
    mm_qk = matmul_qk or matmul
    mm_dsk = matmul_dsk or matmul
    mm_kq = matmul_kq or mm_qk
    mm_dsq = matmul_dsq or mm_dsk
    b, nq, _ = q.shape
    nk = k.shape[1]
    bias, mask = _score_terms(b, heads, nq, nk, bias, mask, q)
    q, k, v, out, g = (_split_heads(x, heads) for x in (q, k, v, out, g))
    scale = 1.0 / q.shape[-1]**0.5
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
                    s = (mm_qk(qt, t(kt)) * scale + bias[:, None, keys]
                         + mask[:, rows, keys])
                    p = torch.exp(s - mx) * inv
                    ds = p * (matmul(gt, t(vt)) - dl)
                    acc = acc + mm_dsk(ds, kt)
                dq[:, rows] += acc * scale
        dq = _merge_heads(dq, heads)
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
                    st = (mm_kq(kt, t(qt)) * scale + bias[:, keys, None]
                          + t(mask[:, rows, keys]))
                    pt = (torch.exp(st - row_max[:, None, rows])
                          / row_sum[:, None, rows])
                    dst = pt * (matmul(vt, t(gt)) - delta[:, None, rows])
                    acc_v = acc_v + matmul(pt, gt)
                    acc_k = acc_k + mm_dsq(dst, qt)
                dk[:, keys] += acc_k * scale
                dv[:, keys] += acc_v
        dk = _merge_heads(dk, heads) if 1 in which else None
        dv = _merge_heads(dv, heads) if 2 in which else None
    return dq, dk, dv


def _exact(a_exact: bool, b_exact: bool):
    """The three-term product with exact operands' terms left out."""
    return functools.partial(matmul_3xtf32_exact, a_exact=a_exact,
                             b_exact=b_exact)


def flow_attention_bwd_bf16_walk(q, k, v, out, g, which=(0, 1),
                                 res_rows=64, stream_rows=64, splits=1,
                                 stat_rows=32, stat_splits=1, stats=None):
    """(dq, dk, dv) of kernel C's bf16 backward (``emip_flow_attention_bwd_
    bf16``): q, k [B, L, C] bf16, read as they are; v, out (the bf16
    forward's) and the cotangent g [B, L, 2] fp32. A grad not in ``which``
    is None.

    The row statistics come from a pass of the fp32 forward's tiling on the
    bf16 q and k (keys streamed in tiles of ``stat_rows``, split in
    ``stat_splits`` chunks merged in order) whose scores are one TF32
    product (both operands exact), or from ``stats`` (row max, row sum)
    where given. The backward is :func:`attention_bwd_tiled` with the
    scores one TF32 product and dS k, dS^T q two (k and q exact), the rest
    three; dq and dk rounded to bf16 once, dv fp32. Every product equals
    its three-term form on these operands, so the grads are those of the
    fp32 backward on the upcast q and k, rounded.
    """
    q32, k32 = q.float(), k.float()
    if stats is None:
        _, row_max, row_sum = attention_fwd_tiled(
            q32, k32, v, stream_rows=stat_rows, splits=stat_splits,
            matmul=_exact(True, True), keep_stats=True)
    else:
        row_max, row_sum = stats
    dq, dk, dv = attention_bwd_tiled(
        q32, k32, v, None, out, row_max, row_sum, g, which=which,
        res_rows=res_rows, stream_rows=stream_rows, splits=splits,
        matmul=matmul_3xtf32, matmul_qk=_exact(True, True),
        matmul_dsk=_exact(False, True))
    bf16 = torch.bfloat16
    return (None if dq is None else dq.to(bf16),
            None if dk is None else dk.to(bf16), dv)


def sr_attention_bwd_bf16_walk(x, kv_in, wq, bq, wkv, bkv, wp, bp,
                               heads: int, g, res_rows=64, stream_rows=32,
                               key_splits=1, wgrad_splits=1):
    """The 8 grads (torch layout) of kernel A's bf16 backward
    (``emip_sr_attention_bwd_bf16``): x [B, N, C], kv_in [B, M, C], the
    weights and the cotangent g [B, N, C] bf16, the biases fp32.

    The forward recomputed up to o and the row statistics: q and [k | v]
    GEMMs (:func:`gemm_tiled`, K in tiles of 32) of two bf16 operands, one
    TF32 product; the attention forward (keys in tiles of ``stream_rows``,
    split in ``key_splits``) in three-term products on the fp32 q, k, v;
    no output projection. The backward: gWp = g^T o and go = g Wp (g bf16:
    two products, and one with the bf16 Wp); the attention backward
    (``res_rows`` resident rows, streamed tiles of ``stream_rows``) in
    three-term products; gWq = gq^T x, gWkv = gkv^T kv_in, gx = gq Wq and
    g_kv_in = gkv Wkv with the bf16 operand exact, two products. The weight
    grads split K in ``wgrad_splits`` chunks summed in order; gx, g_kv_in
    and the weight grads rounded to bf16 once, the bias grads fp32 column
    sums. Every product equals its three-term form on these operands, so
    the grads are those of the fp32 backward on the upcast inputs, rounded.
    """
    b, n, c = x.shape
    m = kv_in.shape[1]
    bf16 = torch.bfloat16
    x2, kv2, g2 = (t.float().reshape(-1, c) for t in (x, kv_in, g))
    wq, wkv, wp = wq.float(), wkv.float(), wp.float()
    gemm = gemm_tiled
    both, a_ex, b_ex = _exact(True, True), _exact(True, False), _exact(
        False, True)
    q = gemm(x2, wq.T, bq, matmul=both).reshape(b, n, c)
    kv = gemm(kv2, wkv.T, bkv, matmul=both).reshape(b, m, 2 * c)
    k, v = kv[..., :c], kv[..., c:]
    o, row_max, row_sum = attention_fwd_tiled(
        q, k, v, stream_rows=stream_rows, splits=key_splits,
        matmul=matmul_3xtf32, keep_stats=True, heads=heads)
    o2 = o.reshape(-1, c)
    gwp = gemm(g2.T, o2, splits=wgrad_splits, matmul=a_ex)
    gbp = g2.sum(0)
    go = gemm(g2, wp, matmul=both).reshape(b, n, c)
    dq, dk, dv = attention_bwd_tiled(
        q, k, v, None, o, row_max, row_sum, go, res_rows=res_rows,
        stream_rows=stream_rows, matmul=matmul_3xtf32, heads=heads)
    gq2 = dq.reshape(-1, c)
    gkv2 = torch.cat([dk, dv], -1).reshape(-1, 2 * c)
    gwq = gemm(gq2.T, x2, splits=wgrad_splits, matmul=b_ex)
    gwkv = gemm(gkv2.T, kv2, splits=wgrad_splits, matmul=b_ex)
    gx = gemm(gq2, wq, matmul=b_ex).reshape(b, n, c)
    gkv_in = gemm(gkv2, wkv, matmul=b_ex).reshape(b, m, c)
    return (gx.to(bf16), gkv_in.to(bf16), gwq.to(bf16), gq2.sum(0),
            gwkv.to(bf16), gkv2.sum(0), gwp.to(bf16), gbp)


def memory_attention_bwd_bf16_walk(q, k, v, bias, out, g, which=(0, 1, 2),
                                   res_rows=64, stream_rows=64, splits=1,
                                   stats=None):
    """(dq, dk, dv) of kernel F's bf16 backward (``emip_memory_attention_
    bwd_bf16``): q [B, M, C] bf16, read as it is; k, v [B, N, C], the key
    bias [B, N], out (the bf16 forward's) and the cotangent g [B, M, C]
    fp32. A grad not in ``which`` is None.

    The row statistics are ``stats`` (row max, row sum; the bf16 forward
    keeps those of the unrounded scores), or :func:`attention_row_stats`
    on the upcast q. The backward is :func:`attention_bwd_tiled` with the
    scores q k^T (both passes) and dS^T q two TF32 products (q exact),
    dO v^T, dS k and P^T dO three; dq rounded to bf16 once, dk and dv
    fp32. Every product equals its three-term form on these operands, so
    the grads are those of the fp32 backward on the upcast q, rounded.
    """
    q32 = q.float()
    row_max, row_sum = (attention_row_stats(q32, k, bias) if stats is None
                        else stats)
    dq, dk, dv = attention_bwd_tiled(
        q32, k, v, bias, out, row_max, row_sum, g, which=which,
        res_rows=res_rows, stream_rows=stream_rows, splits=splits,
        matmul=matmul_3xtf32, matmul_qk=_exact(True, False),
        matmul_kq=_exact(False, True), matmul_dsq=_exact(False, True))
    return (None if dq is None else dq.to(torch.bfloat16), dk, dv)


def _ln_bwd(x, dy, gamma, eps):
    """``layernorm_bwd`` of primitives.cuh: dx, dgamma, dbeta."""
    mu = x.mean(-1, keepdim=True)
    inv = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)
    xh = (x - mu) * inv
    gg = dy * gamma
    dx = inv * (gg - gg.mean(-1, keepdim=True)
                - xh * (gg * xh).mean(-1, keepdim=True))
    return dx, (dy * xh).sum(0), dy.sum(0)


def window_block_bwd_bf16_walk(x, t, self_params, cross_params, g,
                               mask=None, weights=True, eps=1e-6,
                               stream_rows=16, key_splits=2, res_rows=16,
                               wgrad_splits=3):
    """(gx, gt, self grads, cross grads) of kernel B's bf16 backward
    (``emip_window_block_bwd_bf16``): x, t and the cotangent g [B, K2, T, C]
    bf16, read as they are; the parameters fp32 in torch's layout (wq ..
    wm [C, C], s1, b1 [C]; the cross layer also w0 [F, 2C], w2 [C, F], s2,
    b2), mask [K2, T, T] or None. gx and gt bf16, the grads (dicts by the
    parameters' names, empty without ``weights``) fp32.

    The forward recomputed as the kernel recomputes it: the self layer on
    x (the projections x Wq, x Wk, x Wv two TF32 products, x exact),
    x1 = bf16(x + bf16(LN1s(m1))), the cross layer (x1 Wq, t Wk, t Wv two
    products: x1 holds bf16 values), the FFN; GEMMs through
    :func:`gemm_tiled` (K in tiles of 32), each attention through
    :func:`attention_fwd_tiled` (keys in tiles of ``stream_rows``, split
    in ``key_splits``) keeping its row statistics. The backward: LN2's
    backward on g, gx1 = g + (gh W0)[:, :C], each layer's attention
    backward (:func:`attention_bwd_tiled`, ``res_rows`` resident rows,
    streamed tiles of ``stream_rows``), the weight grads of the products
    of x, t and x1 two TF32 products (split-K in ``wgrad_splits`` chunks
    summed in order), every other product three ([x1, msg] W0^T and its
    grad one product over both halves); gt = bf16([gk | gv] [Wk; Wv]) and
    gx = bf16(gx1 + [gq | gk | gv] [Wq; Wk; Wv]), each rounded once.
    Every product equals its three-term form on these operands, so the
    grads are those of the fp32 backward on the upcast inputs, rounded.
    """
    b, k2, tok, c = x.shape
    windows = b * k2
    bf16 = torch.bfloat16
    x2, t2, g2 = (a.float().reshape(-1, c) for a in (x, t, g))
    mm = matmul_3xtf32
    a_ex, b_ex = _exact(True, False), _exact(False, True)
    gemm = gemm_tiled
    wgrad = functools.partial(gemm_tiled, splits=wgrad_splits)

    def win(a):
        return a.reshape(windows, tok, -1)

    def ln(a, s, bias):
        return F.layer_norm(a, (c,), s, bias, eps)

    def message_fwd(xq, tt, p):  # xq and tt hold bf16 values
        q, k, v = (gemm(a, p[w].T, matmul=a_ex)
                   for a, w in ((xq, "wq"), (tt, "wk"), (tt, "wv")))
        o, row_max, row_sum = attention_fwd_tiled(
            win(q), win(k), win(v), stream_rows=stream_rows,
            splits=key_splits, matmul=mm, keep_stats=True, mask=mask)
        o = o.reshape(-1, c)
        return dict(q=q, k=k, v=v, o=o, m=gemm(o, p["wm"].T, matmul=mm),
                    stats=(row_max, row_sum))

    def message_bwd(xq, tt, p, fw, gmsg, self_layer):
        gm, gs1, gb1 = _ln_bwd(fw["m"], gmsg, p["s1"], eps)
        go = gemm(gm, p["wm"], matmul=mm)
        dq, dk, dv = attention_bwd_tiled(
            win(fw["q"]), win(fw["k"]), win(fw["v"]), None, win(fw["o"]),
            *fw["stats"], win(go), res_rows=res_rows,
            stream_rows=stream_rows, matmul=mm, mask=mask)
        dq, dk, dv = (d.reshape(-1, c) for d in (dq, dk, dv))
        grads = {} if not weights else dict(
            wq=wgrad(dq.T, xq, matmul=b_ex), wk=wgrad(dk.T, tt, matmul=b_ex),
            wv=wgrad(dv.T, tt, matmul=b_ex), wm=wgrad(gm.T, fw["o"],
                                                      matmul=mm),
            s1=gs1, b1=gb1)
        # the input grads that share an input: one product over the
        # stacked weights
        if self_layer:
            return None, gemm(torch.cat([dq, dk, dv], -1),
                              torch.cat([p["wq"], p["wk"], p["wv"]]),
                              matmul=mm), grads
        return (gemm(dq, p["wq"], matmul=mm),
                gemm(torch.cat([dk, dv], -1),
                     torch.cat([p["wk"], p["wv"]]), matmul=mm), grads)

    sp, cp = self_params, cross_params
    f1 = message_fwd(x2, x2, sp)
    msg1 = ln(f1["m"], sp["s1"], sp["b1"]).to(bf16).float()
    x1 = (x2 + msg1).to(bf16).float()
    f2 = message_fwd(x1, t2, cp)
    cat = torch.cat([x1, ln(f2["m"], cp["s1"], cp["b1"])], -1)
    u, h = gemm(cat, cp["w0"].T, matmul=mm, epilogue="gelu")
    z = gemm(u, cp["w2"].T, matmul=mm)

    # out = x1 + LN2c(z): g read as it is
    gz, gs2, gb2 = _ln_bwd(z, g2, cp["s2"], eps)
    gh = gemm(gz, cp["w2"], matmul=mm, epilogue="gelu_grad", aux=h)
    gx1 = g2 + gemm(gh, cp["w0"][:, :c], matmul=mm)
    gmsg = gemm(gh, cp["w0"][:, c:], matmul=mm)
    gq, gt, gcp = message_bwd(x1, t2, cp, f2, gmsg, False)
    gx1 = gx1 + gq
    _, gqkv, gsp = message_bwd(x2, x2, sp, f1, gx1, True)
    if weights:
        gcp.update(w2=wgrad(gz.T, u, matmul=mm),
                   w0=wgrad(gh.T, cat, matmul=mm), s2=gs2, b2=gb2)
    return ((gx1 + gqkv).reshape(x.shape).to(bf16),
            gt.reshape(t.shape).to(bf16), gsp, gcp)


def sr_attention_fwd_bf16_walk(x, kv_in, wq, bq, wkv, bkv, wp, bp,
                               heads: int, tile_k: int = 32,
                               stream_rows: int = 32):
    """Kernel A's bf16 forward (``emip_sr_attention_bf16``) in the order
    its fused kernel sums: x [B, N, C], kv_in [B, M, C] and the weights
    (torch layout) bf16, the biases fp32; returns out [B, N, C] bf16.

    Every product takes bf16 operands into fp32 sums (the tensor cores'
    order inside a tile is not stated). [k | v] = bf16(kv_in Wkv^T + bkv),
    K in tiles of ``tile_k`` (the first launch). Then per head h, as block
    h of a cluster computes it: q_h = bf16(x Wq[h]^T + bq[h]), K in tiles of
    ``tile_k`` ascending, the bias added to the fp32 sum before the one
    rounding; the keys in tiles of ``stream_rows`` (the last ragged) with a
    running max m and sum l of the fp32 scores s = q_h k_h^T / sqrt(ch): per
    tile m' = max(m, rowmax s), P = e^(s - m') (unnormalised), l = l e^(m -
    m') + rowsum P, O = O e^(m - m') + bf16(P) v_h; o_h = bf16(O (1 / l)).
    The heads' o make o [B, N, C] (exchanged across the cluster), and block h
    writes out[..., h] = bf16(o Wp[h]^T + bp[h]), K = C in tiles of
    ``tile_k`` ascending. The plain version rounds the normalised P
    instead, so the two agree to bf16 rounding, not bit for bit.
    """
    b, n, c = x.shape
    m = kv_in.shape[1]
    ch = c // heads
    bf16 = torch.bfloat16
    x2 = x.float().reshape(-1, c)
    wq, wkv, wp = wq.float(), wkv.float(), wp.float()
    kv = gemm_tiled(kv_in.float().reshape(-1, c), wkv.T, bkv,
                    tile_k=tile_k).to(bf16).float().reshape(b, m, 2 * c)
    scale = 1.0 / ch**0.5
    o = []
    for h in range(heads):
        cols = slice(h * ch, (h + 1) * ch)
        q = gemm_tiled(x2, wq[cols].T, bq[cols], tile_k=tile_k)
        q = q.to(bf16).float().reshape(b, n, ch)
        k, v = kv[..., cols], kv[..., c:][..., cols]
        run_max = q.new_full((b, n), float("-inf"))
        run_sum = q.new_zeros(b, n)
        acc = q.new_zeros(b, n, ch)
        for t0 in range(0, m, stream_rows):
            keys = slice(t0, min(m, t0 + stream_rows))
            s = (q @ k[:, keys].transpose(-1, -2)) * scale
            new_max = torch.maximum(run_max, s.max(-1).values)
            alpha = torch.exp(run_max - new_max)
            p = torch.exp(s - new_max[..., None])
            run_sum = run_sum * alpha + p.sum(-1)
            acc = (acc * alpha[..., None]
                   + p.to(bf16).float() @ v[:, keys])
            run_max = new_max
        o.append((acc * (1.0 / run_sum)[..., None]).to(bf16))
    o2 = torch.cat(o, -1).float().reshape(-1, c)
    out = torch.cat([gemm_tiled(o2, wp[h * ch:(h + 1) * ch].T,
                                bp[h * ch:(h + 1) * ch], tile_k=tile_k)
                     for h in range(heads)], -1)
    return out.to(bf16).reshape(b, n, c)


def wgmma_linear_walk(sources, w, epilogue: str | None = None, gamma=None,
                      beta=None, res=None, eps: float = 1e-6,
                      tile_k: int = 32, aux=None):
    """``epilogue(sum_s a_s w_s^T)`` as ``wg_linear`` sums it.

    ``sources`` [M, K_s] follow each other along K over the columns of
    ``w`` [N, sum K_s] (fp32, torch layout; W0's two halves are its first
    and last C columns). Each source's K runs in tiles of ``tile_k``, the
    tiles of all sources in order; a tile's product (:func:`matmul_3xtf32_exact`:
    two TF32 terms for a bf16 source, exact in TF32, three for an fp32 one)
    is summed on its own and added to the fp32 running sum. Epilogues:
    ``"gelu"`` (exact), ``"layernorm"`` (the row's mean and variance over
    its N columns, then ``gamma``, ``beta``), ``"layernorm_out"``
    (``bf16(res + layernorm)``, ``res`` [M, N] bf16, rounded once) and
    ``"gelu_grad"`` (times the GELU derivative at ``aux`` [M, N]). fp32
    out, bf16 for ``"layernorm_out"``. An input grad dy W (W [N, K]) is
    this product on ``w = W.T``, the transposed weight the kernel splits.
    The order of the sums inside one tile is the tensor core's and is not
    stated.
    """
    acc, k0 = None, 0
    for a in sources:
        exact = a.dtype == torch.bfloat16
        a = a.float()
        for t0 in range(0, a.shape[1], tile_k):
            t1 = min(a.shape[1], t0 + tile_k)
            part = matmul_3xtf32_exact(a[:, t0:t1], w[:, k0 + t0:k0 + t1].T,
                                       a_exact=exact)
            acc = part if acc is None else acc + part
        k0 += a.shape[1]
    if epilogue == "gelu":
        return F.gelu(acc)
    if epilogue == "gelu_grad":
        return acc * _gelu_grad(aux)
    if epilogue in ("layernorm", "layernorm_out"):
        y = _ln_rows(acc, gamma, beta, eps)
        return y if epilogue == "layernorm" else (
            res.float() + y).to(torch.bfloat16)
    return acc


def _ln_rows(acc, gamma, beta, eps):
    """The LayerNorm epilogue: each row's mean and variance over its
    columns."""
    mu = acc.mean(-1, keepdim=True)
    inv = torch.rsqrt(((acc - mu) ** 2).mean(-1, keepdim=True) + eps)
    return (acc - mu) * inv * gamma + beta


def window_ffn_bf16_walk(x, t, params, mask=None, eps: float = 1e-6,
                         stream_rows: int = 32, key_splits: int = 1):
    """H's bf16 forward (``emip_window_ffn_layer_bf16``, ``cross_ffn_bf16``)
    in the order the card sums it: x, t [B, K2, T, C] bf16 read as they
    are, the parameters fp32 in torch's layout (wq .. wm [C, C], s1, b1,
    w0 [F, 2C], w2 [C, F], s2, b2), mask [K2, T, T] or None; bf16 out.

    q = x Wq^T, k = t Wk^T, v = t Wv^T (two TF32 terms: x and t are
    bf16); the 3xTF32 attention (:func:`attention_fwd_tiled`, keys in tiles
    of ``stream_rows`` split in ``key_splits``); msg = LN1(o Wm^T) in the
    product's epilogue; u = gelu(x W0[:, :C]^T + msg W0[:, C:]^T), x's K
    tiles first (two terms), then msg's (three); out = bf16(x + LN2(u
    W2^T)), the one rounding, in W2's epilogue. Every product through
    :func:`wgmma_linear_walk`.
    """
    b, k2, tok, c = x.shape
    p = params
    x2, t2 = x.reshape(-1, c), t.reshape(-1, c)

    def win(a):
        return a.reshape(b * k2, tok, -1)

    q, k, v = (wgmma_linear_walk([a], p[n]) for a, n in
               ((x2, "wq"), (t2, "wk"), (t2, "wv")))
    o = attention_fwd_tiled(win(q), win(k), win(v), stream_rows=stream_rows,
                            splits=key_splits, matmul=matmul_3xtf32,
                            mask=mask)
    msg = wgmma_linear_walk([o.reshape(-1, c)], p["wm"], "layernorm",
                            p["s1"], p["b1"], eps=eps)
    u = wgmma_linear_walk([x2, msg], p["w0"], "gelu")
    out = wgmma_linear_walk([u], p["w2"], "layernorm_out", p["s2"], p["b2"],
                            res=x2, eps=eps)
    return out.reshape(x.shape)


def window_block_fwd_bf16_walk(x, t, self_params, cross_params, mask=None,
                               eps: float = 1e-6, stream_rows: int = 32,
                               key_splits: int = 1):
    """B's bf16 forward (``emip_window_block_bf16``): its bf16 self layer,
    G's (:func:`window_layer_fwd_bf16_walk` with t = x and the residual,
    x1 = bf16(x + bf16(LN1s(m)))), then :func:`window_ffn_bf16_walk` on
    (x1, t) with the cross layer's parameters; bf16 out."""
    x1 = window_layer_fwd_bf16_walk(x, x, self_params, mask, True, eps)
    return window_ffn_bf16_walk(x1, t, cross_params, mask, eps, stream_rows,
                                key_splits)


def _message_wg(x2, t2, p, windows, mask, with_msg, eps, stream_rows,
                key_splits):
    """``message_fwd_wg``: q, k, v on the wgmma product (x2, t2 bf16), the
    3xTF32 attention keeping its row statistics, m = o Wm^T and, with
    ``with_msg``, msg = LN1(m) from the same sums."""
    c = x2.shape[1]

    def win(a):
        return a.reshape(windows, -1, a.shape[-1])

    q, k, v = (wgmma_linear_walk([a], p[n]) for a, n in
               ((x2, "wq"), (t2, "wk"), (t2, "wv")))
    o, row_max, row_sum = attention_fwd_tiled(
        win(q), win(k), win(v), stream_rows=stream_rows, splits=key_splits,
        matmul=matmul_3xtf32, keep_stats=True, mask=mask)
    o = o.reshape(-1, c)
    m = wgmma_linear_walk([o], p["wm"])
    return dict(q=q, k=k, v=v, o=o, m=m, stats=(row_max, row_sum),
                msg=_ln_rows(m, p["s1"], p["b1"], eps) if with_msg else None)


def _message_bwd_wg(x2, t2, p, fw, gmsg, windows, mask, weights, eps,
                    stream_rows, res_rows, wgrad_splits):
    """``message_bwd_wg`` up to gq and gt: (gq, gt fp32, the layer's grads).
    LN1's backward, go = gm Wm on the wgmma product (the transposed
    weight), the attention backward, the weight grads on the GEMM (those of
    x's and t's products two TF32 terms, split-K in ``wgrad_splits``), gt =
    [gk | gv] [Wk; Wv] on the wgmma product; gx's product (:func:`_gx`) is
    the caller's (it adds its addend)."""
    c = x2.shape[1]

    def win(a):
        return a.reshape(windows, -1, a.shape[-1])

    gm, gs1, gb1 = _ln_bwd(fw["m"], gmsg, p["s1"], eps)
    go = wgmma_linear_walk([gm], p["wm"].T)
    dq, dk, dv = attention_bwd_tiled(
        win(fw["q"]), win(fw["k"]), win(fw["v"]), None, win(fw["o"]),
        *fw["stats"], win(go), res_rows=res_rows, stream_rows=stream_rows,
        matmul=matmul_3xtf32, mask=mask)
    dq, dk, dv = (d.reshape(-1, c) for d in (dq, dk, dv))
    b_ex = _exact(False, True)
    wgrad = functools.partial(gemm_tiled, splits=wgrad_splits)
    grads = {} if not weights else dict(
        wq=wgrad(dq.T, x2, matmul=b_ex), wk=wgrad(dk.T, t2, matmul=b_ex),
        wv=wgrad(dv.T, t2, matmul=b_ex),
        wm=wgrad(gm.T, fw["o"], matmul=matmul_3xtf32), s1=gs1, b1=gb1)
    gt = wgmma_linear_walk([torch.cat([dk, dv], -1)],
                           torch.cat([p["wk"], p["wv"]]).T)
    return dq, gt, grads


def _gx(gq, wq, add):
    """gx = add + gq Wq on the GEMM (K tiles of 32, three TF32 terms), the
    addend in the epilogue, before the one rounding."""
    return add + gemm_tiled(gq, wq, matmul=matmul_3xtf32)


def window_layer_bwd_bf16_walk(x, t, params, g, mask=None,
                               add_residual: bool = True,
                               weights: bool = True, eps: float = 1e-6,
                               stream_rows: int = 32, key_splits: int = 1,
                               res_rows: int = 16, wgrad_splits: int = 3):
    """(gx, gt, grads) of G's bf16 backward (``emip_window_layer_bwd_bf16``)
    in the order the card sums it: x, t and the cotangent g [B, K2, T, C]
    bf16, read as they are; the parameters fp32 in torch's layout (wq ..
    wm [C, C], s1, b1); mask [K2, T, T] or None. gx and gt bf16, the grads
    (a dict by the parameters' names, empty without ``weights``) fp32.

    The recompute on the wgmma product (:func:`wgmma_linear_walk`: q from
    x, k and v from t two TF32 terms, m = o Wm^T three), the attention
    (:func:`attention_fwd_tiled`, keys in tiles of ``stream_rows`` split in
    ``key_splits``) keeping its row statistics; LN1's backward on g; go =
    gm Wm on the wgmma product over the transposed weight; the attention
    backward (:func:`attention_bwd_tiled`, ``res_rows`` resident rows);
    the weight grads on the GEMM (:func:`gemm_tiled`, x's and t's two
    terms); gx = bf16((g +) gq Wq) on the GEMM and gt = bf16([gk | gv] [Wk;
    Wv]) on the wgmma product, the addend and the one rounding in the
    epilogue.
    """
    b, k2, tok, c = x.shape
    bf16 = torch.bfloat16
    x2, t2, g2 = (a.reshape(-1, c) for a in (x, t, g))
    fw = _message_wg(x2, t2, params, b * k2, mask, False, eps, stream_rows,
                     key_splits)
    gq, gt, grads = _message_bwd_wg(x2.float(), t2.float(), params, fw,
                                    g2.float(), b * k2, mask, weights, eps,
                                    stream_rows, res_rows, wgrad_splits)
    gx = _gx(gq, params["wq"], g2.float() if add_residual else 0.0)
    return (gx.reshape(x.shape).to(bf16), gt.reshape(t.shape).to(bf16),
            grads)


def window_ffn_layer_bwd_bf16_walk(x, t, params, g, mask=None,
                                   weights: bool = True, eps: float = 1e-6,
                                   stream_rows: int = 32,
                                   key_splits: int = 1, res_rows: int = 16,
                                   wgrad_splits: int = 3):
    """(gx, gt, grads) of H's bf16 backward
    (``emip_window_ffn_layer_bwd_bf16``) in the order the card sums it, as
    :func:`window_layer_bwd_bf16_walk` with the FFN's parameters (w0 [F,
    2C], w2 [C, F], s2, b2) too.

    The recompute keeps m and msg = LN1(m) from Wm's sums; h = x W0[:, :C]^T
    + msg W0[:, C:]^T (x's K tiles first, two terms, then msg's, three),
    u = gelu(h), z = u W2^T. The backward: LN2's backward on g; gh = (gz
    W2) gelu'(h) on the GEMM; [g + (gh W0)[:, :C] | (gh W0)[:, C:]] on the
    wgmma product over the transposed weight (g added from bf16 in the
    epilogue); msg's backward as G's; gx = bf16(gx1 + gq Wq). W0's weight
    grad is its two halves, gh^T x (x exact) and gh^T msg.
    """
    b, k2, tok, c = x.shape
    bf16 = torch.bfloat16
    p = params
    x2, t2, g2 = (a.reshape(-1, c) for a in (x, t, g))
    g32 = g2.float()
    fw = _message_wg(x2, t2, p, b * k2, mask, True, eps, stream_rows,
                     key_splits)
    msg = fw["msg"]
    h = wgmma_linear_walk([x2, msg], p["w0"])
    u = F.gelu(h)
    z = wgmma_linear_walk([u], p["w2"])
    gz, gs2, gb2 = _ln_bwd(z, g32, p["s2"], eps)
    gh = gemm_tiled(gz, p["w2"], matmul=matmul_3xtf32, epilogue="gelu_grad",
                    aux=h)
    gcat = wgmma_linear_walk([gh], p["w0"].T)
    gx1 = g32 + gcat[:, :c]
    gq, gt, grads = _message_bwd_wg(x2.float(), t2.float(), p, fw,
                                    gcat[:, c:], b * k2, mask, weights, eps,
                                    stream_rows, res_rows, wgrad_splits)
    gx = _gx(gq, p["wq"], gx1)
    if weights:
        wgrad = functools.partial(gemm_tiled, splits=wgrad_splits)
        grads.update(
            w2=wgrad(gz.T, u, matmul=matmul_3xtf32),
            w0=torch.cat([wgrad(gh.T, x2.float(), matmul=_exact(False, True)),
                          wgrad(gh.T, msg, matmul=matmul_3xtf32)], -1),
            s2=gs2, b2=gb2)
    return (gx.reshape(x.shape).to(bf16), gt.reshape(t.shape).to(bf16),
            grads)


def attention_bf16_walk(q, k, v, mask=None, key_tile: int = 64):
    """The bf16 attention of C, G and B's self layer
    (``emip_attention_fwd_bf16``) in the order the card sums it: q, k [B,
    N, D] bf16; v [B, Nk, D] bf16 (the windows; ``mask`` [nw, Nq, Nk] or
    None, batch row b reading mask[b % nw]) or [B, Nk, 2] fp32 (C).

    Every product takes bf16 operands into fp32 sums (the tensor cores'
    order inside a tile is not stated). The keys run in tiles of
    ``key_tile`` (the last ragged) with a running max m and sum l of the
    fp32 scores s = q k^T / sqrt(D) (+ mask): per tile m' = max(m, rowmax
    s), P = e^(s - m') unnormalised, l = l e^(m - m') + rowsum P, O = O
    e^(m - m') + P v, with P rounded to bf16 where v is bf16 and in fp32
    for C's 2-wide v; out = O (1 / l), rounded to bf16 with bf16 v. (The
    card takes e^x as 2^(x log2 e), the scale folded into the scores.) The
    plain versions round the normalised P instead, so the two agree to
    bf16 rounding, not bit for bit.
    """
    wide = v.dtype == torch.bfloat16
    b, nq, d = q.shape
    nk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    bias = (None if mask is None else
            mask[torch.arange(b) % mask.shape[0]].float())
    run_max = qf.new_full((b, nq), float("-inf"))
    run_sum = qf.new_zeros(b, nq)
    acc = qf.new_zeros(b, nq, vf.shape[-1])
    for t0 in range(0, nk, key_tile):
        keys = slice(t0, min(nk, t0 + key_tile))
        s = (qf @ kf[:, keys].transpose(-1, -2)) / d**0.5
        if bias is not None:
            s = s + bias[..., keys]
        new_max = torch.maximum(run_max, s.max(-1).values)
        alpha = torch.exp(run_max - new_max)
        p = torch.exp(s - new_max[..., None])
        run_sum = run_sum * alpha + p.sum(-1)
        pv = (p.to(torch.bfloat16).float() if wide else p) @ vf[:, keys]
        acc = acc * alpha[..., None] + pv
        run_max = new_max
    out = acc * (1.0 / run_sum)[..., None]
    return out.to(torch.bfloat16) if wide else out


def window_layer_fwd_bf16_walk(x, t, params, mask=None,
                               add_residual: bool = True, eps: float = 1e-6,
                               key_tile: int = 64):
    """G's bf16 forward (``emip_window_layer_bf16``) in the order the card
    sums it: x, t [B, K2, T, C] bf16, the parameters fp32 in torch's layout
    (wq .. wm [C, C], s1, b1 [C]), the weights cast to bf16 at use; mask
    [K2, T, T] or None. Returns out [B, K2, T, C] bf16.

    [q | k | v] = bf16([x Wq^T | t Wk^T | t Wv^T]): one product of bf16
    operands into fp32 sums, rounded once. o = :func:`attention_bf16_walk`
    per window. m = o Wm^T in fp32, msg = bf16(LN1(m)) (the row's mean and
    variance over its C columns), out = bf16(x + msg) with the residual,
    else msg: the epilogue of that product.
    """
    bf16 = torch.bfloat16
    b, k2, tok, c = x.shape
    w = {n: params[n].to(bf16).float() for n in ("wq", "wk", "wv", "wm")}
    x2, t2 = x.float().reshape(-1, c), t.float().reshape(-1, c)
    qkv = torch.cat([x2 @ w["wq"].T, t2 @ w["wk"].T, t2 @ w["wv"].T],
                    -1).to(bf16).reshape(b * k2, tok, 3 * c)
    o = attention_bf16_walk(qkv[..., :c], qkv[..., c:2 * c],
                            qkv[..., 2 * c:], mask, key_tile)
    msg = _ln_rows(o.float().reshape(-1, c) @ w["wm"].T,
                   params["s1"].float(), params["b1"].float(), eps).to(bf16)
    out = (x2 + msg.float()).to(bf16) if add_residual else msg
    return out.reshape(x.shape)


def bf16_parts(x: torch.Tensor) -> tuple:
    """fp32 ``x`` as three bf16 parts (hi, mid, lo), returned as fp32 tensors
    of bf16 values: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
    mid), each rounded to nearest even, as F's bf16 forward splits its ring.
    The differences are exact in fp32 and lo is exact in bf16, so hi + mid +
    lo is x bit for bit (24 = 3 x 8 bits of significand) wherever lo stays
    a normal bf16 value, |x| >= 2^-110; that is checked here. Below, lo is
    subnormal and drops bits under 2^-133."""
    bf16 = torch.bfloat16
    hi = x.to(bf16).float()
    mid = (x - hi).to(bf16).float()
    lo_exact = x - hi - mid
    lo = lo_exact.to(bf16).float()
    big = x.abs() >= 2.0 ** -110
    if not (torch.equal(lo[big], lo_exact[big])
            and torch.equal((hi + mid + lo)[big], x[big])):
        raise ValueError("bf16_parts: the parts do not sum to x")
    return hi, mid, lo


def matmul_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as F's bf16 forward takes it on the bf16 tensor cores: ``a``
    rounded to bf16 (q is bf16 already; P is rounded here), ``b`` fp32 (the
    ring) in its three exact bf16 parts, the products summed in fp32, the
    small parts first (lo, mid, hi). Every partial product is exact; the
    tensor core's order inside a product is not stated."""
    a16 = a.to(torch.bfloat16).float()
    hi, mid, lo = bf16_parts(b)
    return (a16 @ lo + a16 @ mid) + a16 @ hi


def key_splits(blocks: int, tiles: int) -> int:
    """How many ways a forward splits its streamed key tiles
    (``tc_splits`` of ``csrc/mma_tf32.cuh``): ``blocks`` blocks, one an SM
    of the H100's 132, s splits of ceil(tiles / s) tiles take ceil(blocks
    * s / 132) waves of that many tiles; the fewest splits within 5% of the
    least time, at most 16 and ``tiles``."""
    slots = 132
    per = tiles
    best = -(-blocks // slots) * tiles
    for s in range(2, min(16, tiles) + 1):
        p = -(-tiles // s)
        time = -(-(blocks * -(-tiles // p)) // slots) * p
        if time < 0.95 * best:
            per, best = p, time
    return -(-tiles // per)


def memory_attention_fwd_bf16_walk(q, k, v, bias, key_tile: int = 32,
                                   splits: int | None = None,
                                   keep_stats: bool = False):
    """F's bf16 forward (``emip_memory_attention_bf16``) in the order the
    card sums it: q [B, M, C] bf16; k, v [B, N, C] and the key bias [B, N]
    fp32; returns out [B, M, C] fp32 (and the row max and sum [B, M] with
    ``keep_stats``).

    The ring's k and v go in their three bf16 parts (:func:`bf16_parts`)
    into both products (:func:`matmul_bf16x3`); the keys stream in tiles of
    ``key_tile`` (the last ragged, its missing keys at -inf) with the bias
    added before a running max m and sum l of the unrounded P = e^(s - m),
    P rounded to bf16 for P v, as :func:`attention_fwd_tiled` walks them;
    the key tiles split ``splits`` ways (by default as the kernel plans
    them for its blocks of 128 query rows, one an SM: :func:`key_splits`),
    each split's output normalised by its own sum and the splits merged in
    order with weights l_s e^(m_s - max m). The plain version rounds e^(s -
    row max) instead, so the two agree to bf16 rounding, not bit for bit.
    """
    b, m, _ = q.shape
    tiles = -(-k.shape[1] // key_tile)
    if splits is None:
        splits = key_splits(b * -(-m // 128), tiles)
    return attention_fwd_tiled(q.float(), k, v, bias, stream_rows=key_tile,
                               splits=splits, matmul=matmul_bf16x3,
                               keep_stats=keep_stats)
