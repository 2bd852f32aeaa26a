// Tensor-core tile core of the port's flash-style attention kernels: fp32-
// grade products as three TF32 products ("3xTF32"), tiles staged through
// shared memory with asynchronous copies, and the attention forward and
// backward built on both. flow_attention.cu (kernel C, value width 2, key
// width 128 or 64) and memory_attention.cu (kernel F, value and key width
// 128 or 64, additive key bias) instantiate them.
//
//   tf32_split       x = hi + lo with hi = tf32(x) (rounded as cvt.rna does)
//                    and lo = tf32(x - hi) (truncated by the tensor core): hi
//                    carries 11 significant bits, lo the next 11, so
//                    hi.hi + hi.lo + lo.hi with fp32 accumulators leaves a
//                    relative error near 2^-21 per product, of the size of
//                    fp32 rounding; a single TF32 product leaves 2^-11.
//   mma_3xtf32       the three mma.sync.m16n8k8 (tf32 in, fp32 out) of
//                    fragment pairs, the two small terms first, ordered so
//                    that no mma waits for its neighbour's accumulator.
//   warp_gemm_nt     C[16 MT, 8 NT] += A[16 MT, K] . B[8 NT, K]^T, both
//                    operands row-major in shared memory. Rows are padded to
//                    K + 4 floats: the eight rows and four k of a fragment
//                    load then fall on 32 different banks. With MT = 2 a
//                    fragment of B is loaded and split once for two mma.
//   warp_gemm_ak     C[16 MT, N] += P[16 MT, 8 NT] . B[8 NT, N] with P from
//                    the accumulator fragments of a warp_gemm_nt (no trip
//                    through shared memory): k slot t of k-step j stands for
//                    column 2t of fragment j and slot t + 4 for column
//                    2t + 1, which is where the accumulator layout holds
//                    them; B is read at rows 8j + 2t and 8j + 2t + 1 of the
//                    same row-major tile, again on 32 different banks.
//   load_tile_async  rows x W floats from device memory into a padded
//                    shared tile with 16-byte cp.async, neighbouring
//                    threads on neighbouring addresses; rows past the end
//                    are zero-filled by the copy itself.
//   attention_fwd_tc out = softmax(q k^T scale + bias) v, and where a
//                    gradient will be taken each row's max and sum, kept
//                    apart (with every key masked the max is -1e9, where
//                    fp32 has no room for max + log sum). What bounds it:
//                    the q k^T product (and with DV = D the P v product),
//                    2 Nq Nk D operations each per batch row. A block owns
//                    WARPS x MT x 16 query rows, kept in shared memory, and
//                    streams k and v in tiles of STR rows through a ring of
//                    two cp.async stages with one barrier per tile. The
//                    scores stay in the accumulator fragments: the online
//                    max and sum run on them in registers (a row lives in
//                    the four lanes of a quad, so its max is two shuffles;
//                    the sum is kept per lane and added up once at the
//                    end), the output accumulators are rescaled by
//                    exp(m_old - m_new), and P = exp(S scale + bias - m_new)
//                    overwrites S in place, which is the A operand of
//                    warp_gemm_ak for O += P v. With DV = 2 that product
//                    is two FMAs per score on the CUDA cores. Keys past the
//                    end of a ragged last tile are masked to -inf; masked
//                    tiles are not skipped (with every key at bias -1e9 the
//                    result is the plain mean of v). Where the blocks leave
//                    the card idle, or its last wave mostly empty, the keys
//                    are split across blocks; a further launch merges the
//                    normalised partials in order by their max and sum.
//   attention_bwd_tc dq, dk, dv of the same from the row max and row sum the
//                    forward kept. Two passes, each a grid of blocks that
//                    own WARPS x MT x 16 rows of one side (kept in shared
//                    memory) and stream the other side through the same
//                    ring of stages:
//                      query-tiled:  S = q k^T, dP = dO v^T,
//                                    dS = P (dP - delta), dq += dS k
//                      key-tiled:    S^T = k q^T, dP^T = v dO^T,
//                                    dv += P^T dO, dk += dS^T q
//                    (the key-tiled pass computes the transposed scores so
//                    that P^T and dS^T are accumulator fragments too). A
//                    pass whose blocks leave the card idle, or its last
//                    wave mostly empty, splits its streamed side across
//                    blocks; the partials are summed in order by a further
//                    launch. No atomics and no [queries, keys] array in
//                    device memory. With DV = 2 the products with v and dO
//                    run on the CUDA cores (two terms each). Any grad may be
//                    left out.
//
// No kernel here uses atomics: a second call gives the same bits. The widths
// are template parameters; instantiated today: D = DV = 128 or 64 (kernel
// F) and D = 128 or 64 with DV = 2 (kernel C); 128 is pvt_v2_b5's GMFlow
// feature width, 64 b0's. D = DV = 128 also fits the window
// attention of kernels B, G, H and D = DV = 64 or 32 kernel A's (their
// masks and heads are not handled here yet).

#pragma once

#include <stdint.h>

#include "primitives.cuh"

namespace emip {
namespace {

constexpr int kTcKUnroll = 2;  // k-steps of a product unrolled together

// ------------------------------------------------------------ 3xTF32

// hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds it (nearest, ties away
// from zero), by an integer add and a mask on the bits: the cvt itself
// compiles to four operations, with a test for infinities that finite
// operands do not need, and cost both kernels 14% of their time. lo is
// handed over as the fp32 difference: the tensor core reads the upper 19
// bits of a tf32 operand, which truncates it to TF32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16, 8] += a[16, 8] . b[8, 8]. Lane (g = lane / 4, t = lane % 4) holds
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g),
// b1 (k t + 4, n g); c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three products of MT x NT fragment pairs (MT fragments of A, each
// with all NT of B) into c[m][c0 .. c0 + NT), the two small terms first.
// Term by term over all accumulators: an mma that follows another on the
// same accumulator waits for it, so neighbours in the instruction stream
// must not share one.
template <int MT, int NT, int NC>
__device__ __forceinline__ void mma_3xtf32(float (&c)[MT][NC][4], int c0,
                                           const uint32_t (&a_hi)[MT][4],
                                           const uint32_t (&a_lo)[MT][4],
                                           const uint32_t (&b_hi)[NT][2],
                                           const uint32_t (&b_lo)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[m][c0 + j], a_lo[m], b_hi[j]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[m][c0 + j], a_hi[m], b_lo[j]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[m][c0 + j], a_hi[m], b_hi[j]);
}

// For each of P <= 2 products: c[p][m][j] += A_p[16m .. 16m + 15, K] .
// B_p[8j .. 8j + 7, K]^T for m < MT, j < NT. A_p points at the warp's first
// row, B_p at the tile's first row; all have the leading dim LD. A fragment
// of B is loaded and split once for the MT fragments of A. The P products
// share the k loop so that their accumulators interleave.
template <int P, int K, int MT, int NT, int LD, int PC>
__device__ __forceinline__ void warp_gemm_nt(const float* const (&A)[2],
                                             const float* const (&B)[2],
                                             int g, int t,
                                             float (&c)[PC][MT][NT][4]) {
  static_assert(P <= 2 && P <= PC, "one accumulator tile per product");
#pragma unroll kTcKUnroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[P][MT][4], al[P][MT][4], bh[P][NT][2], bl[P][NT][2];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* a = A[p] + (16 * m + g) * LD + t + k0;
        tf32_split(a[0], ah[p][m][0], al[p][m][0]);
        tf32_split(a[8 * LD], ah[p][m][1], al[p][m][1]);
        tf32_split(a[4], ah[p][m][2], al[p][m][2]);
        tf32_split(a[8 * LD + 4], ah[p][m][3], al[p][m][3]);
      }
      const float* b = B[p] + g * LD + t + k0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tf32_split(b[j * 8 * LD], bh[p][j][0], bl[p][j][0]);
        tf32_split(b[j * 8 * LD + 4], bh[p][j][1], bl[p][j][1]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      mma_3xtf32<MT, NT>(c[p], 0, ah[p], al[p], bh[p], bl[p]);
  }
}

// acc[m][n] += P_m[16, 8 NT] . B[8 NT, 8n .. 8n + 7] for m < MT, n < N / 8,
// P_m being the accumulator fragments p[m][j] of a warp_gemm_nt (see the
// head of the file for the k slots). B points at the tile's first row
// (leading dim LDB).
template <int N, int MT, int NT, int LDB>
__device__ __forceinline__ void warp_gemm_ak(const float (&p)[MT][NT][4],
                                             const float* __restrict__ B,
                                             int g, int t,
                                             float (&acc)[MT][N / 8][4]) {
  constexpr int kGroup = 8 / MT;  // fragments of B in flight
  static_assert(N / 8 % kGroup == 0, "whole groups of output fragments");
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      tf32_split(p[m][j][0], ah[m][0], al[m][0]);
      tf32_split(p[m][j][2], ah[m][1], al[m][1]);
      tf32_split(p[m][j][1], ah[m][2], al[m][2]);
      tf32_split(p[m][j][3], ah[m][3], al[m][3]);
    }
    const float* b0 = B + (8 * j + 2 * t) * LDB + g;
#pragma unroll
    for (int n0 = 0; n0 < N / 8; n0 += kGroup) {
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        tf32_split(b0[8 * (n0 + n)], bh[n][0], bl[n][0]);
        tf32_split(b0[8 * (n0 + n) + LDB], bh[n][1], bl[n][1]);
      }
      mma_3xtf32<MT, kGroup>(acc, n0, ah, al, bh, bl);
    }
  }
}

// ------------------------------------------------------ staged copies

// BYTES (4, 8 or 16) from device to shared memory without passing through
// registers; zeros when !valid (src must still be an address of the tensor).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING));
}

// dst[r][0 .. W) = src[(r0 + r) * sn + 0 .. W) for r < rows, zeros where
// r0 + r >= rows_total; dst rows are W + 4 floats apart. A thread keeps its
// 16-byte column and walks down the rows.
template <int W, int THREADS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                int sn, int r0, int rows_total,
                                                int rows, int tid) {
  constexpr int kChunks = W / 4;
  static_assert(THREADS % kChunks == 0, "whole rows per pass of the block");
  constexpr int kStep = THREADS / kChunks;
  const int c = (tid % kChunks) * 4;
  int r = tid / kChunks;
  const float* from = src + (long long)(r0 + r) * sn + c;
  float* to = dst + r * (W + 4) + c;
  for (; r < rows; r += kStep) {
    const bool ok = r0 + r < rows_total;
    cp_async<16>(to, ok ? from : src, ok);
    from += (long long)kStep * sn;
    to += kStep * (W + 4);
  }
}

// n rows of a dense [total, BYTES / 4] array (a per-row vector, or the
// 2-wide values), zeros past total.
template <int BYTES, int THREADS>
__device__ __forceinline__ void load_vector_async(float* dst, const float* src,
                                                  int r0, int total, int n,
                                                  int tid) {
  constexpr int kPer = BYTES / 4;
  for (int i = tid; i < n; i += THREADS) {
    const bool ok = r0 + i < total;
    cp_async<BYTES>(dst + i * kPer,
                    src + (ok ? (long long)(r0 + i) * kPer : 0), ok);
  }
}

// -------------------------------------------------- shared-memory plan

constexpr int kTcStages = 2;

// Shared-memory plan of one pass: the resident side's tiles (with RES_V its
// value-width rows too), then the ring of stages, each the streamed side's
// tiles and VECS per-row vectors. A warp owns MT fragments of 16 resident
// rows.
template <int D, int DV, int WARPS, int MT, int STR, bool RES_V, int VECS>
struct TcPlan {
  static_assert(D % 8 == 0 && STR % 8 == 0, "fragment sizes");
  static_assert(DV == 2 || DV == D, "value width: 2, or the key width");
  static constexpr bool kWide = DV != 2;  // products with v on tensor cores
  static constexpr int kProducts = kWide ? 2 : 1;  // per backward score tile
  static constexpr int kWarpRows = 16 * MT;
  static constexpr int kRes = kWarpRows * WARPS;
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kNT = STR / 8;
  static constexpr int kLd = D + 4;
  static constexpr int kLdV = DV + 4;
  static constexpr int kResTile = kRes * kLd;
  static constexpr int kResTileV = RES_V && kWide ? kRes * kLdV : 0;
  static constexpr int kStrTile = STR * kLd;
  static constexpr int kStrTileV = kWide ? STR * kLdV : STR * DV;
  static constexpr int kStage = kStrTile + kStrTileV + VECS * STR;
  static constexpr size_t kBytes =
      sizeof(float) * (kResTile + kResTileV + kTcStages * kStage);
  // blocks that share an SM: what its 227 KiB of shared memory hold (1 KiB
  // is reserved per block), and no more than leaves a thread 168 registers
  // (255 with two fragments of rows)
  static constexpr int kSmemFit = (int)(232448 / (kBytes + 1024));
  static constexpr int kRegFit = (MT > 1 ? 256 : 384) / kThreads;
  static constexpr int kBlocksPerSm =
      kSmemFit < kRegFit ? (kSmemFit < 1 ? 1 : kSmemFit)
                         : (kRegFit < 1 ? 1 : kRegFit);
};

// the forward: resident queries; a stage holds k, v and the bias
template <int D, int DV, int WARPS, int MT, int STR>
using TcFwd = TcPlan<D, DV, WARPS, MT, STR, false, 1>;
// the backward's passes: resident q and dO (or k and v); a stage holds the
// other side's two tiles and up to four per-row vectors
template <int D, int DV, int WARPS, int MT, int STR>
using TcBwd = TcPlan<D, DV, WARPS, MT, STR, true, 4>;

// Splits of a pass's streamed side. With `blocks` blocks on `slots` places
// and s splits a pass takes ceil(blocks * s / slots) / s of one block's
// time: more splits fill an idle card and even out the last wave. Take the
// smallest s within 5% of the least, no more than 16, than there are tiles,
// or than the workspace holds (per_split floats each); then even the tiles
// out so that no split is empty.
inline int tc_splits(long long blocks, int slots, int tiles,
                     long long per_split, long long ws_floats, int* per) {
  const long long most = max(1LL, min(min(16LL, (long long)tiles),
                                       ws_floats / per_split));
  int best = 1;
  double best_time = (double)ceil_div(blocks, slots);
  for (int s = 2; s <= most; ++s) {
    const double time = (double)ceil_div(blocks * s, slots) / s;
    if (time < 0.95 * best_time) {
      best = s;
      best_time = time;
    }
  }
  *per = ceil_div(tiles, best);
  return ceil_div(tiles, *per);
}

// ------------------------------------------------- attention forward

// Row n of batch row b of an operand lies at p[b * sb + n * sn]; out is
// [B, Nq, DV] and row_max / row_sum [B, Nq] (null: not kept); bias is
// [B, Nk] or null. part_o [splits, B, Nq, DV] and part_stats [2, splits, B,
// Nq] (max, then sum) hold the partials of a split pass.
struct TcFwdArgs {
  AttnOperand q, k, v;
  const float* bias;
  float* out;
  float* row_max;
  float* row_sum;
  float* part_o;
  float* part_stats;
  int B, Nq, Nk;
  float scale;
  int tiles_per_split;
};

// Grid (query tiles, key splits, B). Split z of a batch row takes the key
// tiles [z * tiles_per_split, ...). With one split a block writes out and,
// with KEEP, the row statistics; otherwise its normalised partial output
// and that partial's max and sum.
template <int D, int DV, int WARPS, int MT, int STR, bool KEEP>
__global__ void
__launch_bounds__(32 * WARPS, (TcFwd<D, DV, WARPS, MT, STR>::kBlocksPerSm))
attention_fwd_tc_kernel(TcFwdArgs a) {
  using L = TcFwd<D, DV, WARPS, MT, STR>;
  extern __shared__ __align__(16) float tc_smem[];
  float* Qs = tc_smem;            // [kRes][D + 4]
  float* stages = Qs + L::kResTile;
  // a stage: K [STR][D + 4]; V [STR][DV + 4] or [STR][2]; bias [STR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * L::kRes;
  const int row0 = q0 + warp * L::kWarpRows;  // this warp's first query
  const int split = blockIdx.y, splits = gridDim.y, b = blockIdx.z;
  const float* qp = a.q.p + b * a.q.sb;
  const float* kp = a.k.p + b * a.k.sb;
  const float* vp = a.v.p + b * a.v.sb;
  const float* bias = a.bias ? a.bias + (long long)b * a.Nk : nullptr;

  load_tile_async<D, L::kThreads>(Qs, qp, a.q.sn, q0, a.Nq, L::kRes, tid);

  auto fill = [&](int tile, int s) {
    float* st = stages + s * L::kStage;
    const int k0 = tile * STR;
    load_tile_async<D, L::kThreads>(st, kp, a.k.sn, k0, a.Nk, STR, tid);
    if constexpr (L::kWide)
      load_tile_async<DV, L::kThreads>(st + L::kStrTile, vp, a.v.sn, k0, a.Nk,
                                       STR, tid);
    else
      load_vector_async<8, L::kThreads>(st + L::kStrTile, vp, k0, a.Nk, STR,
                                        tid);
    if (bias)
      load_vector_async<4, L::kThreads>(st + L::kStrTile + L::kStrTileV, bias,
                                        k0, a.Nk, STR, tid);
    cp_async_commit();
  };

  // this thread's rows g and g + 8 of each of the warp's fragments: the
  // running max (the same in the four lanes of a row) and this lane's part
  // of the running sum; the output accumulators, with DV = 2 acc[m][0][2h +
  // c] holding this lane's part of column c of row h
  constexpr int kAccN = L::kWide ? DV / 8 : 1;
  float mrow[MT][2], lrow[MT][2], acc[MT][kAccN][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mrow[m][h] = -INFINITY;
      lrow[m][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < kAccN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  }

  const int tiles = (a.Nk + STR - 1) / STR;
  const int t_beg = split * a.tiles_per_split;
  const int t_end = min(tiles, t_beg + a.tiles_per_split);
  if (t_beg < t_end) fill(t_beg, 0);
  for (int tile = t_beg; tile < t_end; ++tile) {
    const int s = (tile - t_beg) % kTcStages;
    // this tile has landed, and every warp is done with the one before,
    // whose stage the next tile's copy may now overwrite
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < t_end) fill(tile + 1, (s + 1) % kTcStages);
    const float* Ks = stages + s * L::kStage;
    const float* Vs = Ks + L::kStrTile;
    const float* bias_s = Vs + L::kStrTileV;
    const int k0 = tile * STR;

    float prod[1][MT][L::kNT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < L::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) prod[0][m][j][e] = 0.f;
    const float* const res[2] = {Qs + warp * L::kWarpRows * L::kLd,
                                 Qs + warp * L::kWarpRows * L::kLd};
    const float* const str[2] = {Ks, Ks};
    warp_gemm_nt<1, D, MT, L::kNT, L::kLd>(res, str, g, t, prod);
    float(&sc)[MT][L::kNT][4] = prod[0];

    // scaled, biased scores; keys past the end of the tile at -inf
    float mnew[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) mnew[m][h] = -INFINITY;
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const bool ok = k0 + col < a.Nk;
        const float bs = bias ? bias_s[col] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            const float x = ok ? sc[m][j][e] * a.scale + bs : -INFINITY;
            sc[m][j][e] = x;
            mnew[m][h] = fmaxf(mnew[m][h], x);
          }
      }
    // the row max over the quad, the rescale of what came before
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = mnew[m][h];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, mrow[m][h]);
        const float alpha = __expf(mrow[m][h] - mx);  // 0 on the first tile
        mrow[m][h] = mnew[m][h] = mx;
        lrow[m][h] *= alpha;
#pragma unroll
        for (int n = 0; n < kAccN; ++n) {
          acc[m][n][2 * h] *= alpha;
          acc[m][n][2 * h + 1] *= alpha;
        }
      }
    // P in place of S; with DV = 2 also O += P v here
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        float v0 = 0.f, v1 = 0.f;
        if constexpr (!L::kWide) {
          v0 = Vs[2 * col];
          v1 = Vs[2 * col + 1];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            const float p = __expf(sc[m][j][e] - mnew[m][h]);
            sc[m][j][e] = p;
            lrow[m][h] += p;
            if constexpr (!L::kWide) {
              acc[m][0][2 * h] = fmaf(p, v0, acc[m][0][2 * h]);
              acc[m][0][2 * h + 1] = fmaf(p, v1, acc[m][0][2 * h + 1]);
            }
          }
      }
    if constexpr (L::kWide)
      warp_gemm_ak<DV, MT, L::kNT, L::kLdV>(sc, Vs, g, t, acc);
  }

  // the four lanes of a row hold parts of its sum (and, with DV = 2, of its
  // two outputs)
  const bool whole = splits == 1;
  const long long rows = (long long)a.B * a.Nq;
  float* o_dst = whole ? a.out + (long long)b * a.Nq * DV
                       : a.part_o + ((long long)split * a.B + b) * a.Nq * DV;
  float* m_dst = whole ? (KEEP ? a.row_max + (long long)b * a.Nq : nullptr)
                       : a.part_stats + ((long long)split * a.B + b) * a.Nq;
  float* l_dst = whole ? (KEEP ? a.row_sum + (long long)b * a.Nq : nullptr)
                       : m_dst + splits * rows;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = lrow[m][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if constexpr (!L::kWide) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& o = acc[m][0][2 * h + c];
          o += __shfl_xor_sync(0xffffffffu, o, 1);
          o += __shfl_xor_sync(0xffffffffu, o, 2);
        }
      }
      const int n = row0 + 16 * m + g + 8 * h;
      if (n >= a.Nq) continue;
      const float inv = 1.0f / l;
      if constexpr (L::kWide) {
#pragma unroll
        for (int c = 0; c < DV / 8; ++c)
          *reinterpret_cast<float2*>(o_dst + (long long)n * DV + 8 * c +
                                     2 * t) =
              make_float2(acc[m][c][2 * h] * inv, acc[m][c][2 * h + 1] * inv);
      } else if (t == 0) {
        *reinterpret_cast<float2*>(o_dst + (long long)n * 2) =
            make_float2(acc[m][0][2 * h] * inv, acc[m][0][2 * h + 1] * inv);
      }
      if (m_dst && t == 0) {
        m_dst[n] = mrow[m][h];
        l_dst[n] = l;
      }
    }
}

// out = sum_z w_z part_o[z] / sum_z w_z with w_z = l_z exp(m_z - max m), the
// splits taken in order; row_max / row_sum (if not null) get max m and
// sum_z w_z. rows = B * Nq.
template <int W>
__global__ void attention_merge_kernel(const float* __restrict__ part_o,
                                       const float* __restrict__ part_stats,
                                       int splits, long long rows,
                                       float* __restrict__ out,
                                       float* __restrict__ row_max,
                                       float* __restrict__ row_sum) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * W) return;
  const long long r = idx / W;
  const float* pm = part_stats + r;
  const float* pl = pm + splits * rows;
  const float* po = part_o + idx;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, pm[z * rows]);
  float wsum = 0.f, o = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float w = pl[z * rows] * __expf(pm[z * rows] - mx);
    wsum += w;
    o = fmaf(w, po[z * rows * W], o);
  }
  out[idx] = o / wsum;
  if (row_max && idx % W == 0) {
    row_max[r] = mx;
    row_sum[r] = wsum;
  }
}

template <int D, int DV, int WARPS, int MT, int STR, bool KEEP>
cudaError_t attention_fwd_tc_launch(const TcFwdArgs& a, dim3 grid,
                                    cudaStream_t stream) {
  using L = TcFwd<D, DV, WARPS, MT, STR>;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_tc_kernel<D, DV, WARPS, MT, STR, KEEP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  attention_fwd_tc_kernel<D, DV, WARPS, MT, STR, KEEP>
      <<<grid, L::kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// out [B, Nq, DV] = softmax(q k^T scale + bias) v; q: [B, Nq, .], k, v:
// [B, Nk, .], bias [B, Nk] or null. row_max and row_sum [B, Nq] are written
// when row_max is not null (a gradient will be taken). ws: room for the
// partials of a split pass (fewer splits when it is short).
template <int D, int DV, int WARPS, int MT, int STR>
cudaError_t attention_fwd_tc(AttnOperand q, AttnOperand k, AttnOperand v,
                             const float* bias, float* out, float* row_max,
                             float* row_sum, int B, int Nq, int Nk,
                             float scale, Workspace ws, cudaStream_t stream) {
  using L = TcFwd<D, DV, WARPS, MT, STR>;
  TcFwdArgs a;
  a.q = q; a.k = k; a.v = v;
  a.bias = bias;
  a.out = out; a.row_max = row_max; a.row_sum = row_sum;
  a.part_o = a.part_stats = nullptr;
  a.B = B; a.Nq = Nq; a.Nk = Nk;
  a.scale = scale;
  const long long rows = (long long)B * Nq;
  const int res_tiles = ceil_div(Nq, L::kRes);
  const int splits =
      tc_splits((long long)res_tiles * B, kSmCount * L::kBlocksPerSm,
                ceil_div(Nk, STR), rows * (DV + 2), ws.n, &a.tiles_per_split);
  if (splits > 1) {
    a.part_o = ws.p;
    a.part_stats = ws.p + splits * rows * DV;
  }
  const dim3 grid(res_tiles, splits, B);
  cudaError_t err =
      row_max ? attention_fwd_tc_launch<D, DV, WARPS, MT, STR, true>(a, grid,
                                                                     stream)
              : attention_fwd_tc_launch<D, DV, WARPS, MT, STR, false>(
                    a, grid, stream);
  if (err != cudaSuccess || splits == 1) return err;
  attention_merge_kernel<DV><<<ceil_div(rows * DV, 256), 256, 0, stream>>>(
      a.part_o, a.part_stats, splits, rows, out, row_max, row_sum);
  return cudaGetLastError();
}

// ------------------------------------------------ attention backward

// Row n of batch row b of an operand lies at p[b * sb + n * sn]. row_max,
// row_sum (the forward's) and delta = rowsum(dO o out) are [B, Nq]; bias is
// [B, Nk] or null. part_a / part_b: partials of a split pass.
struct TcBwdArgs {
  AttnOperand q, k, v, go;
  const float* bias;
  const float* row_max;
  const float* row_sum;
  const float* delta;
  AttnGrad dq, dk, dv;
  float* part_a;
  float* part_b;
  int B, Nq, Nk;
  float scale;
  int tiles_per_split;
};

// delta[b, n] = sum_c x[b, n, c] * y[b, n, c]; one warp per row.
template <int W>
__global__ void rowdot_kernel(AttnOperand x, AttnOperand y, int B, int rows,
                              float* __restrict__ out) {
  const long long r =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= (long long)B * rows) return;
  const int lane = threadIdx.x % 32;
  const int b = (int)(r / rows), n = (int)(r % rows);
  const float* xr = x.p + b * x.sb + (long long)n * x.sn;
  const float* yr = y.p + b * y.sb + (long long)n * y.sn;
  float s = 0.f;
  for (int c = lane; c < W; c += 32) s = fmaf(xr[c], yr[c], s);
  s = warp_sum(s);
  if (lane == 0) out[r] = s;
}

// acc[m][c][2h], acc[m][c][2h + 1] hold columns 8c + 2t, 8c + 2t + 1 of row
// row0 + 16m + g + 8h: written times scale where the row lies below rows.
template <int W, int MT>
__device__ __forceinline__ void store_fragments(
    const float (&acc)[MT][W / 8][4], float* dst, long long sn, int row0,
    int rows, int g, int t, float scale) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = row0 + 16 * m + g + 8 * h;
      if (n >= rows) continue;
#pragma unroll
      for (int c = 0; c < W / 8; ++c)
        *reinterpret_cast<float2*>(dst + n * sn + 8 * c + 2 * t) = make_float2(
            acc[m][c][2 * h] * scale, acc[m][c][2 * h + 1] * scale);
    }
}

// Query-tiled pass, grid (query tiles, key splits, B): dq = scale * sum over
// this split's keys of dS k, written to dq with one split and to
// part_a[split] otherwise.
template <int D, int DV, int WARPS, int MT, int STR>
__global__ void
__launch_bounds__(32 * WARPS, (TcBwd<D, DV, WARPS, MT, STR>::kBlocksPerSm))
attention_bwd_tc_dq_kernel(TcBwdArgs a) {
  using L = TcBwd<D, DV, WARPS, MT, STR>;
  extern __shared__ __align__(16) float tc_smem[];
  float* Qs = tc_smem;              // [kRes][D + 4]
  float* Gs = Qs + L::kResTile;     // [kRes][DV + 4] (wide only)
  float* stages = Gs + L::kResTileV;
  // a stage: K [STR][D + 4]; V [STR][DV + 4] or [STR][2]; bias [STR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * L::kRes;
  const int row0 = q0 + warp * L::kWarpRows;  // this warp's first query
  const int split = blockIdx.y, splits = gridDim.y, b = blockIdx.z;
  const float* qp = a.q.p + b * a.q.sb;
  const float* kp = a.k.p + b * a.k.sb;
  const float* vp = a.v.p + b * a.v.sb;
  const float* gp = a.go.p + b * a.go.sb;
  const float* bias = a.bias ? a.bias + (long long)b * a.Nk : nullptr;

  load_tile_async<D, L::kThreads>(Qs, qp, a.q.sn, q0, a.Nq, L::kRes, tid);
  if constexpr (L::kWide)
    load_tile_async<DV, L::kThreads>(Gs, gp, a.go.sn, q0, a.Nq, L::kRes, tid);

  auto fill = [&](int tile, int s) {
    float* st = stages + s * L::kStage;
    const int k0 = tile * STR;
    load_tile_async<D, L::kThreads>(st, kp, a.k.sn, k0, a.Nk, STR, tid);
    if constexpr (L::kWide)
      load_tile_async<DV, L::kThreads>(st + L::kStrTile, vp, a.v.sn, k0, a.Nk,
                                       STR, tid);
    else
      load_vector_async<8, L::kThreads>(st + L::kStrTile, vp, k0, a.Nk, STR,
                                        tid);
    if (bias)
      load_vector_async<4, L::kThreads>(st + L::kStrTile + L::kStrTileV, bias,
                                        k0, a.Nk, STR, tid);
    cp_async_commit();
  };

  // this thread's rows: g and g + 8 of each of the warp's fragments
  float rmax[MT][2], rinv[MT][2], rdel[MT][2], gr[MT][2][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = row0 + 16 * m + g + 8 * h;
      const bool ok = n < a.Nq;
      const long long row = (long long)b * a.Nq + n;
      rmax[m][h] = ok ? a.row_max[row] : 0.f;
      rinv[m][h] = ok ? 1.0f / a.row_sum[row] : 0.f;
      rdel[m][h] = ok ? a.delta[row] : 0.f;
      gr[m][h][0] = gr[m][h][1] = 0.f;
      if (!L::kWide && ok) {
        gr[m][h][0] = gp[(long long)n * a.go.sn];
        gr[m][h][1] = gp[(long long)n * a.go.sn + 1];
      }
    }

  float acc[MT][D / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int tiles = (a.Nk + STR - 1) / STR;
  const int t_beg = split * a.tiles_per_split;
  const int t_end = min(tiles, t_beg + a.tiles_per_split);
  if (t_beg < t_end) fill(t_beg, 0);
  for (int tile = t_beg; tile < t_end; ++tile) {
    const int s = (tile - t_beg) % kTcStages;
    // this tile has landed, and every warp is done with the one before,
    // whose stage the next tile's copy may now overwrite while this one is
    // multiplied
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < t_end) fill(tile + 1, (s + 1) % kTcStages);
    const float* Ks = stages + s * L::kStage;
    const float* Vs = Ks + L::kStrTile;
    const float* bias_s = Vs + L::kStrTileV;
    const int k0 = tile * STR;

    // scores, and with wide values dO v^T beside them
    float prod[L::kProducts][MT][L::kNT][4];
#pragma unroll
    for (int p = 0; p < L::kProducts; ++p)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < L::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) prod[p][m][j][e] = 0.f;
    const float* const res[2] = {Qs + warp * L::kWarpRows * L::kLd,
                                 Gs + warp * L::kWarpRows * L::kLd};
    const float* const str[2] = {Ks, Vs};
    warp_gemm_nt<L::kProducts, D, MT, L::kNT, L::kLd>(res, str, g, t, prod);
    float(&sc)[MT][L::kNT][4] = prod[0];
    float(&dp)[MT][L::kNT][4] = prod[L::kProducts - 1];
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const bool ok = k0 + col < a.Nk;
        const float bs = bias ? bias_s[col] : 0.f;
        float v0 = 0.f, v1 = 0.f;
        if (!L::kWide) {
          v0 = Vs[2 * col];
          v1 = Vs[2 * col + 1];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            const float x = sc[m][j][e] * a.scale + bs;
            const float p =
                ok ? __expf(x - rmax[m][h]) * rinv[m][h] : 0.f;
            const float d = L::kWide
                                ? dp[m][j][e]
                                : fmaf(gr[m][h][0], v0, gr[m][h][1] * v1);
            sc[m][j][e] = p * (d - rdel[m][h]);
          }
      }
    warp_gemm_ak<D, MT, L::kNT, L::kLd>(sc, Ks, g, t, acc);
  }

  if (splits == 1)
    store_fragments<D, MT>(acc, a.dq.p + b * a.dq.sb, a.dq.sn, row0, a.Nq, g,
                           t, a.scale);
  else
    store_fragments<D, MT>(
        acc, a.part_a + ((long long)split * a.B + b) * a.Nq * D, D, row0,
        a.Nq, g, t, a.scale);
}

// Key-tiled pass, grid (key tiles, query splits, B): over this split's
// queries dv = sum P^T dO and dk = scale * sum dS^T q, written to dk / dv
// with one split and to part_a / part_b[split] otherwise. dk or dv may be
// null (not computed).
template <int D, int DV, int WARPS, int MT, int STR>
__global__ void
__launch_bounds__(32 * WARPS, (TcBwd<D, DV, WARPS, MT, STR>::kBlocksPerSm))
attention_bwd_tc_dkv_kernel(TcBwdArgs a) {
  using L = TcBwd<D, DV, WARPS, MT, STR>;
  extern __shared__ __align__(16) float tc_smem[];
  float* Ks = tc_smem;              // [kRes][D + 4]
  float* Vs = Ks + L::kResTile;     // [kRes][DV + 4] (wide only)
  float* stages = Vs + L::kResTileV;
  // a stage: Q [STR][D + 4]; dO [STR][DV + 4] or [STR][2]; row max, row
  // sum, delta [STR] each

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * L::kRes;
  const int row0 = k0 + warp * L::kWarpRows;  // this warp's first key
  const int split = blockIdx.y, splits = gridDim.y, b = blockIdx.z;
  const float* qp = a.q.p + b * a.q.sb;
  const float* kp = a.k.p + b * a.k.sb;
  const float* vp = a.v.p + b * a.v.sb;
  const float* gp = a.go.p + b * a.go.sb;
  const float* row_max = a.row_max + (long long)b * a.Nq;
  const float* row_sum = a.row_sum + (long long)b * a.Nq;
  const float* delta = a.delta + (long long)b * a.Nq;
  const bool want_k = a.dk.p != nullptr, want_v = a.dv.p != nullptr;

  load_tile_async<D, L::kThreads>(Ks, kp, a.k.sn, k0, a.Nk, L::kRes, tid);
  if constexpr (L::kWide)
    load_tile_async<DV, L::kThreads>(Vs, vp, a.v.sn, k0, a.Nk, L::kRes, tid);

  auto fill = [&](int tile, int s) {
    float* st = stages + s * L::kStage;
    const int n0 = tile * STR;
    load_tile_async<D, L::kThreads>(st, qp, a.q.sn, n0, a.Nq, STR, tid);
    if constexpr (L::kWide)
      load_tile_async<DV, L::kThreads>(st + L::kStrTile, gp, a.go.sn, n0, a.Nq,
                                       STR, tid);
    else
      load_vector_async<8, L::kThreads>(st + L::kStrTile, gp, n0, a.Nq, STR,
                                        tid);
    float* vec = st + L::kStrTile + L::kStrTileV;
    load_vector_async<4, L::kThreads>(vec, row_max, n0, a.Nq, STR, tid);
    load_vector_async<4, L::kThreads>(vec + STR, row_sum, n0, a.Nq, STR, tid);
    load_vector_async<4, L::kThreads>(vec + 2 * STR, delta, n0, a.Nq, STR,
                                      tid);
    cp_async_commit();
  };

  // this thread's key rows
  float rbias[MT][2], vr[MT][2][2], dvp[MT][2][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = row0 + 16 * m + g + 8 * h;
      const bool ok = key < a.Nk;
      rbias[m][h] = a.bias && ok ? a.bias[(long long)b * a.Nk + key] : 0.f;
      vr[m][h][0] = vr[m][h][1] = dvp[m][h][0] = dvp[m][h][1] = 0.f;
      if (!L::kWide && ok) {
        vr[m][h][0] = vp[(long long)key * a.v.sn];
        vr[m][h][1] = vp[(long long)key * a.v.sn + 1];
      }
    }

  constexpr int kAccV = L::kWide ? DV / 8 : 1;
  float acc_k[MT][D / 8][4], acc_v[MT][kAccV][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[m][n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < kAccV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[m][n][e] = 0.f;
  }

  const int tiles = (a.Nq + STR - 1) / STR;
  const int t_beg = split * a.tiles_per_split;
  const int t_end = min(tiles, t_beg + a.tiles_per_split);
  if (t_beg < t_end) fill(t_beg, 0);
  for (int tile = t_beg; tile < t_end; ++tile) {
    const int s = (tile - t_beg) % kTcStages;
    // as in the query-tiled pass: one barrier per tile
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < t_end) fill(tile + 1, (s + 1) % kTcStages);
    const float* Qs = stages + s * L::kStage;
    const float* Gs = Qs + L::kStrTile;
    const float* max_s = Gs + L::kStrTileV;
    const float* sum_s = max_s + STR;
    const float* del_s = sum_s + STR;
    const int n0 = tile * STR;

    // transposed tiles: rows are this warp's keys, columns the queries
    float prod[2][MT][L::kNT][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < L::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) prod[p][m][j][e] = 0.f;
    const float* const res[2] = {Ks + warp * L::kWarpRows * L::kLd,
                                 Vs + warp * L::kWarpRows * L::kLd};
    const float* const str[2] = {Qs, Gs};
    warp_gemm_nt<L::kProducts, D, MT, L::kNT, L::kLd>(res, str, g, t, prod);
    float(&pt)[MT][L::kNT][4] = prod[0];  // S^T, then P^T
    float(&ds)[MT][L::kNT][4] = prod[1];  // dP^T, then dS^T
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const bool ok = n0 + col < a.Nq;
        const float mx = max_s[col], inv = ok ? 1.0f / sum_s[col] : 0.f;
        const float dl = del_s[col];
        float g0 = 0.f, g1 = 0.f;
        if (!L::kWide) {
          g0 = Gs[2 * col];
          g1 = Gs[2 * col + 1];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            const float x = pt[m][j][e] * a.scale + rbias[m][h];
            const float p = ok ? __expf(x - mx) * inv : 0.f;
            const float d = L::kWide
                                ? ds[m][j][e]
                                : fmaf(vr[m][h][0], g0, vr[m][h][1] * g1);
            pt[m][j][e] = p;
            ds[m][j][e] = p * (d - dl);
            if (!L::kWide) {
              dvp[m][h][0] = fmaf(p, g0, dvp[m][h][0]);
              dvp[m][h][1] = fmaf(p, g1, dvp[m][h][1]);
            }
          }
      }
    if constexpr (L::kWide) {
      if (want_v) warp_gemm_ak<DV, MT, L::kNT, L::kLdV>(pt, Gs, g, t, acc_v);
    }
    if (want_k) warp_gemm_ak<D, MT, L::kNT, L::kLd>(ds, Qs, g, t, acc_k);
  }

  float* dst_k;
  float* dst_v;
  long long sn_k, sn_v;
  if (splits == 1) {
    dst_k = want_k ? a.dk.p + b * a.dk.sb : nullptr;
    dst_v = want_v ? a.dv.p + b * a.dv.sb : nullptr;
    sn_k = a.dk.sn;
    sn_v = a.dv.sn;
  } else {
    const long long slot = (long long)split * a.B + b;
    dst_k = want_k ? a.part_a + slot * a.Nk * D : nullptr;
    dst_v = want_v ? a.part_b + slot * a.Nk * DV : nullptr;
    sn_k = D;
    sn_v = DV;
  }
  if (want_k)
    store_fragments<D, MT>(acc_k, dst_k, sn_k, row0, a.Nk, g, t, a.scale);
  if constexpr (L::kWide) {
    if (want_v)
      store_fragments<DV, MT>(acc_v, dst_v, sn_v, row0, a.Nk, g, t, 1.0f);
  } else if (want_v) {
    // the four lanes of a row hold its columns' partial sums
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          dvp[m][h][c] += __shfl_xor_sync(0xffffffffu, dvp[m][h][c], 1);
          dvp[m][h][c] += __shfl_xor_sync(0xffffffffu, dvp[m][h][c], 2);
        }
        const int key = row0 + 16 * m + g + 8 * h;
        if (t == 0 && key < a.Nk)
          *reinterpret_cast<float2*>(dst_v + key * sn_v) =
              make_float2(dvp[m][h][0], dvp[m][h][1]);
      }
  }
}

// dq, dk, dv (each may be null) of softmax(q k^T scale + bias) v. o is the
// forward's output, go its gradient, row_max / row_sum [B, Nq] its row
// statistics. q, go, dq: [B, Nq, .]; k, v, dk, dv: [B, Nk, .].
template <int D, int DV, int WARPS, int MT, int STR>
cudaError_t attention_bwd_tc(AttnOperand q, AttnOperand k, AttnOperand v,
                             AttnOperand o, AttnOperand go, const float* bias,
                             const float* row_max, const float* row_sum,
                             AttnGrad dq, AttnGrad dk, AttnGrad dv, int B,
                             int Nq, int Nk, float scale, Workspace ws,
                             cudaStream_t stream) {
  using L = TcBwd<D, DV, WARPS, MT, STR>;
  const long long rows = (long long)B * Nq;
  float* delta = ws.take(rows);
  if (!delta) return cudaErrorInvalidValue;
  rowdot_kernel<DV>
      <<<ceil_div(rows, 8), 256, 0, stream>>>(go, o, B, Nq, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  TcBwdArgs a;
  a.q = q; a.k = k; a.v = v; a.go = go;
  a.bias = bias;
  a.row_max = row_max; a.row_sum = row_sum; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.part_a = a.part_b = nullptr;
  a.B = B; a.Nq = Nq; a.Nk = Nk;
  a.scale = scale;
  const int slots = kSmCount * L::kBlocksPerSm;

  if (dq.p) {
    const int res_tiles = ceil_div(Nq, L::kRes);
    const int splits =
        tc_splits((long long)res_tiles * B, slots, ceil_div(Nk, STR),
                  rows * D, ws.n, &a.tiles_per_split);
    if (splits > 1) a.part_a = ws.p;  // free again after the sum below
    err = cudaFuncSetAttribute(
        attention_bwd_tc_dq_kernel<D, DV, WARPS, MT, STR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
    if (err != cudaSuccess) return err;
    attention_bwd_tc_dq_kernel<D, DV, WARPS, MT, STR>
        <<<dim3(res_tiles, splits, B), L::kThreads, L::kBytes, stream>>>(a);
    if (splits > 1)
      attention_split_reduce_kernel<<<ceil_div(rows * D, 256), 256, 0,
                                      stream>>>(a.part_a, splits, B, Nq, D,
                                                dq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dk.p || dv.p) {
    const int res_tiles = ceil_div(Nk, L::kRes);
    const long long keys = (long long)B * Nk;
    const int splits =
        tc_splits((long long)res_tiles * B, slots, ceil_div(Nq, STR),
                  keys * (D + DV), ws.n, &a.tiles_per_split);
    if (splits > 1) {
      a.part_a = ws.p;
      a.part_b = ws.p + splits * keys * D;
    }
    err = cudaFuncSetAttribute(
        attention_bwd_tc_dkv_kernel<D, DV, WARPS, MT, STR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
    if (err != cudaSuccess) return err;
    attention_bwd_tc_dkv_kernel<D, DV, WARPS, MT, STR>
        <<<dim3(res_tiles, splits, B), L::kThreads, L::kBytes, stream>>>(a);
    if (splits > 1 && dk.p)
      attention_split_reduce_kernel<<<ceil_div(keys * D, 256), 256, 0,
                                      stream>>>(a.part_a, splits, B, Nk, D,
                                                dk);
    if (splits > 1 && dv.p)
      attention_split_reduce_kernel<<<ceil_div(keys * DV, 256), 256, 0,
                                      stream>>>(a.part_b, splits, B, Nk, DV,
                                                dv);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
}  // namespace emip
