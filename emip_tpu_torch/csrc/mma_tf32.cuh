// Tensor-core tile core of the port's kernels: fp32-grade products as three
// TF32 products ("3xTF32"), tiles staged through shared memory with
// asynchronous copies, and the flash-style attention forward and backward
// built on both. Every attention of the port runs here, forward and
// backward: flow_attention.cu (kernel C, value width 2, key width 128 or
// 64), memory_attention.cu (kernel F, value and key width 128 or 64,
// additive key bias), window_attention.cu (kernels B, G, H: width 128 or
// 64, the shifted-window mask) and sr_attention.cu (kernel A: heads of
// width 64 or 32); the forwards of A, B, G and H through attention.cu.
// The GEMM of kernels A, B, G and H (gemm_tf32.cuh) is built on the same
// 3xTF32 products and copies.
//
//   tf32_split       x = hi + lo with hi = tf32(x) (rounded as cvt.rna does)
//                    and lo = tf32(x - hi) (truncated by the tensor core): hi
//                    carries 11 significant bits, lo the next 11, so
//                    hi.hi + hi.lo + lo.hi with fp32 accumulators leaves a
//                    relative error near 2^-21 per product, of the size of
//                    fp32 rounding; a single TF32 product leaves 2^-11.
//   mma_3xtf32       the three mma.sync.m16n8k8 (tf32 in, fp32 out) of
//                    fragment pairs, the two small terms first, ordered so
//                    that no mma waits for its neighbour's accumulator. An
//                    operand exact in TF32 (a bf16 value) has no low half:
//                    its term is left out, two products, one for two such
//                    operands, with the same sums.
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
//                    are zero-filled by the copy itself. Of bf16 rows, a
//                    bf16 tile (rows W + 8 values apart), widened by a
//                    shift as the products build their fragments.
//   attention_fwd_tc out = softmax(q k^T scale + bias + mask) v, and where a
//                    gradient will be taken each row's max and sum, kept
//                    apart (with every key masked the max is -1e9, where
//                    fp32 has no room for max + log sum). Batch row z = b H
//                    + h is head h of batch b, read at column h x width of
//                    [B, N, H x width] operands and written there (kernel
//                    A's q and [k | v] buffers; HEADS instantiations only).
//                    What bounds it: the q k^T product (and with DV = D the
//                    P v product), 2 Nq Nk D operations each per batch row.
//                    A block owns WARPS x MT x 16 query rows, kept in shared
//                    memory, and streams k and v in tiles of STR rows
//                    through a ring of two cp.async stages with one barrier
//                    per tile. The scores stay in the accumulator fragments:
//                    the online max and sum run on them in registers (a row
//                    lives in the four lanes of a quad, so its max is two
//                    shuffles; the sum is kept per lane and added up once at
//                    the end), the output accumulators are rescaled by
//                    exp(m_old - m_new), and P = exp(S scale + bias + mask -
//                    m_new) overwrites S in place, which is the A operand of
//                    warp_gemm_ak for O += P v. With DV = 2 that product
//                    is two FMAs per score on the CUDA cores. The additive
//                    mask [mask_nw, Nq, Nk] (the shifted-window mask of
//                    kernels B, G, H: 3.7 MiB at T = 484, 16 MiB at T =
//                    1024, so it sits in L2) is read from there where it
//                    is added, a column pair at a time. Keys past the end
//                    of a ragged last tile are masked to -inf; masked tiles
//                    are not skipped (with every key at bias -1e9 the result
//                    is the plain mean of v). Where the blocks leave the
//                    card idle, or its last wave mostly empty, the keys are
//                    split across blocks; a further launch merges the
//                    normalised partials in order by their max and sum.
//   attention_bwd_tc dq, dk, dv of softmax(q k^T scale + bias + mask) v
//                    from the row max and row sum the forward kept, with
//                    heads and the mask as in the forward; the mask is read
//                    from L2 into registers at the top of each streamed
//                    tile, before the tile's products, and added to the
//                    score fragments (transposed in the key-tiled pass). Two
//                    passes, each a grid of blocks that own WARPS x MT x 16
//                    rows of one side (kept in shared memory) and stream the
//                    other side through the same ring of stages:
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
//                    device memory. Columns at or past Nk are masked
//                    explicitly (a zero-filled key row scores 0, not
//                    -inf). With DV = 2 the products with v and dO run on
//                    the CUDA cores (two terms each). Any grad may be left
//                    out.
//
// No kernel here uses atomics: a second call gives the same bits. The widths
// are template parameters; instantiated, forward and backward: D = DV = 128
// or 64 with a key bias (kernel F), D = 128 or 64 with DV = 2 (kernel C),
// D = DV = 64 or 32 with heads (kernel A), D = DV = 128 or 64 with the mask
// (kernels B, G, H). 128 is pvt_v2_b5's GMFlow feature width, 64 b0's; 64
// and 32 are the two backbones' PVT head widths. C's and F's instantiations
// take no mask, and their forwards no heads, at compile time: either would
// cost their tilings registers. Kernel C's bf16 backward instantiates both
// with bf16 q and k (the forward as a statistics pass, STATS_BF16; the
// backward with Q16 and K16), kernel F's bf16 backward with Q16 alone.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "primitives.cuh"

namespace emip {
namespace {

constexpr int kTcKUnroll = 2;  // k-steps of a product unrolled together

// Row n of batch row b (and, with heads, head h) of an operand lies at
// p[b * sb + n * sn + h * width], width being the operand's head width.
struct AttnOperand {
  const float* p;
  long long sb;
  int sn;
};
struct AttnGrad {
  float* p;  // null: not wanted
  long long sb;
  int sn;
};

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

// Operands in shared memory are fp32 (float) or bf16 (uint16_t: the bits,
// widened exactly to fp32 by a shift as a fragment is built). A bf16 value
// is exact in TF32: it is its own hi, its lo is zero, and the products of
// its lo are left out (see mma_3xtf32).
template <typename T>
constexpr bool kBf16 = std::is_same_v<T, uint16_t>;

// fp32 storage of values exact in TF32 (bf16 values kept in fp32, as kernel
// B's x1 is): read as fp32, its low halves left out as a bf16 operand's.
struct ExactF32 {
  float x;
};
template <typename T>
constexpr bool kExact = kBf16<T> || std::is_same_v<T, ExactF32>;

template <typename T>
__device__ __forceinline__ void split_as(T x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kBf16<T>) {
    hi = (uint32_t)x << 16;
    lo = 0u;
  } else if constexpr (std::is_same_v<T, ExactF32>) {
    hi = __float_as_uint(x.x);
    lo = 0u;
  } else {
    tf32_split(x, hi, lo);
  }
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
// must not share one. A_EXACT (B_EXACT): every A (B) value is exact in
// TF32 (a bf16 value is), so a_lo (b_lo) is zero and its product is left
// out: two products, one where both are exact. A product left out adds +0
// to every accumulator, so the sums are those of all three.
template <int MT, int NT, int NC, bool A_EXACT = false, bool B_EXACT = false>
__device__ __forceinline__ void mma_3xtf32(float (&c)[MT][NC][4], int c0,
                                           const uint32_t (&a_hi)[MT][4],
                                           const uint32_t (&a_lo)[MT][4],
                                           const uint32_t (&b_hi)[NT][2],
                                           const uint32_t (&b_lo)[NT][2]) {
  if constexpr (!A_EXACT) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(c[m][c0 + j], a_lo[m], b_hi[j]);
  }
  if constexpr (!B_EXACT) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(c[m][c0 + j], a_hi[m], b_lo[j]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[m][c0 + j], a_hi[m], b_hi[j]);
}

// The fragments of rows 16 m + g, 16 m + g + 8 (m < MT) and k columns k0 +
// t, k0 + t + 4 of a row-major A tile (leading dim LD, in elements; T its
// element type), split as mma_3xtf32 reads them; and of rows 8 j + g (j <
// NT) of a row-major B tile, whose rows are the product's columns.
template <int MT, int LD, typename T>
__device__ __forceinline__ void frags_a(const T* A, int g, int t, int k0,
                                        uint32_t (&hi)[MT][4],
                                        uint32_t (&lo)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const T* a = A + (16 * m + g) * LD + t + k0;
    split_as(a[0], hi[m][0], lo[m][0]);
    split_as(a[8 * LD], hi[m][1], lo[m][1]);
    split_as(a[4], hi[m][2], lo[m][2]);
    split_as(a[8 * LD + 4], hi[m][3], lo[m][3]);
  }
}
template <int NT, int LD, typename T>
__device__ __forceinline__ void frags_b(const T* B, int g, int t, int k0,
                                        uint32_t (&hi)[NT][2],
                                        uint32_t (&lo)[NT][2]) {
  const T* b = B + g * LD + t + k0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_as(b[j * 8 * LD], hi[j][0], lo[j][0]);
    split_as(b[j * 8 * LD + 4], hi[j][1], lo[j][1]);
  }
}

// c[0][m][j] += A0[16m .. 16m + 15, K] . B0[8j .. 8j + 7, K]^T for m < MT,
// j < NT, and with P = 2 the same of A1 and B1 into c[1]. A0, A1 point at
// the warp's first row, B0, B1 at the tile's first row; each operand has
// its own leading dim (LDA0 ..., in elements) and element type (float, or
// uint16_t for bf16 bits: an exact operand). A fragment of B is loaded and
// split once for the MT fragments of A. The two products share the k loop
// so that their accumulators interleave. A_EXACT: both A hold values
// exact in TF32 (see mma_3xtf32).
template <int P, int K, int MT, int NT, int LDA0, int LDB0, int LDA1,
          int LDB1, int PC, bool A_EXACT = false, typename TA0,
          typename TB0, typename TA1 = float, typename TB1 = float>
__device__ __forceinline__ void warp_gemm_nt(const TA0* A0, const TB0* B0,
                                             const TA1* A1, const TB1* B1,
                                             int g, int t,
                                             float (&c)[PC][MT][NT][4]) {
  static_assert((P == 1 || P == 2) && P <= PC,
                "one accumulator tile per product");
#pragma unroll kTcKUnroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[P][MT][4], al[P][MT][4], bh[P][NT][2], bl[P][NT][2];
    frags_a<MT, LDA0>(A0, g, t, k0, ah[0], al[0]);
    frags_b<NT, LDB0>(B0, g, t, k0, bh[0], bl[0]);
    if constexpr (P == 2) {
      frags_a<MT, LDA1>(A1, g, t, k0, ah[P - 1], al[P - 1]);
      frags_b<NT, LDB1>(B1, g, t, k0, bh[P - 1], bl[P - 1]);
    }
    mma_3xtf32<MT, NT, NT, A_EXACT || kExact<TA0>, kExact<TB0>>(
        c[0], 0, ah[0], al[0], bh[0], bl[0]);
    if constexpr (P == 2)
      mma_3xtf32<MT, NT, NT, A_EXACT || kExact<TA1>, kExact<TB1>>(
          c[P - 1], 0, ah[P - 1], al[P - 1], bh[P - 1], bl[P - 1]);
  }
}

// acc[m][n] += P_m[16, 8 NT] . B[8 NT, 8n .. 8n + 7] for m < MT, n < N / 8,
// P_m being the accumulator fragments p[m][j] of a warp_gemm_nt (see the
// head of the file for the k slots). B points at the tile's first row
// (leading dim LDB, in elements; TB its element type, a bf16 B exact).
// A_EXACT: P holds values exact in TF32 (see mma_3xtf32).
template <int N, int MT, int NT, int LDB, bool A_EXACT = false,
          typename TB = float>
__device__ __forceinline__ void warp_gemm_ak(const float (&p)[MT][NT][4],
                                             const TB* __restrict__ B,
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
    const TB* b0 = B + (8 * j + 2 * t) * LDB + g;
#pragma unroll
    for (int n0 = 0; n0 < N / 8; n0 += kGroup) {
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        split_as(b0[8 * (n0 + n)], bh[n][0], bl[n][0]);
        split_as(b0[8 * (n0 + n) + LDB], bh[n][1], bl[n][1]);
      }
      mma_3xtf32<MT, kGroup, N / 8, A_EXACT, kExact<TB>>(acc, n0, ah, al, bh,
                                                         bl);
    }
  }
}

// ------------------------------------------------------ staged copies

// BYTES (4, 8 or 16) from device to shared memory without passing through
// registers; zeros when !valid (src must still be an address of the tensor).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
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
// r0 + r >= rows_total; T is float, or uint16_t for bf16 bits. A copy
// moves 16 bytes (kVec = 4 floats or 8 bf16 values) and dst rows are W +
// kVec apart: the eight rows and four k of a fragment then fall on 32
// different banks (16 different words of two bf16 values). A thread keeps
// its 16-byte column and walks down the rows.
template <int W, int THREADS, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int sn,
                                                int r0, int rows_total,
                                                int rows, int tid) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = W / kVec;
  static_assert(THREADS % kChunks == 0, "whole rows per pass of the block");
  constexpr int kStep = THREADS / kChunks;
  const int c = (tid % kChunks) * kVec;
  int r = tid / kChunks;
  const T* from = src + (long long)(r0 + r) * sn + c;
  T* to = dst + r * (W + kVec) + c;
  for (; r < rows; r += kStep) {
    const bool ok = r0 + r < rows_total;
    cp_async<16>(to, ok ? from : src, ok);
    from += (long long)kStep * sn;
    to += kStep * (W + kVec);
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

// Shared-memory plan of one pass: the resident side's tiles (with RES_V its
// value-width rows too), then a ring of STAGES stages, each the streamed
// side's tiles and VECS per-row vectors. A warp owns MT fragments of 16
// resident rows. RES16 (STR16): the resident (streamed) q or k tile holds
// bf16 values, rows D + 8 values apart (the leading dims count elements),
// half the bytes of fp32 rows D + 4 apart.
template <int D, int DV, int WARPS, int MT, int STR, bool RES_V, int VECS,
          bool RES16 = false, bool STR16 = RES16, int STAGES = 2>
struct TcPlan {
  static_assert(D % 8 == 0 && STR % 8 == 0, "fragment sizes");
  static_assert(DV == 2 || DV == D, "value width: 2, or the key width");
  static_assert(STAGES >= 2, "a stage in flight while another is read");
  static constexpr bool kWide = DV != 2;  // products with v on tensor cores
  static constexpr int kProducts = kWide ? 2 : 1;  // per backward score tile
  static constexpr int kStages = STAGES;
  static constexpr int kWarpRows = 16 * MT;
  static constexpr int kRes = kWarpRows * WARPS;
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kNT = STR / 8;
  static constexpr int kLdRes = RES16 ? D + 8 : D + 4;
  static constexpr int kLdStr = STR16 ? D + 8 : D + 4;
  static constexpr int kLd = kLdRes;  // the forward's: both sides alike
  static constexpr int kLdV = DV + 4;
  static constexpr int kResTile = kRes * (RES16 ? kLdRes / 2 : kLdRes);
  static constexpr int kResTileV = RES_V && kWide ? kRes * kLdV : 0;
  static constexpr int kStrTile = STR * (STR16 ? kLdStr / 2 : kLdStr);
  static constexpr int kStrTileV = kWide ? STR * kLdV : STR * DV;
  static constexpr int kStage = kStrTile + kStrTileV + VECS * STR;
  static constexpr size_t kBytes =
      sizeof(float) * (kResTile + kResTileV + STAGES * kStage);
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
template <int D, int DV, int WARPS, int MT, int STR, bool QK_BF16 = false>
using TcFwd = TcPlan<D, DV, WARPS, MT, STR, false, 1, QK_BF16>;
// the backward's passes: the resident q or k rows (RES16: bf16) with their
// dO or v rows; a stage holds the other side's q or k rows (STR16: bf16),
// its v or dO rows and up to four per-row vectors. A bf16 q or k buys a
// third stage (kernel C, bf16 q and k: 62 KiB a block at width 128, against
// 103 KiB for fp32 and two stages; kernel F, bf16 q: 200 and 208 KiB, where
// three fp32 stages would not fit), so that two tiles are in flight while
// a third is multiplied.
template <int D, int DV, int WARPS, int MT, int STR, bool RES16 = false,
          bool STR16 = RES16>
using TcBwd = TcPlan<D, DV, WARPS, MT, STR, true, 4, RES16, STR16,
                     RES16 || STR16 ? 3 : 2>;

// ------------------------------------------------------- score masks

// The backward's mask values of a score tile, from global memory: rows row
// + 16 m + 8 h (row = the warp's first resident row + g), columns col0 + 8
// j + 2 t + c, at mask[row * Nk + col] (TRANSPOSED: the rows are keys and
// the columns queries, at mask[col * Nk + row]). Indices past the end are
// clamped: their scores are masked or never stored.
template <int MT, int NT, bool TRANSPOSED>
__device__ __forceinline__ void mask_from_l2(const float* __restrict__ mask,
                                             int Nq, int Nk, int row,
                                             int col0, int t,
                                             float (&mv)[MT][NT][4]) {
  const int rows = TRANSPOSED ? Nk : Nq, cols = TRANSPOSED ? Nq : Nk;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = min(col0 + 8 * j + 2 * t + c, cols - 1);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = min(row + 16 * m + 8 * h, rows - 1);
          mv[m][j][2 * h + c] =
              __ldg(TRANSPOSED ? mask + (long long)col * Nk + r
                               : mask + (long long)r * Nk + col);
        }
    }
}

// The forward's mask values, from L2, at keys k0 + jcol and k0 + jcol + 1
// (jcol = 8 j + 2 t) of this thread's rows 16 m + 8 h past row (the warp's
// first + g); indices past the end are clamped.
template <int MT>
__device__ __forceinline__ void mask_pair(const float* __restrict__ mask,
                                          int Nq, int Nk, int row, int k0,
                                          int jcol, float (&mk)[MT][2][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* mr =
          mask + (long long)min(row + 16 * m + 8 * h, Nq - 1) * Nk;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        mk[m][h][c] = __ldg(mr + min(k0 + jcol + c, Nk - 1));
    }
}

// Splits of a pass's streamed side. With `blocks` blocks on `slots` places,
// s splits of per = ceil(tiles / s) tiles each (ceil(tiles / per) of them
// once the tiles are evened out, so that no split is empty) take
// ceil(blocks * splits / slots) waves of per tiles: more splits fill an
// idle card and even out the last wave. Take the fewest within 5% of the
// least time, no more than 16, than there are tiles, or than the workspace
// holds (per_split floats each).
inline int tc_splits(long long blocks, int slots, int tiles,
                     long long per_split, long long ws_floats, int* per) {
  const long long most = max(1LL, min(min(16LL, (long long)tiles),
                                       ws_floats / per_split));
  *per = tiles;
  long long best_time = ceil_div(blocks, slots) * (long long)tiles;
  for (int s = 2; s <= most; ++s) {
    const int p = ceil_div(tiles, s);
    const long long time =
        ceil_div(blocks * ceil_div(tiles, p), slots) * (long long)p;
    if (time < 0.95 * best_time) {
      *per = p;
      best_time = time;
    }
  }
  return ceil_div(tiles, *per);
}

// ------------------------------------------------- attention forward

// Batch row z = b * H + h is head h of batch b: its row n of q and k lies
// at p[b * sb + n * sn + h * D], of v and out at ... + h * DV. row_max /
// row_sum are [B * H, Nq] (null: not kept); bias is [B, Nk] or null; mask
// is [mask_nw, Nq, Nk] or null, batch b reading mask[b % mask_nw].
// part_o [splits, B * H, Nq, DV] and part_stats [2, splits, B * H, Nq]
// (max, then sum) hold the partials of a split pass.
struct TcFwdArgs {
  AttnOperand q, k, v;
  const float* bias;
  const float* mask;
  int mask_nw;
  AttnGrad out;
  float* row_max;
  float* row_sum;
  float* part_o;
  float* part_stats;
  int H, Nq, Nk;
  float scale;
  int tiles_per_split;
};

// Grid (query tiles, key splits, B * H). Split s of a batch row takes the
// key tiles [s * tiles_per_split, ...). With one split a block writes out
// and, with KEEP, the row statistics; otherwise its normalised partial
// output and that partial's max and sum. Without HEADS, H is 1 and out is
// a dense [B, Nq, DV] (its strides are not read). STATS_BF16 (the statistics
// pass of kernel C's bf16 backward; KEEP): q.p and k.p hold bf16 bits, read
// into bf16 tiles and widened as the fragments are built, so q k^T is one
// TF32 product; only the row max and sum are kept (no P v, no output, v is
// not read).
template <int D, int DV, int WARPS, int MT, int STR, bool MASKED, bool HEADS,
          bool KEEP, bool STATS_BF16 = false>
__global__ void __launch_bounds__(
    32 * WARPS, (TcFwd<D, DV, WARPS, MT, STR, STATS_BF16>::kBlocksPerSm))
attention_fwd_tc_kernel(TcFwdArgs a) {
  using L = TcFwd<D, DV, WARPS, MT, STR, STATS_BF16>;
  using TQK = std::conditional_t<STATS_BF16, uint16_t, float>;
  static_assert(!STATS_BF16 || KEEP,
                "the statistics pass keeps its statistics");
  extern __shared__ __align__(16) float tc_smem[];
  TQK* Qs = reinterpret_cast<TQK*>(tc_smem);  // [kRes][kLd]
  float* stages = tc_smem + L::kResTile;
  // a stage: K [STR][kLd]; V [STR][DV + 4] or [STR][2]; bias [STR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * L::kRes;
  const int row0 = q0 + warp * L::kWarpRows;  // this warp's first query
  const int split = blockIdx.y, splits = gridDim.y, z = blockIdx.z;
  const int b = HEADS ? z / a.H : z, h = HEADS ? z % a.H : 0;
  const TQK* kp =
      reinterpret_cast<const TQK*>(a.k.p) + b * a.k.sb + (long long)h * D;
  const float* vp = a.v.p + b * a.v.sb + (long long)h * DV;
  const float* bias = a.bias ? a.bias + (long long)b * a.Nk : nullptr;
  const float* mask =
      MASKED && a.mask
          ? a.mask + (long long)(b % a.mask_nw) * a.Nq * a.Nk
          : nullptr;

  const uint16_t* q_bits =
      reinterpret_cast<const uint16_t*>(a.q.p) + b * a.q.sb + (long long)h * D;
  if constexpr (STATS_BF16)
    load_tile_async<D, L::kThreads>(Qs, q_bits, a.q.sn, q0, a.Nq, L::kRes,
                                    tid);
  else
    load_tile_async<D, L::kThreads>(Qs, a.q.p + b * a.q.sb + (long long)h * D,
                                    a.q.sn, q0, a.Nq, L::kRes, tid);

  auto fill = [&](int tile, int s) {
    float* st = stages + s * L::kStage;
    const int k0 = tile * STR;
    load_tile_async<D, L::kThreads>(reinterpret_cast<TQK*>(st), kp, a.k.sn,
                                    k0, a.Nk, STR, tid);
    if constexpr (STATS_BF16) {
    } else if constexpr (L::kWide)
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
    for (int hf = 0; hf < 2; ++hf) {
      mrow[m][hf] = -INFINITY;
      lrow[m][hf] = 0.f;
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
    const int s = (tile - t_beg) % L::kStages;
    // this tile has landed, and every warp is done with the one before,
    // whose stage the next tile's copy may now overwrite
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < t_end) fill(tile + 1, (s + 1) % L::kStages);
    const TQK* Ks = reinterpret_cast<const TQK*>(stages + s * L::kStage);
    const float* Vs = stages + s * L::kStage + L::kStrTile;
    const float* bias_s = Vs + L::kStrTileV;
    const int k0 = tile * STR;

    float prod[1][MT][L::kNT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < L::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) prod[0][m][j][e] = 0.f;
    warp_gemm_nt<1, D, MT, L::kNT, L::kLd, L::kLd, 0, 0, 1>(
        Qs + warp * L::kWarpRows * L::kLd, Ks, (const float*)nullptr,
        (const float*)nullptr, g, t, prod);
    float(&sc)[MT][L::kNT][4] = prod[0];

    // scaled, biased (masked) scores; keys past the end of the tile at -inf
    float mnew[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) mnew[m][hf] = -INFINITY;
#pragma unroll
    for (int j = 0; j < L::kNT; ++j) {
      // the mask at this column pair, read where it is added: read before
      // the products (as the backward does) it would hold 32 registers
      // that the 128-wide tiling does not have
      float mk[MASKED ? MT : 1][2][2];
      if constexpr (MASKED)
        if (mask) mask_pair<MT>(mask, a.Nq, a.Nk, row0 + g, k0, 8 * j + 2 * t,
                                mk);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const bool ok = k0 + col < a.Nk;
        const float bs = bias ? bias_s[col] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 2 * hf + c;
            float x = sc[m][j][e] * a.scale + bs;
            if constexpr (MASKED)
              if (mask) x += mk[m][hf][c];
            x = ok ? x : -INFINITY;
            sc[m][j][e] = x;
            mnew[m][hf] = fmaxf(mnew[m][hf], x);
          }
      }
    }
    // the row max over the quad, the rescale of what came before
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = mnew[m][hf];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, mrow[m][hf]);
        const float alpha = __expf(mrow[m][hf] - mx);  // 0 on the first tile
        mrow[m][hf] = mnew[m][hf] = mx;
        lrow[m][hf] *= alpha;
#pragma unroll
        for (int n = 0; n < kAccN; ++n) {
          acc[m][n][2 * hf] *= alpha;
          acc[m][n][2 * hf + 1] *= alpha;
        }
      }
    // P in place of S; with DV = 2 also O += P v here
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        float v0 = 0.f, v1 = 0.f;
        if constexpr (!L::kWide && !STATS_BF16) {
          v0 = Vs[2 * col];
          v1 = Vs[2 * col + 1];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 2 * hf + c;
            const float p = __expf(sc[m][j][e] - mnew[m][hf]);
            sc[m][j][e] = p;
            lrow[m][hf] += p;
            if constexpr (!L::kWide && !STATS_BF16) {
              acc[m][0][2 * hf] = fmaf(p, v0, acc[m][0][2 * hf]);
              acc[m][0][2 * hf + 1] = fmaf(p, v1, acc[m][0][2 * hf + 1]);
            }
          }
      }
    if constexpr (L::kWide && !STATS_BF16)
      warp_gemm_ak<DV, MT, L::kNT, L::kLdV>(sc, Vs, g, t, acc);
  }

  // the four lanes of a row hold parts of its sum (and, with DV = 2, of its
  // two outputs)
  const bool whole = splits == 1;
  const long long rows = (long long)gridDim.z * a.Nq;
  float* o_dst = nullptr;
  long long o_sn = DV;
  if (!whole) {
    o_dst = a.part_o + ((long long)split * gridDim.z + z) * a.Nq * DV;
  } else if constexpr (HEADS) {
    o_dst = a.out.p + b * a.out.sb + (long long)h * DV;
    o_sn = a.out.sn;
  } else if constexpr (!STATS_BF16) {
    o_dst = a.out.p + (long long)b * a.Nq * DV;
  }
  float* m_dst = whole ? (KEEP ? a.row_max + (long long)z * a.Nq : nullptr)
                       : a.part_stats + ((long long)split * gridDim.z + z) *
                                            a.Nq;
  float* l_dst = whole ? (KEEP ? a.row_sum + (long long)z * a.Nq : nullptr)
                       : m_dst + splits * rows;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = lrow[m][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if constexpr (!L::kWide) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& o = acc[m][0][2 * hf + c];
          o += __shfl_xor_sync(0xffffffffu, o, 1);
          o += __shfl_xor_sync(0xffffffffu, o, 2);
        }
      }
      const int n = row0 + 16 * m + g + 8 * hf;
      if (n >= a.Nq) continue;
      const float inv = 1.0f / l;
      if (STATS_BF16 && whole) {
      } else if constexpr (L::kWide) {
#pragma unroll
        for (int c = 0; c < DV / 8; ++c)
          *reinterpret_cast<float2*>(o_dst + n * o_sn + 8 * c + 2 * t) =
              make_float2(acc[m][c][2 * hf] * inv,
                          acc[m][c][2 * hf + 1] * inv);
      } else if (t == 0) {
        *reinterpret_cast<float2*>(o_dst + n * o_sn) =
            make_float2(acc[m][0][2 * hf] * inv, acc[m][0][2 * hf + 1] * inv);
      }
      if (m_dst && t == 0) {
        m_dst[n] = mrow[m][hf];
        l_dst[n] = l;
      }
    }
}

// Row r = z * Nq + n of the merged output (z = b * H + h), written at
// out.p[b * sb + n * sn + h * W + col]: sum_s w_s part_o[s] / sum_s w_s with
// w_s = l_s exp(m_s - max m), the splits taken in order; row_max / row_sum
// (if not null) [B * H, Nq] get max m and sum_s w_s.
template <int W>
__global__ void attention_merge_kernel(const float* __restrict__ part_o,
                                       const float* __restrict__ part_stats,
                                       int splits, int H, int Nq,
                                       long long rows, AttnGrad out,
                                       float* __restrict__ row_max,
                                       float* __restrict__ row_sum) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * W) return;
  const long long r = idx / W;
  const int col = (int)(idx % W);
  const float* pm = part_stats + r;
  const float* pl = pm + splits * rows;
  const float* po = part_o + idx;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pm[s * rows]);
  float wsum = 0.f, o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = pl[s * rows] * __expf(pm[s * rows] - mx);
    wsum += w;
    o = fmaf(w, po[s * rows * W], o);
  }
  const int z = (int)(r / Nq), n = (int)(r % Nq);
  out.p[(z / H) * out.sb + (long long)n * out.sn + (long long)(z % H) * W +
        col] = o / wsum;
  if (row_max && col == 0) {
    row_max[r] = mx;
    row_sum[r] = wsum;
  }
}

template <int D, int DV, int WARPS, int MT, int STR, bool MASKED, bool HEADS,
          bool KEEP, bool STATS_BF16>
cudaError_t attention_fwd_tc_launch(const TcFwdArgs& a, dim3 grid,
                                    cudaStream_t stream) {
  using L = TcFwd<D, DV, WARPS, MT, STR, STATS_BF16>;
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_tc_kernel<D, DV, WARPS, MT, STR, MASKED, HEADS, KEEP,
                              STATS_BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (attr != cudaSuccess) return attr;
  attention_fwd_tc_kernel<D, DV, WARPS, MT, STR, MASKED, HEADS, KEEP,
                          STATS_BF16>
      <<<grid, L::kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The key splits of a forward over BH batch rows (tiles_per_split in *per)
// and the floats of workspace their partials take (0 with one split), given
// ws_floats of it.
template <int D, int DV, int WARPS, int MT, int STR>
int attention_fwd_tc_splits(int BH, int Nq, int Nk, long long ws_floats,
                            int* per, long long* floats) {
  using L = TcFwd<D, DV, WARPS, MT, STR>;
  const long long rows = (long long)BH * Nq;
  const int splits =
      tc_splits((long long)ceil_div(Nq, L::kRes) * BH,
                kSmCount * L::kBlocksPerSm, ceil_div(Nk, STR),
                rows * (DV + 2), ws_floats, per);
  *floats = splits > 1 ? splits * rows * (DV + 2) : 0;
  return splits;
}

// out = softmax(q k^T scale + bias + mask) v per head. q, out: [B, Nq, H *
// .]; k, v: [B, Nk, H * .] (head h at columns h * D of q and k, h * DV of v
// and out), read only by the HEADS instantiations (kernel A's; the others
// take H = 1 and a dense out: C's and F's registers stay as they were);
// bias [B, Nk] or null; mask [mask_nw, Nq, Nk] or null, read only by the
// MASKED instantiations (the others take no mask: its registers would cost
// C's and F's tilings).
// row_max and row_sum [B * H, Nq] are written when row_max is not null (a
// gradient will be taken). ws: room for the partials of a split pass (fewer
// splits when it is short; attention_fwd_tc_splits says how much it takes).
// STATS_BF16: q.p and k.p point at bf16 q and k,
// and only row_max and row_sum are written (out.p null, v not read; see
// attention_fwd_tc_kernel). Its tiles take the bytes of bf16 and its blocks
// the places of the fp32 instantiation, so both take the same splits and
// sum in the same order; with splits, its partial outputs (zeros: no P v)
// and the merge's output go to ws, and the merge is the fp32 one (another
// merge of the statistics alone compiles its sum otherwise: other bits).
template <int D, int DV, int WARPS, int MT, int STR, bool MASKED = false,
          bool HEADS = false, bool STATS_BF16 = false>
cudaError_t attention_fwd_tc(AttnOperand q, AttnOperand k, AttnOperand v,
                             const float* bias, const float* mask,
                             int mask_nw, AttnGrad out, float* row_max,
                             float* row_sum, int B, int H, int Nq, int Nk,
                             float scale, Workspace ws, cudaStream_t stream) {
  using L = TcFwd<D, DV, WARPS, MT, STR, STATS_BF16>;
  static_assert(L::kBlocksPerSm == TcFwd<D, DV, WARPS, MT, STR>::kBlocksPerSm,
                "the fp32 instantiation's places");
  if ((mask && !MASKED) || (STATS_BF16 && (!row_max || out.p)) ||
      (!HEADS && (H != 1 || out.sn != DV || out.sb != (long long)Nq * DV)))
    return cudaErrorInvalidValue;
  TcFwdArgs a;
  a.q = q; a.k = k; a.v = v;
  a.bias = bias;
  a.mask = mask; a.mask_nw = mask_nw;
  a.out = out; a.row_max = row_max; a.row_sum = row_sum;
  a.part_o = a.part_stats = nullptr;
  a.H = H; a.Nq = Nq; a.Nk = Nk;
  a.scale = scale;
  const int BH = B * H;
  const long long rows = (long long)BH * Nq;
  long long part_floats;
  const int splits = attention_fwd_tc_splits<D, DV, WARPS, MT, STR>(
      BH, Nq, Nk, ws.n, &a.tiles_per_split, &part_floats);
  AttnGrad merged = out;  // a statistics pass merges into scratch
  if (splits > 1) {
    a.part_o = ws.p;
    a.part_stats = ws.p + splits * rows * DV;
    if constexpr (STATS_BF16) {
      if (ws.n < part_floats + rows * DV) return cudaErrorInvalidValue;
      merged = AttnGrad{ws.p + part_floats, (long long)Nq * DV, DV};
    }
  }
  const dim3 grid(ceil_div(Nq, L::kRes), splits, BH);
  cudaError_t err;
  if constexpr (STATS_BF16)
    err = attention_fwd_tc_launch<D, DV, WARPS, MT, STR, MASKED, HEADS, true,
                                  true>(a, grid, stream);
  else
    err = row_max ? attention_fwd_tc_launch<D, DV, WARPS, MT, STR, MASKED,
                                            HEADS, true, false>(
                        a, grid, stream)
                  : attention_fwd_tc_launch<D, DV, WARPS, MT, STR, MASKED,
                                            HEADS, false, false>(
                        a, grid, stream);
  if (err != cudaSuccess || splits == 1) return err;
  attention_merge_kernel<DV><<<ceil_div(rows * DV, 256), 256, 0, stream>>>(
      a.part_o, a.part_stats, splits, H, Nq, rows, merged, row_max, row_sum);
  return cudaGetLastError();
}

// ------------------------------------------------ attention backward

// Batch row z = b * H + h is head h of batch b: its row n of q, k (and dq,
// dk) lies at p[b * sb + n * sn + h * D], of v, dO (and dv) at ... + h * DV.
// row_max, row_sum (the forward's) and delta = rowsum(dO o out) are [B * H,
// Nq]; bias is [B, Nk] or null; mask is [mask_nw, Nq, Nk] or null, batch b
// reading mask[b % mask_nw]. part_a / part_b: partials of a split pass.
struct TcBwdArgs {
  AttnOperand q, k, v, go;
  const float* bias;
  const float* mask;
  int mask_nw;
  const float* row_max;
  const float* row_sum;
  const float* delta;
  AttnGrad dq, dk, dv;
  float* part_a;
  float* part_b;
  int B, H, Nq, Nk;
  float scale;
  int tiles_per_split;
};

// delta[b * H + h, n] = sum_c x[b, n, h * W + c] * y[b, n, h * W + c]; one
// warp per row.
template <int W>
__global__ void rowdot_kernel(AttnOperand x, AttnOperand y, int BH, int H,
                              int rows, float* __restrict__ out) {
  const long long r =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= (long long)BH * rows) return;
  const int lane = threadIdx.x % 32;
  const int z = (int)(r / rows), n = (int)(r % rows);
  const int b = z / H, h = z % H;
  const float* xr = x.p + b * x.sb + (long long)n * x.sn + (long long)h * W;
  const float* yr = y.p + b * y.sb + (long long)n * y.sn + (long long)h * W;
  float s = 0.f;
  for (int c = lane; c < W; c += 32) s = fmaf(xr[c], yr[c], s);
  s = warp_sum(s);
  if (lane == 0) out[r] = s;
}

// dst(b, n, h * width + col) = sum over the splits of part[split][b * H +
// h][n][col], the splits in order; OUT float, or __nv_bfloat16 (the sum
// rounded to the nearest bf16, the one rounding of a bf16 grad).
template <typename OUT = float>
__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    int splits, int BH, int H, int rows,
                                    int width, AttnGrad dst) {
  const long long per = (long long)BH * rows * width;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * per + idx];
  const int col = (int)(idx % width);
  const long long zn = idx / width;
  const int n = (int)(zn % rows), z = (int)(zn / rows);
  const int b = z / H, h = z % H;
  const long long at =
      b * dst.sb + (long long)n * dst.sn + (long long)h * width + col;
  if constexpr (std::is_same_v<OUT, float>)
    dst.p[at] = s;
  else
    reinterpret_cast<OUT*>(dst.p)[at] = __float2bfloat16_rn(s);
}

// acc[m][c][2h], acc[m][c][2h + 1] hold columns 8c + 2t, 8c + 2t + 1 of row
// row0 + 16m + g + 8h: written times scale where the row lies below rows,
// as fp32 (OUT float) or rounded to bf16 (OUT __nv_bfloat16).
template <int W, int MT, typename OUT = float>
__device__ __forceinline__ void store_fragments(
    const float (&acc)[MT][W / 8][4], OUT* dst, long long sn, int row0,
    int rows, int g, int t, float scale) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = row0 + 16 * m + g + 8 * h;
      if (n >= rows) continue;
#pragma unroll
      for (int c = 0; c < W / 8; ++c) {
        const float x0 = acc[m][c][2 * h] * scale;
        const float x1 = acc[m][c][2 * h + 1] * scale;
        OUT* at = dst + n * sn + 8 * c + 2 * t;
        if constexpr (std::is_same_v<OUT, float>)
          *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x0, x1);
      }
    }
}

// A pass's grad at base + off: its whole grad (one split) in fp32, or with
// BF16 rounded to bf16 (base then holds bf16, off and sn count bf16
// elements); a split's partial always in fp32.
template <int W, int MT, bool BF16>
__device__ __forceinline__ void store_grad(const float (&acc)[MT][W / 8][4],
                                           float* base, long long off,
                                           long long sn, int row0, int rows,
                                           int g, int t, float scale,
                                           bool partial) {
  if constexpr (BF16) {
    if (!partial) {
      store_fragments<W, MT>(acc, reinterpret_cast<__nv_bfloat16*>(base) + off,
                             sn, row0, rows, g, t, scale);
      return;
    }
  }
  store_fragments<W, MT>(acc, base + off, sn, row0, rows, g, t, scale);
}

// The ring of a pass's streamed tiles: fill(tile, stage) issues the copies
// of a tile (none past t_end) and commits them as one group, so that every
// iteration finds STAGES - 1 groups in flight. A stage is refilled after
// the barrier of the iteration that follows its last use.
template <int STAGES, typename Fill>
__device__ __forceinline__ void ring_prologue(Fill& fill, int t_beg) {
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fill(t_beg + i, i);
}
template <int STAGES, typename Fill>
__device__ __forceinline__ int ring_next(Fill& fill, int tile, int t_beg) {
  // this tile has landed, and every warp is done with the one before,
  // whose stage the copy of tile + STAGES - 1 may now overwrite while this
  // one is multiplied
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  const int s = (tile - t_beg) % STAGES;
  fill(tile + STAGES - 1, (s + STAGES - 1) % STAGES);
  return s;
}

// Query-tiled pass, grid (query tiles, key splits, B): dq = scale * sum over
// this split's keys of dS k, written to dq with one split and to
// part_a[split] otherwise. Q16 (K16): q (k) is bf16 (q.p, k.p hold the
// bits), read into a bf16 tile and widened as the fragments are built, so
// that S = q k^T takes one TF32 product less (two with both bf16) and, with
// K16, dS k one less; with Q16 dq is written in bf16.
template <int D, int DV, int WARPS, int MT, int STR, bool MASKED,
          bool Q16 = false, bool K16 = Q16>
__global__ void __launch_bounds__(
    32 * WARPS, (TcBwd<D, DV, WARPS, MT, STR, Q16, K16>::kBlocksPerSm))
attention_bwd_tc_dq_kernel(TcBwdArgs a) {
  using L = TcBwd<D, DV, WARPS, MT, STR, Q16, K16>;
  using TQ = std::conditional_t<Q16, uint16_t, float>;
  using TK = std::conditional_t<K16, uint16_t, float>;
  extern __shared__ __align__(16) float tc_smem[];
  TQ* Qs = reinterpret_cast<TQ*>(tc_smem);  // [kRes][kLdRes]
  float* Gs = tc_smem + L::kResTile;        // [kRes][DV + 4] (wide only)
  float* stages = Gs + L::kResTileV;
  // a stage: K [STR][kLdStr]; V [STR][DV + 4] or [STR][2]; bias [STR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * L::kRes;
  const int row0 = q0 + warp * L::kWarpRows;  // this warp's first query
  const int split = blockIdx.y, splits = gridDim.y, z = blockIdx.z;
  const int b = z / a.H, h = z % a.H;
  const TQ* qp =
      reinterpret_cast<const TQ*>(a.q.p) + b * a.q.sb + (long long)h * D;
  const TK* kp =
      reinterpret_cast<const TK*>(a.k.p) + b * a.k.sb + (long long)h * D;
  const float* vp = a.v.p + b * a.v.sb + (long long)h * DV;
  const float* gp = a.go.p + b * a.go.sb + (long long)h * DV;
  const float* bias = a.bias ? a.bias + (long long)b * a.Nk : nullptr;
  const float* mask =
      MASKED && a.mask ? a.mask + (long long)(b % a.mask_nw) * a.Nq * a.Nk
                       : nullptr;

  load_tile_async<D, L::kThreads>(Qs, qp, a.q.sn, q0, a.Nq, L::kRes, tid);
  if constexpr (L::kWide)
    load_tile_async<DV, L::kThreads>(Gs, gp, a.go.sn, q0, a.Nq, L::kRes, tid);

  const int tiles = (a.Nk + STR - 1) / STR;
  const int t_beg = split * a.tiles_per_split;
  const int t_end = min(tiles, t_beg + a.tiles_per_split);
  auto fill = [&](int tile, int s) {
    if (tile < t_end) {
      float* st = stages + s * L::kStage;
      const int k0 = tile * STR;
      load_tile_async<D, L::kThreads>(reinterpret_cast<TK*>(st), kp, a.k.sn,
                                      k0, a.Nk, STR, tid);
      if constexpr (L::kWide)
        load_tile_async<DV, L::kThreads>(st + L::kStrTile, vp, a.v.sn, k0,
                                         a.Nk, STR, tid);
      else
        load_vector_async<8, L::kThreads>(st + L::kStrTile, vp, k0, a.Nk, STR,
                                          tid);
      if (bias)
        load_vector_async<4, L::kThreads>(st + L::kStrTile + L::kStrTileV,
                                          bias, k0, a.Nk, STR, tid);
    }
    cp_async_commit();
  };

  // this thread's rows: g and g + 8 of each of the warp's fragments
  float rmax[MT][2], rinv[MT][2], rdel[MT][2], gr[MT][2][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = row0 + 16 * m + g + 8 * hf;
      const bool ok = n < a.Nq;
      const long long row = (long long)z * a.Nq + n;
      rmax[m][hf] = ok ? a.row_max[row] : 0.f;
      rinv[m][hf] = ok ? 1.0f / a.row_sum[row] : 0.f;
      rdel[m][hf] = ok ? a.delta[row] : 0.f;
      gr[m][hf][0] = gr[m][hf][1] = 0.f;
      if (!L::kWide && ok) {
        gr[m][hf][0] = gp[(long long)n * a.go.sn];
        gr[m][hf][1] = gp[(long long)n * a.go.sn + 1];
      }
    }

  float acc[MT][D / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  ring_prologue<L::kStages>(fill, t_beg);
  for (int tile = t_beg; tile < t_end; ++tile) {
    const int s = ring_next<L::kStages>(fill, tile, t_beg);
    const TK* Ks = reinterpret_cast<const TK*>(stages + s * L::kStage);
    const float* Vs = stages + s * L::kStage + L::kStrTile;
    const float* bias_s = Vs + L::kStrTileV;
    const int k0 = tile * STR;
    // from L2, this tile's mask values, read before the products so that
    // the loads overlap them
    float mv[MASKED ? MT : 1][MASKED ? L::kNT : 1][4];
    if constexpr (MASKED)
      if (mask)
        mask_from_l2<MT, L::kNT, false>(mask, a.Nq, a.Nk, row0 + g, k0, t,
                                        mv);

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
    warp_gemm_nt<L::kProducts, D, MT, L::kNT, L::kLdRes, L::kLdStr, L::kLdV,
                 L::kLdV, L::kProducts>(Qs + warp * L::kWarpRows * L::kLdRes,
                                        Ks, Gs + warp * L::kWarpRows * L::kLdV,
                                        Vs, g, t, prod);
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
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 2 * hf + c;
            float x = sc[m][j][e] * a.scale + bs;
            if constexpr (MASKED)
              if (mask) x += mv[m][j][e];
            const float p =
                ok ? __expf(x - rmax[m][hf]) * rinv[m][hf] : 0.f;
            const float d = L::kWide
                                ? dp[m][j][e]
                                : fmaf(gr[m][hf][0], v0, gr[m][hf][1] * v1);
            sc[m][j][e] = p * (d - rdel[m][hf]);
          }
      }
    warp_gemm_ak<D, MT, L::kNT, L::kLdStr, false, TK>(sc, Ks, g, t, acc);
  }

  if (splits == 1)
    store_grad<D, MT, Q16>(acc, a.dq.p, b * a.dq.sb + (long long)h * D,
                           a.dq.sn, row0, a.Nq, g, t, a.scale, false);
  else
    store_grad<D, MT, Q16>(
        acc, a.part_a, ((long long)split * a.B * a.H + z) * a.Nq * D, D, row0,
        a.Nq, g, t, a.scale, true);
}

// Key-tiled pass, grid (key tiles, query splits, B): over this split's
// queries dv = sum P^T dO and dk = scale * sum dS^T q, written to dk / dv
// with one split and to part_a / part_b[split] otherwise. dk or dv may be
// null (not computed). Q16 and K16 as in the query-tiled pass: S^T = k q^T
// one TF32 product less for each bf16 side, dS^T q one less with Q16; with
// K16 dk is written in bf16; dv in fp32.
template <int D, int DV, int WARPS, int MT, int STR, bool MASKED,
          bool Q16 = false, bool K16 = Q16>
__global__ void __launch_bounds__(
    32 * WARPS, (TcBwd<D, DV, WARPS, MT, STR, K16, Q16>::kBlocksPerSm))
attention_bwd_tc_dkv_kernel(TcBwdArgs a) {
  using L = TcBwd<D, DV, WARPS, MT, STR, K16, Q16>;
  using TQ = std::conditional_t<Q16, uint16_t, float>;
  using TK = std::conditional_t<K16, uint16_t, float>;
  extern __shared__ __align__(16) float tc_smem[];
  TK* Ks = reinterpret_cast<TK*>(tc_smem);  // [kRes][kLdRes]
  float* Vs = tc_smem + L::kResTile;        // [kRes][DV + 4] (wide only)
  float* stages = Vs + L::kResTileV;
  // a stage: Q [STR][kLdStr]; dO [STR][DV + 4] or [STR][2]; row max, row
  // sum, delta [STR] each

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * L::kRes;
  const int row0 = k0 + warp * L::kWarpRows;  // this warp's first key
  const int split = blockIdx.y, splits = gridDim.y, z = blockIdx.z;
  const int b = z / a.H, h = z % a.H;
  const TQ* qp =
      reinterpret_cast<const TQ*>(a.q.p) + b * a.q.sb + (long long)h * D;
  const TK* kp =
      reinterpret_cast<const TK*>(a.k.p) + b * a.k.sb + (long long)h * D;
  const float* vp = a.v.p + b * a.v.sb + (long long)h * DV;
  const float* gp = a.go.p + b * a.go.sb + (long long)h * DV;
  const float* row_max = a.row_max + (long long)z * a.Nq;
  const float* row_sum = a.row_sum + (long long)z * a.Nq;
  const float* delta = a.delta + (long long)z * a.Nq;
  // the mask is read transposed: column n of key row j at mask[n * Nk + j]
  const float* mask =
      MASKED && a.mask ? a.mask + (long long)(b % a.mask_nw) * a.Nq * a.Nk
                       : nullptr;
  const bool want_k = a.dk.p != nullptr, want_v = a.dv.p != nullptr;

  load_tile_async<D, L::kThreads>(Ks, kp, a.k.sn, k0, a.Nk, L::kRes, tid);
  if constexpr (L::kWide)
    load_tile_async<DV, L::kThreads>(Vs, vp, a.v.sn, k0, a.Nk, L::kRes, tid);

  const int tiles = (a.Nq + STR - 1) / STR;
  const int t_beg = split * a.tiles_per_split;
  const int t_end = min(tiles, t_beg + a.tiles_per_split);
  auto fill = [&](int tile, int s) {
    if (tile < t_end) {
      float* st = stages + s * L::kStage;
      const int n0 = tile * STR;
      load_tile_async<D, L::kThreads>(reinterpret_cast<TQ*>(st), qp, a.q.sn,
                                      n0, a.Nq, STR, tid);
      if constexpr (L::kWide)
        load_tile_async<DV, L::kThreads>(st + L::kStrTile, gp, a.go.sn, n0,
                                         a.Nq, STR, tid);
      else
        load_vector_async<8, L::kThreads>(st + L::kStrTile, gp, n0, a.Nq, STR,
                                          tid);
      float* vec = st + L::kStrTile + L::kStrTileV;
      load_vector_async<4, L::kThreads>(vec, row_max, n0, a.Nq, STR, tid);
      load_vector_async<4, L::kThreads>(vec + STR, row_sum, n0, a.Nq, STR,
                                        tid);
      load_vector_async<4, L::kThreads>(vec + 2 * STR, delta, n0, a.Nq, STR,
                                        tid);
    }
    cp_async_commit();
  };

  // this thread's key rows
  float rbias[MT][2], vr[MT][2][2], dvp[MT][2][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = row0 + 16 * m + g + 8 * hf;
      const bool ok = key < a.Nk;
      rbias[m][hf] = a.bias && ok ? a.bias[(long long)b * a.Nk + key] : 0.f;
      vr[m][hf][0] = vr[m][hf][1] = dvp[m][hf][0] = dvp[m][hf][1] = 0.f;
      if (!L::kWide && ok) {
        vr[m][hf][0] = vp[(long long)key * a.v.sn];
        vr[m][hf][1] = vp[(long long)key * a.v.sn + 1];
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

  ring_prologue<L::kStages>(fill, t_beg);
  for (int tile = t_beg; tile < t_end; ++tile) {
    const int s = ring_next<L::kStages>(fill, tile, t_beg);
    const TQ* Qs = reinterpret_cast<const TQ*>(stages + s * L::kStage);
    const float* Gs = stages + s * L::kStage + L::kStrTile;
    const float* max_s = Gs + L::kStrTileV;
    const float* sum_s = max_s + STR;
    const float* del_s = sum_s + STR;
    const int n0 = tile * STR;
    // from L2, this tile's mask values (transposed), read before the
    // products
    float mv[MASKED ? MT : 1][MASKED ? L::kNT : 1][4];
    if constexpr (MASKED)
      if (mask)
        mask_from_l2<MT, L::kNT, true>(mask, a.Nq, a.Nk, row0 + g, n0, t, mv);

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
    warp_gemm_nt<L::kProducts, D, MT, L::kNT, L::kLdRes, L::kLdStr, L::kLdV,
                 L::kLdV, 2>(Ks + warp * L::kWarpRows * L::kLdRes, Qs,
                             Vs + warp * L::kWarpRows * L::kLdV, Gs, g, t,
                             prod);
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
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 2 * hf + c;
            float x = pt[m][j][e] * a.scale + rbias[m][hf];
            if constexpr (MASKED)
              if (mask) x += mv[m][j][e];
            const float p = ok ? __expf(x - mx) * inv : 0.f;
            const float d = L::kWide
                                ? ds[m][j][e]
                                : fmaf(vr[m][hf][0], g0, vr[m][hf][1] * g1);
            pt[m][j][e] = p;
            ds[m][j][e] = p * (d - dl);
            if (!L::kWide) {
              dvp[m][hf][0] = fmaf(p, g0, dvp[m][hf][0]);
              dvp[m][hf][1] = fmaf(p, g1, dvp[m][hf][1]);
            }
          }
      }
    if constexpr (L::kWide) {
      if (want_v) warp_gemm_ak<DV, MT, L::kNT, L::kLdV>(pt, Gs, g, t, acc_v);
    }
    if (want_k)
      warp_gemm_ak<D, MT, L::kNT, L::kLdStr, false, TQ>(ds, Qs, g, t, acc_k);
  }

  float* base_k;
  float* dst_v;
  long long off_k, sn_k, sn_v;
  if (splits == 1) {
    base_k = a.dk.p;
    off_k = b * a.dk.sb + (long long)h * D;
    dst_v = want_v ? a.dv.p + b * a.dv.sb + (long long)h * DV : nullptr;
    sn_k = a.dk.sn;
    sn_v = a.dv.sn;
  } else {
    const long long slot = (long long)split * a.B * a.H + z;
    base_k = a.part_a;
    off_k = slot * a.Nk * D;
    dst_v = want_v ? a.part_b + slot * a.Nk * DV : nullptr;
    sn_k = D;
    sn_v = DV;
  }
  if (want_k)
    store_grad<D, MT, K16>(acc_k, base_k, off_k, sn_k, row0, a.Nk, g, t,
                           a.scale, splits > 1);
  if constexpr (L::kWide) {
    if (want_v)
      store_fragments<DV, MT>(acc_v, dst_v, sn_v, row0, a.Nk, g, t, 1.0f);
  } else if (want_v) {
    // the four lanes of a row hold its columns' partial sums
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          dvp[m][hf][c] += __shfl_xor_sync(0xffffffffu, dvp[m][hf][c], 1);
          dvp[m][hf][c] += __shfl_xor_sync(0xffffffffu, dvp[m][hf][c], 2);
        }
        const int key = row0 + 16 * m + g + 8 * hf;
        if (t == 0 && key < a.Nk)
          *reinterpret_cast<float2*>(dst_v + key * sn_v) =
              make_float2(dvp[m][hf][0], dvp[m][hf][1]);
      }
  }
}

// dq, dk, dv (each may be null) of softmax(q k^T scale + bias + mask) v
// per head. o is the forward's output, go its gradient, row_max / row_sum
// [B * H, Nq] its row statistics. q, go, dq: [B, Nq, H * .]; k, v, dk, dv:
// [B, Nk, H * .]; bias [B, Nk] or null; mask [mask_nw, Nq, Nk] or null,
// read only by the MASKED instantiations (the others take no mask: its
// registers would make C's tiling spill). Q16 (K16): q.p and dq.p (k.p and
// dk.p) point at bf16, their strides in bf16 elements; such a grad is
// rounded once, where it is finished (the unsplit pass, or the ordered sum
// of the split partials). Kernel C's bf16 backward takes both (DV = 2),
// kernel F's Q16 alone. Their tiles take the bytes of bf16 and their blocks
// the places of the fp32 instantiation, so both split alike and sum in the
// same order.
template <int D, int DV, int WARPS, int MT, int STR, bool MASKED = false,
          bool Q16 = false, bool K16 = Q16>
cudaError_t attention_bwd_tc(AttnOperand q, AttnOperand k, AttnOperand v,
                             AttnOperand o, AttnOperand go, const float* bias,
                             const float* mask, int mask_nw,
                             const float* row_max, const float* row_sum,
                             AttnGrad dq, AttnGrad dk, AttnGrad dv, int B,
                             int H, int Nq, int Nk, float scale, Workspace ws,
                             cudaStream_t stream) {
  using Lq = TcBwd<D, DV, WARPS, MT, STR, Q16, K16>;  // query-tiled pass
  using Lk = TcBwd<D, DV, WARPS, MT, STR, K16, Q16>;  // key-tiled pass
  constexpr int kPlaces = TcBwd<D, DV, WARPS, MT, STR>::kBlocksPerSm;
  static_assert(Lq::kBlocksPerSm == kPlaces && Lk::kBlocksPerSm == kPlaces,
                "the fp32 instantiation's places");
  using TGq = std::conditional_t<Q16, __nv_bfloat16, float>;
  using TGk = std::conditional_t<K16, __nv_bfloat16, float>;
  if (mask && !MASKED) return cudaErrorInvalidValue;
  const int BH = B * H;
  const long long rows = (long long)BH * Nq;
  float* delta = ws.take(rows);
  if (!delta) return cudaErrorInvalidValue;
  rowdot_kernel<DV>
      <<<ceil_div(rows, 8), 256, 0, stream>>>(go, o, BH, H, Nq, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  TcBwdArgs a;
  a.q = q; a.k = k; a.v = v; a.go = go;
  a.bias = bias;
  a.mask = mask; a.mask_nw = mask_nw;
  a.row_max = row_max; a.row_sum = row_sum; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.part_a = a.part_b = nullptr;
  a.B = B; a.H = H; a.Nq = Nq; a.Nk = Nk;
  a.scale = scale;
  const int slots = kSmCount * kPlaces;

  if (dq.p) {
    const int res_tiles = ceil_div(Nq, Lq::kRes);
    const int splits =
        tc_splits((long long)res_tiles * BH, slots, ceil_div(Nk, STR),
                  rows * D, ws.n, &a.tiles_per_split);
    if (splits > 1) a.part_a = ws.p;  // free again after the sum below
    // set once per instantiation, not per launch (one card per process)
    static const cudaError_t attr = cudaFuncSetAttribute(
        attention_bwd_tc_dq_kernel<D, DV, WARPS, MT, STR, MASKED, Q16, K16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lq::kBytes);
    if (attr != cudaSuccess) return attr;
    attention_bwd_tc_dq_kernel<D, DV, WARPS, MT, STR, MASKED, Q16, K16>
        <<<dim3(res_tiles, splits, BH), Lq::kThreads, Lq::kBytes, stream>>>(
            a);
    if (splits > 1)
      split_reduce_kernel<TGq><<<ceil_div(rows * D, 256), 256, 0, stream>>>(
          a.part_a, splits, BH, H, Nq, D, dq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dk.p || dv.p) {
    const int res_tiles = ceil_div(Nk, Lk::kRes);
    const long long keys = (long long)BH * Nk;
    const int splits =
        tc_splits((long long)res_tiles * BH, slots, ceil_div(Nq, STR),
                  keys * (D + DV), ws.n, &a.tiles_per_split);
    if (splits > 1) {
      a.part_a = ws.p;
      a.part_b = ws.p + splits * keys * D;
    }
    static const cudaError_t attr = cudaFuncSetAttribute(
        attention_bwd_tc_dkv_kernel<D, DV, WARPS, MT, STR, MASKED, Q16, K16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lk::kBytes);
    if (attr != cudaSuccess) return attr;
    attention_bwd_tc_dkv_kernel<D, DV, WARPS, MT, STR, MASKED, Q16, K16>
        <<<dim3(res_tiles, splits, BH), Lk::kThreads, Lk::kBytes, stream>>>(
            a);
    if (splits > 1 && dk.p)
      split_reduce_kernel<TGk><<<ceil_div(keys * D, 256), 256, 0, stream>>>(
          a.part_a, splits, BH, H, Nk, D, dk);
    if (splits > 1 && dv.p)
      split_reduce_kernel<float>
          <<<ceil_div(keys * DV, 256), 256, 0, stream>>>(
          a.part_b, splits, BH, H, Nk, DV, dv);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
}  // namespace emip
