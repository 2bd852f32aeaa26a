// The GEMM of kernels A, B, G and H on the tensor cores, as 3xTF32
// (fp32-grade: the products of mma_tf32.cuh), on mma.sync. Its callers: the
// fp32 forwards of B, G and H, A's GEMMs, and every backward (the bf16
// backwards' fp32 recompute included). B's and H's bf16 forwards and G's
// and H's bf16 backwards run their x W^T and dy W products on wgmma instead
// (gemm_wgmma.cuh, dy W on the transposed weight); the weight grads dY^T X,
// which read both operands M- or N-major, stay here.
//
//   gemm            C[M,N] (+)= A[M,K] . B[K,N] (+ bias[N]), with both
//                   operands addressed through two strides, so a torch
//                   nn.Linear weight [N,K] is read in place as B = W^T and
//                   a weight gradient dW = dY^T X reads dY transposed.
//                   Epilogues: exact GELU (optionally storing the
//                   pre-activation) and the GELU derivative. Products with
//                   a long K and few output tiles (weight gradients over
//                   all rows) split K across blocks and sum the partials
//                   in a second, ordered pass: no atomics, so every run
//                   gives the same bits;
//   linear, input_grad, weight_grad
//                   y = x W^T (+ b), dx (+)= dy W and dW = dy^T x.
//
// What bounds it: the products, 2 M N K operations. A block of 8 warps owns
// a 128 x 64 output tile; a warp owns 32 x 32 of it as 2 x 4
// accumulator fragments of mma.sync.m16n8k8, and two blocks share an SM
// (127 registers a thread; a 128 x 128 tile needs 210 and one block an SM,
// and was slower at the widest products). K streams in tiles of 32 through
// a ring of three cp.async stages with one barrier per tile. The fragments
// are read from shared memory one float per lane, so either orientation of an
// operand is only an index: a K-major tile (rows of K, the x of a linear)
// is stored [rows][32 + 4], an M- or N-major tile (the dY^T of a weight
// gradient, the W of an input gradient) [32][rows + 8]; both paddings put
// the eight rows and four k of a fragment on 32 different banks. Each
// fragment is split into its TF32 halves as it is read (tf32_split), and
// the three products of a fragment pair are ordered so that no mma waits
// on its neighbour's accumulator (mma_3xtf32). The tensor core truncates
// as it accumulates, so an error summed over all of K grows with K (1.4e-5
// of max|ref| at K = 1824 on the H100, where fp32 with rounding leaves
// 9e-7): each K tile's products go to an accumulator of their own, which
// is added to the running sum with an fp32 add. Ragged M, N and K tiles are
// zero-filled by the copies; where an operand's rows are not 16-byte
// aligned (a leading dimension or contiguous extent that is no multiple of
// 4 floats), its copies are 4 bytes wide.
//
// An operand may be bf16 (the bf16 backwards of kernels A and B: x, t,
// kv_in, A's weights and output gradient): its tiles are copied as bf16,
// half the bytes, and widened as the fragments are built; a bf16 value is
// exact in TF32, so the products of its zero low half are left out
// (mma_3xtf32): one TF32 product of two bf16 operands, two of a bf16 and
// an fp32 one. An fp32 operand that holds bf16 values (B's x1) is read as
// fp32 and counted as exact the same way (ExactF32). The sums are those of
// the three-term products on the widened operands, so the result has the
// fp32 GEMM's bits on them. Any product may add an fp32 or bf16 addend in
// its epilogue (add: B's residuals) and write its output rounded to bf16
// (c_bf16), once, where it is finished: in the epilogue, or in the ordered
// sum of its split-K partials.

#pragma once

#include <stdint.h>

#include "mma_tf32.cuh"

namespace emip {
namespace {

// kEpiAdd: the addend and a bf16 output of a product of fp32 operands (an
// instantiation of its own, so that the others keep their registers)
enum { kEpiNone = 0, kEpiGelu = 1, kEpiGeluGrad = 2, kEpiAdd = 3 };

// A(m, k) at A[m * sam + k * sak]; B(k, n) at B[k * sbk + n * sbn], one of
// each operand's strides being 1; C(m, n) at C[m * ldc + n] (+ blockIdx.z *
// split_stride for split-K partials). aux(m, n) at aux[m * ldaux + n]: the
// pre-activation written by the GELU epilogue or read by the
// GELU-derivative epilogue. add(m, n) at add[m * ldadd + n], fp32 or bf16
// (add_bf16): added to the result last (kEpiAdd, unsplit).
struct GemmArgs {
  const float* A;
  long long sam, sak;
  const float* B;
  long long sbk, sbn;
  const float* bias;
  float* C;
  long long ldc;
  float* aux;
  long long ldaux;
  int M, N, K;
  int kchunk;              // K range of one blockIdx.z
  long long split_stride;  // distance between split-K partial outputs
  bool accumulate;         // C += result instead of C = result
  bool c_bf16;             // C holds bf16 (kEpiAdd or an exact operand)
  const void* add;         // null: no addend
  long long ldadd;
  bool add_bf16;
};

constexpr int kGemmBM = 128;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kGemmStages = 3;
constexpr int kGemmMT = 2;         // 16-row fragments per warp (32 rows)

// Shared-memory plan: AK / BK say whether A / B is stored K-major (k
// contiguous within a row of the tile); A16 / B16 whether it is bf16. The
// leading dims count elements: a bf16 row takes twice the padding in
// elements (the same in bytes), so that a fragment's reads, two values to
// a bank word, fall on 16 different words. Tiles are counted in floats.
template <bool AK, bool BK, bool A16 = false, bool B16 = false>
struct GemmPlan {
  static constexpr int kNT = kGemmBN / 16;  // 8-column fragments per warp
  static constexpr int kPadA = A16 ? 2 : 1, kPadB = B16 ? 2 : 1;
  static constexpr int kLdA = AK ? kGemmBK + 4 * kPadA : kGemmBM + 8 * kPadA;
  static constexpr int kATile = (AK ? kGemmBM * kLdA : kGemmBK * kLdA) / kPadA;
  static constexpr int kLdB = BK ? kGemmBK + 4 * kPadB : kGemmBN + 8 * kPadB;
  static constexpr int kBTile = (BK ? kGemmBN * kLdB : kGemmBK * kLdB) / kPadB;
  static constexpr int kStage = kATile + kBTile;
  static constexpr size_t kBytes = sizeof(float) * kGemmStages * kStage;
};

// dst[o][i] = src[(o0 + o) * s_outer + i0 + i] for o < OUTER, i < INNER
// (dst rows ld elements apart), zeros where o0 + o >= o_end or i0 + i >=
// i_end; T is float, or uint16_t for bf16 bits. vec: 16-byte copies (src
// rows 16-byte aligned, i_end and i0 multiples of 16 bytes' elements);
// else one element a copy, 4-byte cp.async for fp32, and for bf16 plain
// loads and stores (seen by the block after the barrier that precedes the
// tile's use).
template <int OUTER, int INNER, typename T>
__device__ __forceinline__ void gemm_load_tile(T* dst, int ld, const T* src,
                                               long long s_outer, int o0,
                                               int o_end, int i0, int i_end,
                                               bool vec, int tid) {
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kChunks = INNER / kVec;
    constexpr int kStep = kGemmThreads / kChunks;
    static_assert(kGemmThreads % kChunks == 0 && OUTER % kStep == 0,
                  "whole rows per pass of the block");
    const int i = (tid % kChunks) * kVec;
    const bool i_ok = i0 + i < i_end;
#pragma unroll
    for (int o = tid / kChunks; o < OUTER; o += kStep) {
      const bool ok = i_ok && o0 + o < o_end;
      cp_async<16>(dst + o * ld + i,
                   ok ? src + (long long)(o0 + o) * s_outer + i0 + i : src,
                   ok);
    }
  } else {
    for (int e = tid; e < OUTER * INNER; e += kGemmThreads) {
      const int o = e / INNER, i = e % INNER;
      const bool ok = o0 + o < o_end && i0 + i < i_end;
      const T* from = ok ? src + (long long)(o0 + o) * s_outer + i0 + i : src;
      if constexpr (sizeof(T) == 4)
        cp_async<4>(dst + o * ld + i, from, ok);
      else
        dst[o * ld + i] = ok ? *from : T(0);
    }
  }
}

// TA, TB: the operands' element types (float, uint16_t for bf16 bits, or
// ExactF32).
template <bool AK, bool BK, int kEpi, typename TA = float, typename TB = float>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_tc_kernel(GemmArgs g, bool vec_a, bool vec_b) {
  using P = GemmPlan<AK, BK, kBf16<TA>, kBf16<TB>>;
  constexpr bool kMixed = kExact<TA> || kExact<TB>;
  constexpr int kNT = P::kNT;
  const TA* gA = reinterpret_cast<const TA*>(g.A);
  const TB* gB = reinterpret_cast<const TB*>(g.B);
  extern __shared__ __align__(16) float gemm_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const int wr = 32 * (warp % 4);  // the warp's first row in the tile
  const int wc = 32 * (warp / 4);  // and its first column
  const int row0 = blockIdx.y * kGemmBM, col0 = blockIdx.x * kGemmBN;
  const int kbeg = blockIdx.z * g.kchunk;
  const int kend = min(g.K, kbeg + g.kchunk);
  const int tiles = kend > kbeg ? (kend - kbeg + kGemmBK - 1) / kGemmBK : 0;

  // one commit per call, empty past the last tile, so that the number of
  // groups in flight is the same on every iteration
  auto fill = [&](int tile) {
    if (tile < tiles) {
      float* st = gemm_smem + (tile % kGemmStages) * P::kStage;
      TA* as = reinterpret_cast<TA*>(st);
      TB* bs = reinterpret_cast<TB*>(st + P::kATile);
      const int k0 = kbeg + tile * kGemmBK;
      if constexpr (AK)
        gemm_load_tile<kGemmBM, kGemmBK>(as, P::kLdA, gA, g.sam, row0, g.M,
                                         k0, kend, vec_a, tid);
      else
        gemm_load_tile<kGemmBK, kGemmBM>(as, P::kLdA, gA, g.sak, k0, kend,
                                         row0, g.M, vec_a, tid);
      if constexpr (BK)
        gemm_load_tile<kGemmBN, kGemmBK>(bs, P::kLdB, gB, g.sbn, col0, g.N,
                                         k0, kend, vec_b, tid);
      else
        gemm_load_tile<kGemmBK, kGemmBN>(bs, P::kLdB, gB, g.sbk, k0, kend,
                                         col0, g.N, vec_b, tid);
    }
    cp_async_commit();
  };

  float acc[kGemmMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kGemmMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) fill(s);
  for (int tile = 0; tile < tiles; ++tile) {
    // this tile has landed, and every warp is done with the one before,
    // whose stage the copy of tile + 2 may now overwrite
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();
    fill(tile + kGemmStages - 1);
    const float* st = gemm_smem + (tile % kGemmStages) * P::kStage;
    const TA* As = reinterpret_cast<const TA*>(st);
    const TB* Bs = reinterpret_cast<const TB*>(st + P::kATile);
    auto a_at = [&](int r, int k) {
      return AK ? As[r * P::kLdA + k] : As[k * P::kLdA + r];
    };
    auto b_at = [&](int k, int c) {
      return BK ? Bs[c * P::kLdB + k] : Bs[k * P::kLdB + c];
    };
    // this tile's products, added to acc in fp32 at the end of the tile
    float part[kGemmMT][kNT][4];
#pragma unroll
    for (int m = 0; m < kGemmMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < kGemmBK; k8 += 8) {
      uint32_t ah[kGemmMT][4], al[kGemmMT][4];
#pragma unroll
      for (int m = 0; m < kGemmMT; ++m) {
        const int r = wr + 16 * m + gr;
        split_as(a_at(r, k8 + t), ah[m][0], al[m][0]);
        split_as(a_at(r + 8, k8 + t), ah[m][1], al[m][1]);
        split_as(a_at(r, k8 + t + 4), ah[m][2], al[m][2]);
        split_as(a_at(r + 8, k8 + t + 4), ah[m][3], al[m][3]);
      }
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int c = wc + 8 * n + gr;
        split_as(b_at(k8 + t, c), bh[n][0], bl[n][0]);
        split_as(b_at(k8 + t + 4, c), bh[n][1], bl[n][1]);
      }
      mma_3xtf32<kGemmMT, kNT, kNT, kExact<TA>, kExact<TB>>(part, 0, ah, al,
                                                            bh, bl);
    }
#pragma unroll
    for (int m = 0; m < kGemmMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
  }
  cp_async_wait<0>();

  // lane (gr, t) holds rows gr, gr + 8 and columns 2t, 2t + 1 of each
  // fragment
  float* C = g.C + (long long)blockIdx.z * g.split_stride;
#pragma unroll
  for (int m = 0; m < kGemmMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wr + 16 * m + gr + 8 * h;
      if (r >= g.M) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = col0 + wc + 8 * n + 2 * t + c;
          if (col >= g.N) continue;
          float v = acc[m][n][2 * h + c];
          if (g.bias) v += g.bias[col];
          if (kEpi == kEpiGelu) {
            if (g.aux) g.aux[(long long)r * g.ldaux + col] = v;
            v = gelu_exact(v);
          } else if (kEpi == kEpiGeluGrad) {
            v *= gelu_grad(g.aux[(long long)r * g.ldaux + col]);
          }
          if constexpr (kEpi == kEpiAdd) {
            if (g.add) {
              const long long at = (long long)r * g.ldadd + col;
              v = (g.add_bf16
                       ? as_f32(static_cast<const uint16_t*>(g.add)[at])
                       : static_cast<const float*>(g.add)[at]) +
                  v;
            }
          }
          if constexpr (kMixed || kEpi == kEpiAdd) {
            if (g.c_bf16) {  // unsplit: blockIdx.z is 0
              reinterpret_cast<__nv_bfloat16*>(g.C)[(long long)r * g.ldc +
                                                    col] =
                  __float2bfloat16_rn(v);
              continue;
            }
          }
          float* dst = C + (long long)r * g.ldc + col;
          *dst = g.accumulate ? *dst + v : v;
        }
    }
}

// C[r, c] (+)= sum over z of part[z][r, c], z in order; with OUT
// __nv_bfloat16 C holds bf16 and the sum is rounded into it (no +=).
template <typename OUT = float>
__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     int splits, int M, int N, float* C,
                                     long long ldc, bool accumulate) {
  const long long mn = (long long)M * N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + idx];
  const long long at = (idx / N) * ldc + idx % N;
  if constexpr (std::is_same_v<OUT, float>) {
    float* dst = C + at;
    *dst = accumulate ? *dst + s : s;
  } else {
    reinterpret_cast<OUT*>(C)[at] = __float2bfloat16_rn(s);
  }
}

inline bool aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool AK, bool BK, int kEpi, typename TA = float, typename TB = float>
cudaError_t gemm_launch(const GemmArgs& g, int splits, cudaStream_t stream) {
  using P = GemmPlan<AK, BK, kBf16<TA>, kBf16<TB>>;
  // 16-byte copies where the contiguous extent and the other stride are
  // whole multiples of 16 bytes (4 floats, 8 bf16 values)
  constexpr int va = kBf16<TA> ? 8 : 4, vb = kBf16<TB> ? 8 : 4;
  const bool vec_a = aligned16(g.A) && (AK ? g.K % va == 0 && g.sam % va == 0
                                           : g.M % va == 0 && g.sak % va == 0);
  const bool vec_b = aligned16(g.B) && (BK ? g.K % vb == 0 && g.sbn % vb == 0
                                           : g.N % vb == 0 && g.sbk % vb == 0);
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tc_kernel<AK, BK, kEpi, TA, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ceil_div(g.N, kGemmBN), ceil_div(g.M, kGemmBM), splits);
  gemm_tc_kernel<AK, BK, kEpi, TA, TB>
      <<<grid, kGemmThreads, P::kBytes, stream>>>(g, vec_a, vec_b);
  return cudaGetLastError();
}

// One product; splits > 1 runs the split-K partials of gemm_splitk. The
// GELU epilogue is instantiated for the forward's x W^T, the
// GELU-derivative one for the backward's dy W, an addend or a bf16 output
// (kEpiAdd, unsplit) for an input grad dy W.
inline cudaError_t gemm(GemmArgs g, int epi, cudaStream_t stream,
                        int splits = 1) {
  const bool ak = g.sak == 1, bk = g.sbk == 1;
  if ((!ak && g.sam != 1) || (!bk && g.sbn != 1)) return cudaErrorInvalidValue;
  if (g.add || g.c_bf16)
    return epi == kEpiNone && ak && !bk && splits == 1 && !g.accumulate
               ? gemm_launch<true, false, kEpiAdd>(g, splits, stream)
               : cudaErrorInvalidValue;
  if (epi == kEpiGelu)
    return ak && bk ? gemm_launch<true, true, kEpiGelu>(g, splits, stream)
                    : cudaErrorInvalidValue;
  if (epi == kEpiGeluGrad)
    return ak && !bk
               ? gemm_launch<true, false, kEpiGeluGrad>(g, splits, stream)
               : cudaErrorInvalidValue;
  if (ak)
    return bk ? gemm_launch<true, true, kEpiNone>(g, splits, stream)
              : gemm_launch<true, false, kEpiNone>(g, splits, stream);
  return bk ? gemm_launch<false, true, kEpiNone>(g, splits, stream)
            : gemm_launch<false, false, kEpiNone>(g, splits, stream);
}

inline GemmArgs gemm_args(const float* A, long long sam, long long sak,
                          const float* B, long long sbk, long long sbn,
                          float* C, long long ldc, int M, int N, int K) {
  GemmArgs g;
  g.A = A; g.sam = sam; g.sak = sak;
  g.B = B; g.sbk = sbk; g.sbn = sbn;
  g.bias = nullptr;
  g.C = C; g.ldc = ldc;
  g.aux = nullptr; g.ldaux = 0;
  g.M = M; g.N = N; g.K = K;
  g.kchunk = K; g.split_stride = 0;
  g.accumulate = false;
  g.c_bf16 = false;
  g.add = nullptr;
  g.ldadd = 0;
  g.add_bf16 = false;
  return g;
}

// One product without an epilogue where an operand is exact (TA, TB:
// float, uint16_t for bf16 bits, or ExactF32): the forms the bf16
// backwards of kernels A and B run. Two bf16 operands with A K-major (x
// W^T, dy W); an exact A in y = x W^T (an fp32 W) and in dW = dy^T x; an
// exact B in dW = dy^T x and dx = dy W. No +=.
template <typename TA, typename TB>
cudaError_t gemm_exact(const GemmArgs& g, cudaStream_t stream,
                       int splits = 1) {
  static_assert(kExact<TA> || kExact<TB>, "the fp32 product is gemm()");
  const bool ak = g.sak == 1, bk = g.sbk == 1;
  if ((!ak && g.sam != 1) || (!bk && g.sbn != 1) || g.accumulate || g.add)
    return cudaErrorInvalidValue;
  if constexpr (kExact<TA> && kExact<TB>) {
    if (!ak) return cudaErrorInvalidValue;
    return bk ? gemm_launch<true, true, kEpiNone, TA, TB>(g, splits, stream)
              : gemm_launch<true, false, kEpiNone, TA, TB>(g, splits, stream);
  } else if constexpr (kExact<TA>) {
    if (ak && bk)
      return gemm_launch<true, true, kEpiNone, TA, TB>(g, splits, stream);
    return !ak && !bk
               ? gemm_launch<false, false, kEpiNone, TA, TB>(g, splits, stream)
               : cudaErrorInvalidValue;
  } else {
    if (bk) return cudaErrorInvalidValue;
    return ak ? gemm_launch<true, false, kEpiNone, TA, TB>(g, splits, stream)
              : gemm_launch<false, false, kEpiNone, TA, TB>(g, splits, stream);
  }
}

// y = x . W^T (+ b) for a torch nn.Linear weight W [N, K] (row-major);
// with gelu, y = gelu(.) and, if pre is given, the pre-activation too.
inline cudaError_t linear(const float* x, int ldx, const float* W,
                          const float* bias, float* y, int ldy, int M, int N,
                          int K, bool gelu, cudaStream_t stream,
                          float* pre = nullptr, int ldpre = 0) {
  GemmArgs g = gemm_args(x, ldx, 1, W, 1, K, y, ldy, M, N, K);
  g.bias = bias;
  g.aux = pre;
  g.ldaux = ldpre;
  return gemm(g, gelu ? kEpiGelu : kEpiNone, stream);
}

// Product with a long K (a weight gradient over all B*N rows): where the
// output tiles leave the card idle, K is split across blocks (as many
// splits as fit in one wave of two blocks an SM), each split writes its own
// partial [M, N] into the workspace, and an ordered pass sums them into C.
// A split keeps at least 4 K tiles. TA, TB as in gemm_exact; C may be bf16
// (c_bf16), rounded by the ordered pass; no addend.
template <typename TA = float, typename TB = float>
cudaError_t gemm_splitk(GemmArgs g, Workspace ws, cudaStream_t stream) {
  constexpr bool kMixed = kExact<TA> || kExact<TB>;
  if (g.add) return cudaErrorInvalidValue;
  auto run = [&](const GemmArgs& a, int splits) {
    if constexpr (kMixed)
      return gemm_exact<TA, TB>(a, stream, splits);
    else
      return gemm(a, kEpiNone, stream, splits);
  };
  const long long mn = (long long)g.M * g.N;
  const int tiles = ceil_div(g.N, kGemmBN) * ceil_div(g.M, kGemmBM);
  int splits = 1;
  if (tiles < kTargetBlocks) {
    splits = kTargetBlocks / tiles;
    splits = min(splits, ceil_div(g.K, 4 * kGemmBK));
    splits = (int)min((long long)splits, ws.n / (mn > 0 ? mn : 1));
    splits = max(splits, 1);
  }
  if (splits == 1) return run(g, 1);
  const int chunk = ceil_div(ceil_div(g.K, splits), kGemmBK) * kGemmBK;
  splits = ceil_div(g.K, chunk);
  GemmArgs p = g;
  p.C = ws.take(mn * splits);
  p.ldc = g.N;
  p.kchunk = chunk;
  p.split_stride = mn;
  p.accumulate = false;
  p.c_bf16 = false;
  p.bias = nullptr;
  cudaError_t err = run(p, splits);
  if (err != cudaSuccess) return err;
  if (g.c_bf16) {
    splitk_reduce_kernel<__nv_bfloat16>
        <<<ceil_div(mn, 256), 256, 0, stream>>>(p.C, splits, g.M, g.N, g.C,
                                                g.ldc, false);
    return cudaGetLastError();
  }
  splitk_reduce_kernel<float><<<ceil_div(mn, 256), 256, 0, stream>>>(
      p.C, splits, g.M, g.N, g.C, g.ldc, g.accumulate);
  return cudaGetLastError();
}

// dW = dY^T X for y = x W^T: dY [rows, N] (leading dim ldy), X [rows, K]
// (leading dim ldx), dW [N, K] row-major (a torch nn.Linear weight grad;
// leading dim lddw, K where 0: a block of columns of a wider weight).
inline cudaError_t weight_grad(const float* dy, int ldy, const float* x,
                               int ldx, float* dw, int N, int K, int rows,
                               Workspace ws, cudaStream_t stream,
                               int lddw = 0) {
  if (!dw) return cudaSuccess;
  GemmArgs g =
      gemm_args(dy, 1, ldy, x, ldx, 1, dw, lddw ? lddw : K, N, K, rows);
  return gemm_splitk(g, ws, stream);
}

// dx (+)= dy . W for y = x W^T, W [N, K]: dy [rows, N], dx [rows, K].
inline cudaError_t input_grad(const float* dy, int ldy, const float* W,
                              int N, int K, float* dx, int lddx, int rows,
                              bool accumulate, cudaStream_t stream) {
  GemmArgs g = gemm_args(dy, ldy, 1, W, K, 1, dx, lddx, rows, K, N);
  g.accumulate = accumulate;
  return gemm(g, kEpiNone, stream);
}

// ------------------------------------------ products of bf16 operands

// A pointer's element as the GEMM reads it: bf16 as its bits.
template <typename T>
using GemmElem =
    std::conditional_t<std::is_same_v<T, __nv_bfloat16>, uint16_t, T>;

// linear, weight_grad and input_grad where an operand may be exact (T*:
// float, __nv_bfloat16 or ExactF32), each product counting its TF32 terms
// by the operands' exactness (with none exact, the fp32 products above);
// a bf16 OUT is rounded once, where it is finished.
template <typename TX, typename TW>
cudaError_t linear_exact(const TX* x, int ldx, const TW* W,
                         const float* bias, float* y, int ldy, int M, int N,
                         int K, cudaStream_t stream) {
  GemmArgs g = gemm_args(reinterpret_cast<const float*>(x), ldx, 1,
                         reinterpret_cast<const float*>(W), 1, K, y, ldy, M,
                         N, K);
  g.bias = bias;
  if constexpr (kExact<GemmElem<TX>> || kExact<GemmElem<TW>>)
    return gemm_exact<GemmElem<TX>, GemmElem<TW>>(g, stream);
  else
    return gemm(g, kEpiNone, stream);
}

template <typename TY, typename TX, typename OUT>
cudaError_t weight_grad_exact(const TY* dy, int ldy, const TX* x, int ldx,
                              OUT* dw, int N, int K, int rows, Workspace ws,
                              cudaStream_t stream, int lddw = 0) {
  if (!dw) return cudaSuccess;
  GemmArgs g = gemm_args(reinterpret_cast<const float*>(dy), 1, ldy,
                         reinterpret_cast<const float*>(x), ldx, 1,
                         reinterpret_cast<float*>(dw), lddw ? lddw : K, N, K,
                         rows);
  g.c_bf16 = std::is_same_v<OUT, __nv_bfloat16>;
  return gemm_splitk<GemmElem<TY>, GemmElem<TX>>(g, ws, stream);
}

template <typename TY, typename TW, typename OUT>
cudaError_t input_grad_exact(const TY* dy, int ldy, const TW* W, int N,
                             int K, OUT* dx, int lddx, int rows,
                             cudaStream_t stream) {
  GemmArgs g = gemm_args(reinterpret_cast<const float*>(dy), ldy, 1,
                         reinterpret_cast<const float*>(W), K, 1,
                         reinterpret_cast<float*>(dx), lddx, rows, K, N);
  g.c_bf16 = std::is_same_v<OUT, __nv_bfloat16>;
  return gemm_exact<GemmElem<TY>, GemmElem<TW>>(g, stream);
}

}  // namespace
}  // namespace emip
