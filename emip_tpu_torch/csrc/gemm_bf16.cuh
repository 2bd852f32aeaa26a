// The bf16 GEMM of kernel A in the bf16 band (beside the 3xTF32 one
// of gemm_tf32.cuh):
//
//   linear_bf16     y[M, N] = x[M, K] W[N, K]^T (+ bias[N]) for a torch
//                   nn.Linear weight W, x and W bf16 and row-major (k
//                   contiguous in both). The products run as
//                   mma.sync.m16n8k16 bf16 with fp32 accumulators; the
//                   epilogue adds the fp32 bias to the fp32 sum and then
//                   rounds to bf16 once, or writes the fp32 sum where the
//                   caller rounds later, as the JAX kernels'
//                   dot(..., preferred_element_type=float32) + bias,
//                   .astype(dtype).
//
// What bounds it: the products, 2 M N K operations, at the bf16 tensor-core
// rate. A block of 8 warps owns a 128 x 128 output tile (a warp 32 x 64: two
// 16-row fragments by eight 8-column ones), K streams in tiles of 32 through
// a ring of three cp.async stages with one barrier per tile, and the
// fragments are read from shared memory with ldmatrix. Rows are padded to
// 40 bf16 (80 bytes): the eight rows of an 8 x 8 matrix then fall on
// different banks. Ragged M and N tiles are zero-filled by the copies; K,
// the leading dimensions and the column offsets are multiples of 8 (16-byte
// copies), which every width of the model is.

#pragma once

#include "bf16.cuh"

namespace emip {
namespace {

constexpr int kBgBM = 128;
constexpr int kBgBN = 128;
constexpr int kBgBK = 32;
constexpr int kBgThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kBgStages = 3;
constexpr int kBgLd = kBgBK + 8;  // bf16 per shared row
constexpr int kBgStage = (kBgBM + kBgBN) * kBgLd;
constexpr size_t kBgBytes = sizeof(bf16) * kBgStages * kBgStage;

struct GemmBf16Args {
  const bf16* A;  // [M, K], row stride lda
  long long lda;
  const bf16* W;  // [N, K], row stride ldw
  long long ldw;
  const float* bias;  // [N] or null
  void* C;            // [M, N], row stride ldc: bf16 or fp32
  long long ldc;
  int M, N, K;
};

template <bool OUT_BF16>
__global__ void __launch_bounds__(kBgThreads, 2)
gemm_bf16_kernel(GemmBf16Args g) {
  extern __shared__ __align__(16) unsigned char gb_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(gb_smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const int wr = 32 * (warp % 4);  // the warp's first row in the tile
  const int wc = 64 * (warp / 4);  // and its first column
  const int row0 = blockIdx.y * kBgBM, col0 = blockIdx.x * kBgBN;
  const int tiles = (g.K + kBgBK - 1) / kBgBK;

  // one commit per call, empty past the last tile
  auto fill = [&](int tile) {
    if (tile < tiles) {
      bf16* as = smem + (tile % kBgStages) * kBgStage;
      bf16* bs = as + kBgBM * kBgLd;
      const int k0 = tile * kBgBK;
#pragma unroll
      for (int e = tid; e < kBgBM * (kBgBK / 8); e += kBgThreads) {
        const int r = e / (kBgBK / 8), c = (e % (kBgBK / 8)) * 8;
        const bool ok = row0 + r < g.M && k0 + c < g.K;
        cp_async<16>(as + r * kBgLd + c,
                         ok ? g.A + (long long)(row0 + r) * g.lda + k0 + c
                            : g.A,
                         ok);
      }
#pragma unroll
      for (int e = tid; e < kBgBN * (kBgBK / 8); e += kBgThreads) {
        const int r = e / (kBgBK / 8), c = (e % (kBgBK / 8)) * 8;
        const int n = col0 + r;
        const bool ok = n < g.N && k0 + c < g.K;
        cp_async<16>(bs + r * kBgLd + c,
                     ok ? g.W + (long long)n * g.ldw + k0 + c : g.W, ok);
      }
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kBgStages - 1; ++s) fill(s);
  for (int tile = 0; tile < tiles; ++tile) {
    // this tile has landed, and every warp is done with the one before,
    // whose stage the copy of tile + 2 may now overwrite
    cp_async_wait<kBgStages - 2>();
    __syncthreads();
    fill(tile + kBgStages - 1);
    const bf16* as = smem + (tile % kBgStages) * kBgStage;
    const bf16* bs = as + kBgBM * kBgLd;
#pragma unroll
    for (int kk = 0; kk < kBgBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldmatrix_x4(a[m], as + (wr + 16 * m + lane % 16) * kBgLd + kk +
                              (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, bs + (wc + 16 * n2 + lane % 8 + (lane / 16) * 8) *
                                kBgLd +
                            kk + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][2 * n2], a[m], b[0], b[1]);
          mma_bf16(acc[m][2 * n2 + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // lane (gr, t) holds rows gr, gr + 8 and columns 2t, 2t + 1 of each
  // fragment; N is even, so a pair is in range or not as a whole
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wr + 16 * m + gr + 8 * h;
      if (r >= g.M) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = col0 + wc + 8 * n + 2 * t;
        if (col >= g.N) continue;
        float v0 = acc[m][n][2 * h], v1 = acc[m][n][2 * h + 1];
        if (g.bias) {
          v0 += g.bias[col];
          v1 += g.bias[col + 1];
        }
        const long long at = (long long)r * g.ldc + col;
        if constexpr (OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.C) + at) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(g.C) + at) =
              make_float2(v0, v1);
      }
    }
}

template <bool OUT_BF16>
cudaError_t gemm_bf16_launch(const GemmBf16Args& g, cudaStream_t stream) {
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel<OUT_BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBgBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ceil_div(g.N, kBgBN), ceil_div(g.M, kBgBM));
  gemm_bf16_kernel<OUT_BF16><<<grid, kBgThreads, kBgBytes, stream>>>(g);
  return cudaGetLastError();
}

// y [M, N] (row stride ldy) = x [M, K] (row stride ldx) . W^T (+ bias) for W
// [N, K] (row stride ldw); y bf16 when out_bf16, else fp32. K, ldx, ldw and
// the operands' offsets must be multiples of 8 bf16 (16-byte copies), N and
// ldy even.
inline cudaError_t linear_bf16(const bf16* x, long long ldx, const bf16* W,
                               long long ldw, const float* bias, void* y,
                               long long ldy, int M, int N, int K,
                               bool out_bf16, cudaStream_t stream) {
  if (K % 8 || ldx % 8 || ldw % 8 || N % 2 || ldy % 2 ||
      !aligned16_ptr(x) || !aligned16_ptr(W))
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  GemmBf16Args g;
  g.A = x; g.lda = ldx;
  g.W = W; g.ldw = ldw;
  g.bias = bias;
  g.C = y; g.ldc = ldy;
  g.M = M; g.N = N; g.K = K;
  return out_bf16 ? gemm_bf16_launch<true>(g, stream)
                  : gemm_bf16_launch<false>(g, stream);
}

}  // namespace
}  // namespace emip
