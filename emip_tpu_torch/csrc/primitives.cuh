// Shared fp32 building blocks of the port's Hopper kernels.
//
// Three device routines that the kernel entry points (sr_attention.cu,
// window_attention.cu, flow_attention.cu) compose, each launched on the
// caller's stream and allocating nothing:
//
//   gemm          C[M,N] = A[M,K] . B[K,N] (+ bias[N]) (then exact GELU),
//                 with B addressed through two strides so a torch
//                 nn.Linear weight [N,K] is read in place as B = W^T;
//   layernorm     out = (res +) LN(x) * gamma + beta, one warp per row;
//   attention     softmax(q k^T * scale (+ mask)) v per (batch, head),
//                 flash-style: q rows tiled, keys streamed through shared
//                 memory with an online max / sum, scores never stored.
//
// Everything is fp32 on the CUDA cores: this is the simple, correct first
// version. Tensor cores (wgmma), TMA and bf16 are later work.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace emip {
// Internal linkage: every .cu entry file includes this header and is its
// own translation unit of the one shared library.
namespace {

// ---------------------------------------------------------------- GEMM

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 16;
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float gelu_exact(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// A row-major with leading dimension lda; B(k, n) at B[k * sbk + n * sbn];
// C row-major with leading dimension ldc.
template <bool kGelu>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, int lda,
            const float* __restrict__ B, long long sbk, long long sbn,
            const float* __restrict__ bias, float* __restrict__ C, int ldc,
            int M, int N, int K) {
  __shared__ float As[kGemmBK][kGemmBM + 4];
  __shared__ float Bs[kGemmBK][kGemmBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kGemmBM, col0 = blockIdx.x * kGemmBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    // A tile: consecutive threads walk k (contiguous in memory)
    for (int i = tid; i < kGemmBM * kGemmBK; i += kGemmThreads) {
      const int r = i / kGemmBK, kk = i % kGemmBK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? A[(long long)gr * lda + gk] : 0.f;
    }
    // B tile: walk whichever index is contiguous
    for (int i = tid; i < kGemmBK * kGemmBN; i += kGemmThreads) {
      int kk, c;
      if (sbk == 1) { kk = i % kGemmBK; c = i / kGemmBK; }
      else          { c = i % kGemmBN;  kk = i / kGemmBN; }
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? B[gk * sbk + gc * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[c];
      if (kGelu) v = gelu_exact(v);
      C[(long long)r * ldc + c] = v;
    }
  }
}

inline void gemm(const float* A, int lda, const float* B, long long sbk,
                 long long sbn, const float* bias, float* C, int ldc, int M,
                 int N, int K, bool gelu, cudaStream_t stream) {
  dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  if (gelu)
    gemm_kernel<true><<<grid, kGemmThreads, 0, stream>>>(
        A, lda, B, sbk, sbn, bias, C, ldc, M, N, K);
  else
    gemm_kernel<false><<<grid, kGemmThreads, 0, stream>>>(
        A, lda, B, sbk, sbn, bias, C, ldc, M, N, K);
}

// y = x . W^T + b for a torch nn.Linear weight W [N, K] (row-major).
inline void linear(const float* x, int ldx, const float* W,
                   const float* bias, float* y, int ldy, int M, int N, int K,
                   bool gelu, cudaStream_t stream) {
  gemm(x, ldx, W, 1, K, bias, y, ldy, M, N, K, gelu, stream);
}

// ----------------------------------------------------------- LayerNorm

constexpr int kLnRowsPerBlock = 8;  // one warp per row

__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
layernorm_kernel(const float* __restrict__ x, int ldx,
                 const float* __restrict__ res, int ldr,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ out,
                 int ldo, int rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + (long long)row * ldx;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    v += d * d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float inv = rsqrtf(v / C + eps);
  float* orow = out + (long long)row * ldo;
  const float* rrow = res ? res + (long long)row * ldr : nullptr;
  for (int c = lane; c < C; c += 32) {
    float y = (xr[c] - mu) * inv * gamma[c] + beta[c];
    if (rrow) y += rrow[c];
    orow[c] = y;
  }
}

inline void layernorm(const float* x, int ldx, const float* res, int ldr,
                      const float* gamma, const float* beta, float* out,
                      int ldo, int rows, int C, float eps,
                      cudaStream_t stream) {
  const int blocks = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  layernorm_kernel<<<blocks, 32 * kLnRowsPerBlock, 0, stream>>>(
      x, ldx, res, ldr, gamma, beta, out, ldo, rows, C, eps);
}

// ----------------------------------------------------------- attention
//
// One block of 128 threads owns kAttnBQ query rows of one (batch, head)
// and streams the keys in tiles of kAttnBK through shared memory:
//   S = Q_tile K_tile^T * scale (+ mask)        [BQ, BK] in shared memory
//   m' = max(m, rowmax S); P = exp(S - m'); l = l e^{m-m'} + rowsum P
//   O = O e^{m-m'} + P V_tile                   [BQ, DV] in registers
// Element (b, h, n, d) of q is q[b*q_sb + n*q_sn + h*D + d]; v and out
// use h*DV. The additive mask, if given, is [mask_nw, N, M] and batch b
// reads window b % mask_nw (the [B, K*K, T, C] window layout).

constexpr int kAttnBQ = 32;
constexpr int kAttnBK = 32;
constexpr int kAttnThreads = 128;

template <int D, int DV>
struct AttnSmem {
  static constexpr int kQ = kAttnBQ * (D + 1);
  static constexpr int kK = kAttnBK * (D + 1);
  static constexpr int kV = kAttnBK * DV;
  static constexpr int kS = kAttnBQ * (kAttnBK + 1);
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kK + kV + kS + 2 * kAttnBQ);
};

template <int D, int DV>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ q, long long q_sb, int q_sn,
                 const float* __restrict__ k, long long k_sb, int k_sn,
                 const float* __restrict__ v, long long v_sb, int v_sn,
                 float* __restrict__ out, long long o_sb, int o_sn,
                 const float* __restrict__ mask, int mask_nw, int N, int M,
                 float scale) {
  extern __shared__ float smem[];
  using L = AttnSmem<D, DV>;
  float* Qs = smem;                 // [BQ][D+1]
  float* Ks = Qs + L::kQ;           // [BK][D+1]
  float* Vs = Ks + L::kK;           // [BK][DV]
  float* Ss = Vs + L::kV;           // [BQ][BK+1]
  float* alpha = Ss + L::kS;        // [BQ] rescale of the running sums
  float* lsum = alpha + kAttnBQ;    // [BQ] final softmax denominators

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kAttnBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  q += b * q_sb + (long long)h * D;
  k += b * k_sb + (long long)h * D;
  v += b * v_sb + (long long)h * DV;
  out += b * o_sb + (long long)h * DV;
  const float* mk =
      mask ? mask + (long long)(b % mask_nw) * N * M : nullptr;

  for (int i = tid; i < kAttnBQ * D; i += kAttnThreads) {
    const int r = i / D, d = i % D;
    const int n = n0 + r;
    Qs[r * (D + 1) + d] = n < N ? q[(long long)n * q_sn + d] : 0.f;
  }

  // score ownership: row sr, keys sc + 4*j (j < 8)
  const int sr = tid / 4, sc = tid % 4;
  // output ownership: entries e = tid + 128*i of the [BQ, DV] tile
  constexpr int kPer = (kAttnBQ * DV + kAttnThreads - 1) / kAttnThreads;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // used by threads tid < BQ

  for (int m0 = 0; m0 < M; m0 += kAttnBK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kAttnBK * D; i += kAttnThreads) {
      const int r = i / D, d = i % D;
      const int m = m0 + r;
      Ks[r * (D + 1) + d] = m < M ? k[(long long)m * k_sn + d] : 0.f;
    }
    for (int i = tid; i < kAttnBK * DV; i += kAttnThreads) {
      const int r = i / DV, d = i % DV;
      const int m = m0 + r;
      Vs[r * DV + d] = m < M ? v[(long long)m * v_sn + d] : 0.f;
    }
    __syncthreads();

    float s[kAttnBK / 4];
#pragma unroll
    for (int j = 0; j < kAttnBK / 4; ++j) s[j] = 0.f;
    const float* qrow = Qs + sr * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kAttnBK / 4; ++j)
        s[j] = fmaf(qd, Ks[(sc + 4 * j) * (D + 1) + d], s[j]);
    }
    const int n = n0 + sr;
#pragma unroll
    for (int j = 0; j < kAttnBK / 4; ++j) {
      const int c = sc + 4 * j;
      const int m = m0 + c;
      float val = -INFINITY;
      if (m < M) {
        val = s[j] * scale;
        if (mk && n < N) val += mk[(long long)n * M + m];
      }
      Ss[sr * (kAttnBK + 1) + c] = val;
    }
    __syncthreads();

    if (tid < kAttnBQ) {
      float* srow = Ss + tid * (kAttnBK + 1);
      float mx = m_run;
#pragma unroll 8
      for (int c = 0; c < kAttnBK; ++c) mx = fmaxf(mx, srow[c]);
      float sum = 0.f;
#pragma unroll 8
      for (int c = 0; c < kAttnBK; ++c) {
        const float p = __expf(srow[c] - mx);
        srow[c] = p;
        sum += p;
      }
      const float a = __expf(m_run - mx);
      l_run = l_run * a + sum;
      m_run = mx;
      alpha[tid] = a;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kAttnThreads * i;
      if (e < kAttnBQ * DV) {
        const int r = e / DV, c = e % DV;
        const float* prow = Ss + r * (kAttnBK + 1);
        float o = acc[i] * alpha[r];
#pragma unroll 8
        for (int j = 0; j < kAttnBK; ++j) o = fmaf(prow[j], Vs[j * DV + c], o);
        acc[i] = o;
      }
    }
  }

  if (tid < kAttnBQ) lsum[tid] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + kAttnThreads * i;
    if (e < kAttnBQ * DV) {
      const int r = e / DV, c = e % DV;
      const int n = n0 + r;
      if (n < N) out[(long long)n * o_sn + c] = acc[i] / lsum[r];
    }
  }
}

template <int D, int DV>
cudaError_t attention_launch(const float* q, long long q_sb, int q_sn,
                             const float* k, long long k_sb, int k_sn,
                             const float* v, long long v_sb, int v_sn,
                             float* out, long long o_sb, int o_sn,
                             const float* mask, int mask_nw, int B, int H,
                             int N, int M, float scale, cudaStream_t stream) {
  const size_t bytes = AttnSmem<D, DV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kAttnBQ - 1) / kAttnBQ, H, B);
  attention_kernel<D, DV><<<grid, kAttnThreads, bytes, stream>>>(
      q, q_sb, q_sn, k, k_sb, k_sn, v, v_sb, v_sn, out, o_sb, o_sn, mask,
      mask_nw, N, M, scale);
  return cudaGetLastError();
}

// Runtime dispatch on the head widths of the pvt_v2_b5 path: D == DV == 64
// (every PVT stage), D == DV == 128 (the GMFlow windows), and DV == 2 for
// the flow-valued attention over 128-d features.
inline cudaError_t attention(int D, int DV, const float* q, long long q_sb,
                             int q_sn, const float* k, long long k_sb,
                             int k_sn, const float* v, long long v_sb,
                             int v_sn, float* out, long long o_sb, int o_sn,
                             const float* mask, int mask_nw, int B, int H,
                             int N, int M, float scale, cudaStream_t stream) {
#define EMIP_ATTN_CASE(d, dv)                                                \
  if (D == d && DV == dv)                                                    \
    return attention_launch<d, dv>(q, q_sb, q_sn, k, k_sb, k_sn, v, v_sb,    \
                                   v_sn, out, o_sb, o_sn, mask, mask_nw, B,  \
                                   H, N, M, scale, stream);
  EMIP_ATTN_CASE(64, 64)
  EMIP_ATTN_CASE(128, 128)
  EMIP_ATTN_CASE(128, 2)
#undef EMIP_ATTN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace emip
