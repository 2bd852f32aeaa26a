// Shared fp32 building blocks of the port's Hopper kernels on the CUDA
// cores.
//
// Device routines that the kernel entry points compose, each launched on
// the caller's stream and allocating nothing (scratch comes from a
// Workspace the caller's wrapper allocated):
//
//   layernorm       out = (res +) LN(x) * gamma + beta, one warp per row;
//   layernorm_bwd   dx (+)= LN'(x)^T dy, and dy * xhat for the gamma grad;
//   colsum          out[c] (+)= sum_r in[r, c] (bias / LayerNorm grads),
//                   two ordered passes;
//   gelu_exact, gelu_grad
//                   exact GELU and its derivative (the GEMM epilogues of
//                   gemm_tf32.cuh, kernel J);
//   attention       softmax(q k^T * scale (+ mask)) v per (batch, head),
//                   flash-style: q rows tiled, keys streamed through shared
//                   memory with an online max / sum, scores never stored;
//                   where a gradient will be taken it also writes each
//                   row's max and sum, which the tensor-core backward
//                   (attention_bwd_tc of mma_tf32.cuh) reads.
//
// The attention here is the forward of kernels A, B, G and H (head widths
// 32, 64 and 128), the simple first version on the CUDA cores; their
// products (gemm_tf32.cuh) and their attention backward, and kernels C and
// F forward and backward, run on the tensor cores as 3xTF32. The forward
// attention's move there is later work (attention_fwd_tc with heads and a
// mask).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace emip {
// Internal linkage: every .cu entry file includes this header and is its
// own translation unit of the one shared library.
namespace {

constexpr int kSmCount = 132;  // H100 SXM
constexpr int kTargetBlocks = 2 * kSmCount;

// Scratch memory handed down from the wrapper; each routine carves what it
// needs from the front of its own copy.
struct Workspace {
  float* p;
  long long n;
  float* take(long long count) {
    if (count > n) return nullptr;
    float* r = p;
    p += count;
    n -= count;
    return r;
  }
};

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// ------------------------------------------------------------ GELU

__device__ __forceinline__ float gelu_exact(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// d/du of gelu_exact (emip_tpu/ops/pallas/window_attention.py:_gelu_grad)
__device__ __forceinline__ float gelu_grad(float u) {
  const float phi = expf(-0.5f * u * u) * 0.39894228040143268f;
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) + u * phi;
}

// ------------------------------------------------------------- colsum

__global__ void colsum_partial_kernel(const float* __restrict__ in,
                                      long long ld, int rows, int C,
                                      int rows_per_chunk, float* part) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  if (c < C)
    for (int r = r0 + threadIdx.y; r < r1; r += 8) s += in[r * ld + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) t += red[j][threadIdx.x];
    part[(long long)blockIdx.y * C + c] = t;
  }
}

__global__ void colsum_final_kernel(const float* __restrict__ part,
                                    int chunks, int C, float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float t = 0.f;
  for (int j = 0; j < chunks; ++j) t += part[(long long)j * C + c];
  out[c] = t;
}

// out[c] = sum over rows of in[r * ld + c]; nothing to do if out is null.
inline cudaError_t colsum(const float* in, long long ld, int rows, int C,
                          float* out, Workspace ws, cudaStream_t stream) {
  if (!out) return cudaSuccess;
  int chunks = min(256, max(1, ceil_div(rows, 64)));
  chunks = (int)min((long long)chunks, ws.n / C);
  if (chunks < 1) return cudaErrorInvalidValue;
  const int per = ceil_div(rows, chunks);
  chunks = ceil_div(rows, per);
  float* part = ws.take((long long)chunks * C);
  colsum_partial_kernel<<<dim3(ceil_div(C, 32), chunks), dim3(32, 8), 0,
                          stream>>>(in, ld, rows, C, per, part);
  colsum_final_kernel<<<ceil_div(C, 128), 128, 0, stream>>>(part, chunks, C,
                                                            out);
  return cudaGetLastError();
}

// ----------------------------------------------------------- LayerNorm

constexpr int kLnRowsPerBlock = 8;  // one warp per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / C + eps);
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

// y = LN(x) * gamma + beta. With xhat = (x - mu) * inv and g = dy * gamma:
//   dx = inv * (g - mean(g) - xhat * mean(g * xhat))
// and, if prod is given, prod = dy * xhat (its column sum is dgamma).
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
layernorm_bwd_kernel(const float* __restrict__ x, int ldx,
                     const float* __restrict__ dy, int lddy,
                     const float* __restrict__ gamma, float* dx, int lddx,
                     bool accumulate, float* __restrict__ prod, int rows,
                     int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + (long long)row * ldx;
  const float* gr = dy + (long long)row * lddy;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / C + eps);
  float sg = 0.f, sgx = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float g = gr[c] * gamma[c];
    sg += g;
    sgx += g * (xr[c] - mu) * inv;
  }
  const float mg = warp_sum(sg) / C;
  const float mgx = warp_sum(sgx) / C;
  float* dr = dx + (long long)row * lddx;
  float* pr = prod ? prod + (long long)row * C : nullptr;
  for (int c = lane; c < C; c += 32) {
    const float xh = (xr[c] - mu) * inv;
    const float d = inv * (gr[c] * gamma[c] - mg - xh * mgx);
    dr[c] = accumulate ? dr[c] + d : d;
    if (pr) pr[c] = gr[c] * xh;
  }
}

// LayerNorm backward: dx, plus dgamma / dbeta when their pointers are set
// (prod is a [rows, C] scratch taken from the workspace for dgamma).
inline cudaError_t layernorm_bwd(const float* x, int ldx, const float* dy,
                                 int lddy, const float* gamma, float* dx,
                                 int lddx, bool accumulate, float* dgamma,
                                 float* dbeta, int rows, int C, float eps,
                                 Workspace ws, cudaStream_t stream) {
  float* prod = nullptr;
  if (dgamma) {
    prod = ws.take((long long)rows * C);
    if (!prod) return cudaErrorInvalidValue;
  }
  const int blocks = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  layernorm_bwd_kernel<<<blocks, 32 * kLnRowsPerBlock, 0, stream>>>(
      x, ldx, dy, lddy, gamma, dx, lddx, accumulate, prod, rows, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = colsum(prod, C, rows, C, dgamma, ws, stream);
  if (err != cudaSuccess) return err;
  return colsum(dy, lddy, rows, C, dbeta, ws, stream);
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

template <int D, int DV, bool KEEP>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(
    const float* __restrict__ q, long long q_sb, int q_sn,
    const float* __restrict__ k, long long k_sb, int k_sn,
    const float* __restrict__ v, long long v_sb, int v_sn,
    float* __restrict__ out, long long o_sb, int o_sn,
    const float* __restrict__ mask, int mask_nw, int N, int M, float scale,
    float* __restrict__ row_max, float* __restrict__ row_sum) {
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

  if (tid < kAttnBQ) {
    lsum[tid] = l_run;
    // the row's max and sum, at (b * H + h) * N + n, for the backward
    if (KEEP && n0 + tid < N) {
      const long long row = ((long long)b * gridDim.y + h) * N + n0 + tid;
      row_max[row] = m_run;
      row_sum[row] = l_run;
    }
  }
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

template <int D, int DV, bool KEEP>
cudaError_t attention_launch(const float* q, long long q_sb, int q_sn,
                             const float* k, long long k_sb, int k_sn,
                             const float* v, long long v_sb, int v_sn,
                             float* out, long long o_sb, int o_sn,
                             const float* mask, int mask_nw, int B, int H,
                             int N, int M, float scale, float* stats,
                             cudaStream_t stream) {
  const size_t bytes = AttnSmem<D, DV>::kBytes;
  dim3 grid((N + kAttnBQ - 1) / kAttnBQ, H, B);
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<D, DV, KEEP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  attention_kernel<D, DV, KEEP><<<grid, kAttnThreads, bytes, stream>>>(
      q, q_sb, q_sn, k, k_sb, k_sn, v, v_sb, v_sn, out, o_sb, o_sn, mask,
      mask_nw, N, M, scale, stats,
      stats ? stats + (long long)B * H * N : nullptr);
  return cudaGetLastError();
}

// Runtime dispatch on the head widths of kernels A (every PVT stage: 64 in
// pvt_v2_b5, 32 in b0) and B, G, H (the GMFlow windows: 128 in b5's
// configuration, 64 in b0's), with D == DV. stats, if not null, is [2, B,
// H, N]: each row's max, then its sum (a gradient will be taken). The
// flow-valued attention and the memory read have their own kernels
// (attention_fwd_tc / attention_bwd_tc of mma_tf32.cuh).
inline cudaError_t attention(int D, int DV, const float* q, long long q_sb,
                             int q_sn, const float* k, long long k_sb,
                             int k_sn, const float* v, long long v_sb,
                             int v_sn, float* out, long long o_sb, int o_sn,
                             const float* mask, int mask_nw, int B, int H,
                             int N, int M, float scale, float* stats,
                             cudaStream_t stream) {
#define EMIP_ATTN_CASE(d, dv)                                                 \
  if (D == d && DV == dv)                                                     \
    return stats ? attention_launch<d, dv, true>(                             \
                       q, q_sb, q_sn, k, k_sb, k_sn, v, v_sb, v_sn, out,      \
                       o_sb, o_sn, mask, mask_nw, B, H, N, M, scale, stats,   \
                       stream)                                                \
                 : attention_launch<d, dv, false>(                            \
                       q, q_sb, q_sn, k, k_sb, k_sn, v, v_sb, v_sn, out,      \
                       o_sb, o_sn, mask, mask_nw, B, H, N, M, scale, stats,   \
                       stream);
  EMIP_ATTN_CASE(32, 32)
  EMIP_ATTN_CASE(64, 64)
  EMIP_ATTN_CASE(128, 128)
#undef EMIP_ATTN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace emip
