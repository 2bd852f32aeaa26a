// Shared fp32 building blocks of the port's Hopper kernels.
//
// Device routines that the kernel entry points (sr_attention.cu,
// window_attention.cu, flow_attention.cu) compose, each launched on the
// caller's stream and allocating nothing (scratch comes from a Workspace
// the caller's wrapper allocated):
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
//   layernorm       out = (res +) LN(x) * gamma + beta, one warp per row;
//   layernorm_bwd   dx (+)= LN'(x)^T dy, and dy * xhat for the gamma grad;
//   colsum          out[c] (+)= sum_r in[r, c] (bias / LayerNorm grads),
//                   two ordered passes;
//   attention       softmax(q k^T * scale (+ mask)) v per (batch, head),
//                   flash-style: q rows tiled, keys streamed through shared
//                   memory with an online max / sum, scores never stored;
//   attention_bwd   dq, dk, dv of the same, flash-style: a query-tiled pass
//                   recomputes each row's log-sum-exp and writes dq, then a
//                   key-tiled pass recomputes P = exp(S - lse) and
//                   dS = P (dP - rowsum(dO o O)) and accumulates dk, dv;
//                   when there are too few key tiles to fill the card the
//                   queries are split across blocks and the partial dk, dv
//                   are summed in an ordered third pass.
//
// Everything in this header is fp32 on the CUDA cores: the simple, correct
// first version, which kernels A, B, G and H still run (their attention at
// head widths 32, 64 and 128). The flow-valued attention (kernel C) and the
// memory read (kernel F) have left it, forward and backward, for the tensor
// cores (mma_tf32.cuh: 3xTF32 products, cp.async staging); wgmma, TMA and
// bf16 are later work.

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

// ---------------------------------------------------------------- GEMM

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 16;
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

enum { kEpiNone = 0, kEpiGelu = 1, kEpiGeluGrad = 2 };

__device__ __forceinline__ float gelu_exact(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// d/du of gelu_exact (emip_tpu/ops/pallas/window_attention.py:_gelu_grad)
__device__ __forceinline__ float gelu_grad(float u) {
  const float phi = expf(-0.5f * u * u) * 0.39894228040143268f;
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) + u * phi;
}

// A(m, k) at A[m * sam + k * sak]; B(k, n) at B[k * sbk + n * sbn];
// C(m, n) at C[m * ldc + n] (+ blockIdx.z * split_stride for split-K
// partials). aux(m, n) at aux[m * ldaux + n]: the pre-activation written by
// the GELU epilogue or read by the GELU-derivative epilogue.
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
};

template <int kEpi>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  __shared__ float As[kGemmBK][kGemmBM + 4];
  __shared__ float Bs[kGemmBK][kGemmBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kGemmBM, col0 = blockIdx.x * kGemmBN;
  const int kbeg = blockIdx.z * g.kchunk;
  const int kend = min(g.K, kbeg + g.kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kGemmBK) {
    // A tile: walk whichever index is contiguous in memory
    for (int i = tid; i < kGemmBM * kGemmBK; i += kGemmThreads) {
      int r, kk;
      if (g.sak == 1) { r = i / kGemmBK; kk = i % kGemmBK; }
      else            { kk = i / kGemmBM; r = i % kGemmBM; }
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < g.M && gk < kend)
                      ? g.A[(long long)gr * g.sam + (long long)gk * g.sak]
                      : 0.f;
    }
    for (int i = tid; i < kGemmBK * kGemmBN; i += kGemmThreads) {
      int kk, c;
      if (g.sbk == 1) { kk = i % kGemmBK; c = i / kGemmBK; }
      else            { c = i % kGemmBN;  kk = i / kGemmBN; }
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < kend && gc < g.N)
                      ? g.B[(long long)gk * g.sbk + (long long)gc * g.sbn]
                      : 0.f;
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

  float* C = g.C + (long long)blockIdx.z * g.split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= g.N) continue;
      float v = acc[i][j];
      if (g.bias) v += g.bias[c];
      if (kEpi == kEpiGelu) {
        if (g.aux) g.aux[(long long)r * g.ldaux + c] = v;
        v = gelu_exact(v);
      } else if (kEpi == kEpiGeluGrad) {
        v *= gelu_grad(g.aux[(long long)r * g.ldaux + c]);
      }
      float* dst = C + (long long)r * g.ldc + c;
      *dst = g.accumulate ? *dst + v : v;
    }
  }
}

// C[r, c] (+)= sum over z of part[z][r, c], z in order.
__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     int splits, int M, int N, float* C,
                                     long long ldc, bool accumulate) {
  const long long mn = (long long)M * N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + idx];
  float* dst = C + (idx / N) * ldc + idx % N;
  *dst = accumulate ? *dst + s : s;
}

// One product; splits > 1 runs the split-K partials of gemm_splitk.
inline cudaError_t gemm(GemmArgs g, int epi, cudaStream_t stream,
                        int splits = 1) {
  dim3 grid(ceil_div(g.N, kGemmBN), ceil_div(g.M, kGemmBM), splits);
  if (epi == kEpiGelu)
    gemm_kernel<kEpiGelu><<<grid, kGemmThreads, 0, stream>>>(g);
  else if (epi == kEpiGeluGrad)
    gemm_kernel<kEpiGeluGrad><<<grid, kGemmThreads, 0, stream>>>(g);
  else
    gemm_kernel<kEpiNone><<<grid, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
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
  return g;
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

// Product with a long K (a weight gradient over all B*N rows): K is split
// across enough blocks to fill the card, each split writes its own partial
// [M, N] into the workspace, and an ordered pass sums them into C.
inline cudaError_t gemm_splitk(GemmArgs g, Workspace ws, cudaStream_t stream) {
  const long long mn = (long long)g.M * g.N;
  const int tiles = ceil_div(g.N, kGemmBN) * ceil_div(g.M, kGemmBM);
  int splits = 1;
  if (tiles < kTargetBlocks) {
    splits = ceil_div(kTargetBlocks, tiles);
    splits = min(splits, ceil_div(g.K, 4 * kGemmBK));
    splits = (int)min((long long)splits, ws.n / (mn > 0 ? mn : 1));
    splits = max(splits, 1);
  }
  if (splits == 1) return gemm(g, kEpiNone, stream);
  const int chunk = ceil_div(ceil_div(g.K, splits), kGemmBK) * kGemmBK;
  splits = ceil_div(g.K, chunk);
  GemmArgs p = g;
  p.C = ws.take(mn * splits);
  p.ldc = g.N;
  p.kchunk = chunk;
  p.split_stride = mn;
  p.accumulate = false;
  p.bias = nullptr;
  cudaError_t err = gemm(p, kEpiNone, stream, splits);
  if (err != cudaSuccess) return err;
  splitk_reduce_kernel<<<ceil_div(mn, 256), 256, 0, stream>>>(
      p.C, splits, g.M, g.N, g.C, g.ldc, g.accumulate);
  return cudaGetLastError();
}

// dW = dY^T X for y = x W^T: dY [rows, N] (leading dim ldy), X [rows, K]
// (leading dim ldx), dW [N, K] row-major (a torch nn.Linear weight grad).
inline cudaError_t weight_grad(const float* dy, int ldy, const float* x,
                               int ldx, float* dw, int N, int K, int rows,
                               Workspace ws, cudaStream_t stream) {
  if (!dw) return cudaSuccess;
  GemmArgs g = gemm_args(dy, 1, ldy, x, ldx, 1, dw, K, N, K, rows);
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

template <int D, int DV>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(
    const float* __restrict__ q, long long q_sb, int q_sn,
    const float* __restrict__ k, long long k_sb, int k_sn,
    const float* __restrict__ v, long long v_sb, int v_sn,
    float* __restrict__ out, long long o_sb, int o_sn,
    const float* __restrict__ mask, int mask_nw, int N, int M, float scale) {
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
  dim3 grid((N + kAttnBQ - 1) / kAttnBQ, H, B);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  attention_kernel<D, DV><<<grid, kAttnThreads, bytes, stream>>>(
      q, q_sb, q_sn, k, k_sb, k_sn, v, v_sb, v_sn, out, o_sb, o_sn, mask,
      mask_nw, N, M, scale);
  return cudaGetLastError();
}

// Runtime dispatch on the head widths of kernels A (every PVT stage: 64 in
// pvt_v2_b5, 32 in b0) and B, G, H (the GMFlow windows: 128 in b5's
// configuration, 64 in b0's), with D == DV. The flow-valued attention has
// its own kernels (attention_fwd_tc / attention_bwd_tc of mma_tf32.cuh).
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
  EMIP_ATTN_CASE(32, 32)
  EMIP_ATTN_CASE(64, 64)
  EMIP_ATTN_CASE(128, 128)
#undef EMIP_ATTN_CASE
  return cudaErrorInvalidValue;
}

// -------------------------------------------------- attention backward
//
// Operand (b, h, n, :) of tensor X lives at X.p[b*X.sb + n*X.sn + h*width].
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

template <int D, int DV>
struct AttnBwdSmem {
  static constexpr int kQ = kAttnBQ * (D + 1);
  static constexpr int kG = kAttnBQ * (DV + 1);
  static constexpr int kK = kAttnBK * (D + 1);
  static constexpr int kV = kAttnBK * (DV + 1);
  static constexpr int kS = kAttnBQ * (kAttnBK + 1);
  // query-tiled pass: Q, dO, K, V, dS
  static constexpr size_t kDqBytes = sizeof(float) * (kQ + kG + kK + kV + kS);
  // key-tiled pass: Q, dO, K, V, P, dS, lse, delta
  static constexpr size_t kDkvBytes =
      sizeof(float) * (kQ + kG + kK + kV + 2 * kS + 2 * kAttnBQ);
};

// Scores of one (query row sr, 8 keys sc + 4j) against a K tile in smem.
template <int D>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks,
                                            int sr, int sc, float* s) {
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
}

template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int sn, int r0, int rows_total,
                                          int tile_rows, int tid) {
  for (int i = tid; i < tile_rows * W; i += kAttnThreads) {
    const int r = i / W, d = i % W;
    const int n = r0 + r;
    dst[r * (W + 1) + d] = n < rows_total ? src[(long long)n * sn + d] : 0.f;
  }
}

// Query-tiled pass: per row, delta = dO . O and lse (recomputed from q, k);
// dq = scale * sum_j dS_ij k_j with dS = P (dO v^T - delta).
template <int D, int DV>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_dq_kernel(AttnOperand q, AttnOperand k, AttnOperand v,
                        AttnOperand o, AttnOperand go, AttnGrad dq,
                        const float* __restrict__ mask, int mask_nw, int N,
                        int M, float scale, float* __restrict__ lse_out,
                        float* __restrict__ delta_out) {
  extern __shared__ float smem[];
  using L = AttnBwdSmem<D, DV>;
  float* Qs = smem;        // [BQ][D+1]
  float* Gs = Qs + L::kQ;  // [BQ][DV+1]
  float* Ks = Gs + L::kG;  // [BK][D+1]
  float* Vs = Ks + L::kK;  // [BK][DV+1]
  float* Ss = Vs + L::kV;  // [BQ][BK+1] dS

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kAttnBQ;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const float* qp = q.p + b * q.sb + (long long)h * D;
  const float* kp = k.p + b * k.sb + (long long)h * D;
  const float* vp = v.p + b * v.sb + (long long)h * DV;
  const float* op = o.p + b * o.sb + (long long)h * DV;
  const float* gp = go.p + b * go.sb + (long long)h * DV;
  const float* mk =
      mask ? mask + (long long)(b % mask_nw) * N * M : nullptr;

  load_rows<D>(Qs, qp, q.sn, n0, N, kAttnBQ, tid);
  load_rows<DV>(Gs, gp, go.sn, n0, N, kAttnBQ, tid);

  const int sr = tid / 4, sc = tid % 4;
  const int n = n0 + sr;
  // delta = dO . O for row sr, the 4 threads of the row split the columns
  float dl = 0.f;
  if (n < N)
    for (int c = sc; c < DV; c += 4)
      dl += gp[(long long)n * go.sn + c] * op[(long long)n * o.sn + c];
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);

  // pass 1: running max and sum of the row, kept by all 4 of its threads
  float m_run = -INFINITY, l_run = 0.f;
  float s[kAttnBK / 4];
  for (int m0 = 0; m0 < M; m0 += kAttnBK) {
    __syncthreads();
    load_rows<D>(Ks, kp, k.sn, m0, M, kAttnBK, tid);
    __syncthreads();
    tile_scores<D>(Qs, Ks, sr, sc, s);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kAttnBK / 4; ++j) {
      const int m = m0 + sc + 4 * j;
      float val = -INFINITY;
      if (m < M) {
        val = s[j] * scale;
        if (mk && n < N) val += mk[(long long)n * M + m];
      }
      s[j] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kAttnBK / 4; ++j) sum += __expf(s[j] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * __expf(m_run - m_new) + sum;
    m_run = m_new;
  }
  const float lse = m_run + logf(l_run);

  // pass 2: dS and dq
  constexpr int kPer = kAttnBQ * D / kAttnThreads;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int m0 = 0; m0 < M; m0 += kAttnBK) {
    __syncthreads();
    load_rows<D>(Ks, kp, k.sn, m0, M, kAttnBK, tid);
    load_rows<DV>(Vs, vp, v.sn, m0, M, kAttnBK, tid);
    __syncthreads();
    tile_scores<D>(Qs, Ks, sr, sc, s);
#pragma unroll
    for (int j = 0; j < kAttnBK / 4; ++j) {
      const int c = sc + 4 * j;
      const int m = m0 + c;
      float ds = 0.f;
      if (m < M && n < N) {
        float val = s[j] * scale;
        if (mk) val += mk[(long long)n * M + m];
        const float p = __expf(val - lse);
        float dp = 0.f;
#pragma unroll 4
        for (int e = 0; e < DV; ++e)
          dp = fmaf(Gs[sr * (DV + 1) + e], Vs[c * (DV + 1) + e], dp);
        ds = p * (dp - dl);
      }
      Ss[sr * (kAttnBK + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kAttnThreads * i;
      const int r = e / D, d = e % D;
      const float* srow = Ss + r * (kAttnBK + 1);
      float a = acc[i];
#pragma unroll 8
      for (int j = 0; j < kAttnBK; ++j)
        a = fmaf(srow[j], Ks[j * (D + 1) + d], a);
      acc[i] = a;
    }
  }

  if (dq.p) {
    float* dqp = dq.p + b * dq.sb + (long long)h * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kAttnThreads * i;
      const int r = e / D, d = e % D;
      if (n0 + r < N) dqp[(long long)(n0 + r) * dq.sn + d] = acc[i] * scale;
    }
  }
  if (sc == 0 && n < N) {
    const long long row = ((long long)b * H + h) * N + n;
    lse_out[row] = lse;
    delta_out[row] = dl;
  }
}

// Key-tiled pass over the query tiles of one split:
//   dv_j += sum_i P_ij dO_i,   dk_j += scale * sum_i dS_ij q_i.
// With splits > 1 each split writes its partial [B, M, H*D] / [B, M, H*DV]
// into part_k / part_v at offset split * B * M * H * width.
template <int D, int DV>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_dkdv_kernel(AttnOperand q, AttnOperand k, AttnOperand v,
                          AttnOperand go, AttnGrad dk, AttnGrad dv,
                          const float* __restrict__ mask, int mask_nw, int N,
                          int M, float scale,
                          const float* __restrict__ lse_in,
                          const float* __restrict__ delta_in, int splits,
                          float* __restrict__ part_k,
                          float* __restrict__ part_v, int B) {
  extern __shared__ float smem[];
  using L = AttnBwdSmem<D, DV>;
  float* Qs = smem;        // [BQ][D+1]
  float* Gs = Qs + L::kQ;  // [BQ][DV+1]
  float* Ks = Gs + L::kG;  // [BK][D+1]
  float* Vs = Ks + L::kK;  // [BK][DV+1]
  float* Ps = Vs + L::kV;  // [BQ][BK+1]
  float* Ds = Ps + L::kS;  // [BQ][BK+1]
  float* lse_s = Ds + L::kS;       // [BQ]
  float* dl_s = lse_s + kAttnBQ;   // [BQ]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kAttnBK;
  const int h = blockIdx.y, H = gridDim.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const float* qp = q.p + b * q.sb + (long long)h * D;
  const float* kp = k.p + b * k.sb + (long long)h * D;
  const float* vp = v.p + b * v.sb + (long long)h * DV;
  const float* gp = go.p + b * go.sb + (long long)h * DV;
  const float* mk =
      mask ? mask + (long long)(b % mask_nw) * N * M : nullptr;
  const float* lse_b = lse_in + ((long long)b * H + h) * N;
  const float* dl_b = delta_in + ((long long)b * H + h) * N;

  load_rows<D>(Ks, kp, k.sn, m0, M, kAttnBK, tid);
  load_rows<DV>(Vs, vp, v.sn, m0, M, kAttnBK, tid);

  constexpr int kPerK = kAttnBK * D / kAttnThreads;
  constexpr int kPerV = (kAttnBK * DV + kAttnThreads - 1) / kAttnThreads;
  float acc_k[kPerK], acc_v[kPerV];
#pragma unroll
  for (int i = 0; i < kPerK; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kPerV; ++i) acc_v[i] = 0.f;

  const int sr = tid / 4, sc = tid % 4;
  const int tiles = (N + kAttnBQ - 1) / kAttnBQ;
  const int per = (tiles + splits - 1) / splits;
  const int t_end = min(tiles, (split + 1) * per);
  float s[kAttnBK / 4];
  for (int t = split * per; t < t_end; ++t) {
    const int n0 = t * kAttnBQ;
    __syncthreads();
    load_rows<D>(Qs, qp, q.sn, n0, N, kAttnBQ, tid);
    load_rows<DV>(Gs, gp, go.sn, n0, N, kAttnBQ, tid);
    if (tid < kAttnBQ) {
      const int n = n0 + tid;
      lse_s[tid] = n < N ? lse_b[n] : INFINITY;
      dl_s[tid] = n < N ? dl_b[n] : 0.f;
    }
    __syncthreads();
    tile_scores<D>(Qs, Ks, sr, sc, s);
    const int n = n0 + sr;
#pragma unroll
    for (int j = 0; j < kAttnBK / 4; ++j) {
      const int c = sc + 4 * j;
      const int m = m0 + c;
      float p = 0.f, ds = 0.f;
      if (m < M && n < N) {
        float val = s[j] * scale;
        if (mk) val += mk[(long long)n * M + m];
        p = __expf(val - lse_s[sr]);
        float dp = 0.f;
#pragma unroll 4
        for (int e = 0; e < DV; ++e)
          dp = fmaf(Gs[sr * (DV + 1) + e], Vs[c * (DV + 1) + e], dp);
        ds = p * (dp - dl_s[sr]);
      }
      Ps[sr * (kAttnBK + 1) + c] = p;
      Ds[sr * (kAttnBK + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerK; ++i) {
      const int e = tid + kAttnThreads * i;
      const int j = e / D, d = e % D;
      float a = acc_k[i];
#pragma unroll 8
      for (int r = 0; r < kAttnBQ; ++r)
        a = fmaf(Ds[r * (kAttnBK + 1) + j], Qs[r * (D + 1) + d], a);
      acc_k[i] = a;
    }
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int e = tid + kAttnThreads * i;
      if (e < kAttnBK * DV) {
        const int j = e / DV, c = e % DV;
        float a = acc_v[i];
#pragma unroll 8
        for (int r = 0; r < kAttnBQ; ++r)
          a = fmaf(Ps[r * (kAttnBK + 1) + j], Gs[r * (DV + 1) + c], a);
        acc_v[i] = a;
      }
    }
  }

  // write dk (times scale) and dv: straight to the outputs with one split,
  // else to this split's partial
  if (dk.p) {
    float* base;
    long long sn;
    if (splits == 1) {
      base = dk.p + b * dk.sb + (long long)h * D;
      sn = dk.sn;
    } else {
      base = part_k + (((long long)split * B + b) * M) * H * D +
             (long long)h * D;
      sn = (long long)H * D;
    }
#pragma unroll
    for (int i = 0; i < kPerK; ++i) {
      const int e = tid + kAttnThreads * i;
      const int j = e / D, d = e % D;
      if (m0 + j < M) base[(m0 + j) * sn + d] = acc_k[i] * scale;
    }
  }
  if (dv.p) {
    float* base;
    long long sn;
    if (splits == 1) {
      base = dv.p + b * dv.sb + (long long)h * DV;
      sn = dv.sn;
    } else {
      base = part_v + (((long long)split * B + b) * M) * H * DV +
             (long long)h * DV;
      sn = (long long)H * DV;
    }
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int e = tid + kAttnThreads * i;
      if (e < kAttnBK * DV) {
        const int j = e / DV, c = e % DV;
        if (m0 + j < M) base[(m0 + j) * sn + c] = acc_v[i];
      }
    }
  }
}

// dst(b, m, col) = sum over splits of part[split][b][m][col], in order.
__global__ void attention_split_reduce_kernel(const float* __restrict__ part,
                                              int splits, int B, int M,
                                              int width, AttnGrad dst) {
  const long long per = (long long)B * M * width;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * per + idx];
  const int col = (int)(idx % width);
  const long long bm = idx / width;
  const int m = (int)(bm % M), b = (int)(bm / M);
  dst.p[b * dst.sb + (long long)m * dst.sn + col] = s;
}

template <int D, int DV>
cudaError_t attention_bwd_launch(AttnOperand q, AttnOperand k, AttnOperand v,
                                 AttnOperand o, AttnOperand go, AttnGrad dq,
                                 AttnGrad dk, AttnGrad dv, const float* mask,
                                 int mask_nw, int B, int H, int N, int M,
                                 float scale, Workspace ws,
                                 cudaStream_t stream) {
  using L = AttnBwdSmem<D, DV>;
  const long long rows = (long long)B * H * N;
  float* lse = ws.take(rows);
  float* delta = ws.take(rows);
  if (!lse || !delta) return cudaErrorInvalidValue;

  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kDqBytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<D, DV>
      <<<dim3(ceil_div(N, kAttnBQ), H, B), kAttnThreads, L::kDqBytes,
         stream>>>(q, k, v, o, go, dq, mask, mask_nw, N, M, scale, lse,
                   delta);
  err = cudaGetLastError();
  if (err != cudaSuccess || (!dk.p && !dv.p)) return err;

  // split the queries when the key tiles alone leave the card idle
  const int key_tiles = ceil_div(M, kAttnBK);
  const int q_tiles = ceil_div(N, kAttnBQ);
  const long long blocks = (long long)key_tiles * H * B;
  int splits = 1;
  if (blocks < kTargetBlocks)
    splits = min(q_tiles, ceil_div(kTargetBlocks, blocks));
  const long long part_k = (long long)B * M * H * D;
  const long long part_v = (long long)B * M * H * DV;
  while (splits > 1 && splits * (part_k + part_v) > ws.n) --splits;
  float* pk = nullptr;
  float* pv = nullptr;
  if (splits > 1) {
    pk = ws.take(splits * part_k);
    pv = ws.take(splits * part_v);
  }

  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kDkvBytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<D, DV>
      <<<dim3(key_tiles, H, B * splits), kAttnThreads, L::kDkvBytes,
         stream>>>(q, k, v, go, dk, dv, mask, mask_nw, N, M, scale, lse,
                   delta, splits, pk, pv, B);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  if (dk.p)
    attention_split_reduce_kernel<<<ceil_div(part_k, 256), 256, 0, stream>>>(
        pk, splits, B, M, H * D, dk);
  if (dv.p)
    attention_split_reduce_kernel<<<ceil_div(part_v, 256), 256, 0, stream>>>(
        pv, splits, B, M, H * DV, dv);
  return cudaGetLastError();
}

// dq, dk, dv of attention(); any grad whose pointer is null is skipped.
// o is the forward's output, go its gradient.
inline cudaError_t attention_bwd(int D, int DV, AttnOperand q, AttnOperand k,
                                 AttnOperand v, AttnOperand o, AttnOperand go,
                                 AttnGrad dq, AttnGrad dk, AttnGrad dv,
                                 const float* mask, int mask_nw, int B,
                                 int H, int N, int M, float scale,
                                 Workspace ws, cudaStream_t stream) {
#define EMIP_ATTN_BWD_CASE(d, dv_)                                          \
  if (D == d && DV == dv_)                                                  \
    return attention_bwd_launch<d, dv_>(q, k, v, o, go, dq, dk, dv, mask,   \
                                        mask_nw, B, H, N, M, scale, ws,     \
                                        stream);
  EMIP_ATTN_BWD_CASE(32, 32)
  EMIP_ATTN_BWD_CASE(64, 64)
  EMIP_ATTN_BWD_CASE(128, 128)
#undef EMIP_ATTN_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace emip
