// Shared fp32 building blocks of the port's Hopper kernels on the CUDA
// cores.
//
// Device routines that the kernel entry points compose, each launched on
// the caller's stream and allocating nothing (scratch comes from a
// Workspace the caller's wrapper allocated):
//
//   layernorm       out = (res +) LN(x) * gamma + beta, one warp per row;
//   layernorm_bwd   dx (+)= LN'(x)^T dy, and dy * xhat for the gamma grad;
//                   dy in fp32, or bf16 (its bits);
//   colsum          out[c] (+)= sum_r in[r, c] (bias / LayerNorm grads),
//                   two ordered passes; in fp32, or bf16 (its bits);
//   gelu_exact, gelu_grad
//                   exact GELU and its derivative (the GEMM epilogues of
//                   gemm_tf32.cuh, kernel J).
//
// Every product of the port's kernels runs on the tensor cores as 3xTF32:
// the GEMM of kernels A, B, G and H (gemm_tf32.cuh) and every attention,
// forward and backward (attention_fwd_tc and attention_bwd_tc of
// mma_tf32.cuh). What stays here is elementwise or a reduction.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// an element as fp32: an fp32 one, or bf16 bits widened exactly
__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}

template <typename T>
__global__ void colsum_partial_kernel(const T* __restrict__ in, long long ld,
                                      int rows, int C, int rows_per_chunk,
                                      float* part) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  if (c < C)
    for (int r = r0 + threadIdx.y; r < r1; r += 8) s += as_f32(in[r * ld + c]);
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
// T: float, or uint16_t (bf16 bits).
template <typename T>
cudaError_t colsum(const T* in, long long ld, int rows, int C, float* out,
                   Workspace ws, cudaStream_t stream) {
  if (!out) return cudaSuccess;
  int chunks = min(256, max(1, ceil_div(rows, 64)));
  chunks = (int)min((long long)chunks, ws.n / C);
  if (chunks < 1) return cudaErrorInvalidValue;
  const int per = ceil_div(rows, chunks);
  chunks = ceil_div(rows, per);
  float* part = ws.take((long long)chunks * C);
  colsum_partial_kernel<T><<<dim3(ceil_div(C, 32), chunks), dim3(32, 8), 0,
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
// and, if prod is given, prod = dy * xhat (its column sum is dgamma). T:
// dy's element, float or uint16_t (bf16 bits, widened exactly).
template <typename T>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
layernorm_bwd_kernel(const float* __restrict__ x, int ldx,
                     const T* __restrict__ dy, int lddy,
                     const float* __restrict__ gamma, float* dx, int lddx,
                     bool accumulate, float* __restrict__ prod, int rows,
                     int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + (long long)row * ldx;
  const T* gr = dy + (long long)row * lddy;
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
    const float g = as_f32(gr[c]) * gamma[c];
    sg += g;
    sgx += g * (xr[c] - mu) * inv;
  }
  const float mg = warp_sum(sg) / C;
  const float mgx = warp_sum(sgx) / C;
  float* dr = dx + (long long)row * lddx;
  float* pr = prod ? prod + (long long)row * C : nullptr;
  for (int c = lane; c < C; c += 32) {
    const float xh = (xr[c] - mu) * inv;
    const float d = inv * (as_f32(gr[c]) * gamma[c] - mg - xh * mgx);
    dr[c] = accumulate ? dr[c] + d : d;
    if (pr) pr[c] = as_f32(gr[c]) * xh;
  }
}

// LayerNorm backward: dx, plus dgamma / dbeta when their pointers are set
// (prod is a [rows, C] scratch taken from the workspace for dgamma). T:
// dy's element, float or uint16_t (bf16 bits).
template <typename T>
cudaError_t layernorm_bwd(const float* x, int ldx, const T* dy, int lddy,
                          const float* gamma, float* dx, int lddx,
                          bool accumulate, float* dgamma, float* dbeta,
                          int rows, int C, float eps, Workspace ws,
                          cudaStream_t stream) {
  float* prod = nullptr;
  if (dgamma) {
    prod = ws.take((long long)rows * C);
    if (!prod) return cudaErrorInvalidValue;
  }
  const int blocks = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  layernorm_bwd_kernel<T><<<blocks, 32 * kLnRowsPerBlock, 0, stream>>>(
      x, ldx, dy, lddy, gamma, dx, lddx, accumulate, prod, rows, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = colsum(prod, C, rows, C, dgamma, ws, stream);
  if (err != cudaSuccess) return err;
  return colsum(dy, lddy, rows, C, dbeta, ws, stream);
}

}  // namespace
}  // namespace emip
