// bf16 building blocks of the port's bf16 forward kernels (the bf16 band of
// short inference: kernels A, B, C and D forward):
//
//   mma_bf16         mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
//                    bf16 operands, fp32 accumulators. Lane (g = lane / 4,
//                    t = lane % 4) holds a0 (row g, k 2t..2t+1), a1 (row
//                    g + 8, k 2t..), a2 (row g, k 2t+8..), a3 (row g + 8, k
//                    2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//                    c0, c1 (row g, n 2t, 2t+1), c2, c3 (row g + 8, ...).
//   ldmatrix_x4      four 8 x 8 bf16 matrices from shared memory, one row
//                    address per lane (lanes 8i..8i+7 address matrix i);
//                    lane l receives row l / 4, columns 2(l % 4), +1 of
//                    each: a fragment of a row-major A, or of a B whose n
//                    rows hold k contiguous (a torch weight [N, K], k rows
//                    [keys, D]). The .trans form gives the transpose: a B
//                    fragment of v rows [keys, DV] (k = keys).
//   pack_bf16        two fp32 values rounded to bf16 (nearest even) in one
//                    register, the lower index in the lower half: P of an
//                    attention, from its accumulator fragments, as the A
//                    operand of P v.
//   layernorm_self_bf16
//                    the LayerNorm of kernel B's bf16 self layer, rounded
//                    where the JAX kernel rounds (see window_attention.cu)
//                    (G's is the epilogue of its Wm product and B's output
//                    LayerNorm that of its W2 product, gemm_wgmma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace emip {
namespace {

// (kernel signatures below spell __nv_bfloat16: nvcc's host stubs do not
// resolve an alias declared in an unnamed namespace)
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

inline bool aligned16_ptr(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------------------------------------------------ LayerNorms

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// out[r, c] = bf16(res[r, c] + bf16(LN(x[r]) gamma + beta)), or
// bf16(LN(x[r]) gamma + beta) where res is null, stored as OUT (fp32 or
// bf16: the value is a bf16 value either way): B's self layer, x1 = x +
// msg.astype(bf16) in bf16, handed to the fp32 cross layer; G's output,
// with or without the residual. One warp per row.
template <typename OUT>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
layernorm_self_bf16_kernel(const float* __restrict__ x,
                           const __nv_bfloat16* __restrict__ res,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           OUT* __restrict__ out, int ldo, int rows, int C,
                           float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + (long long)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / C + eps);
  const bf16* rr = res ? res + (long long)row * C : nullptr;
  OUT* orow = out + (long long)row * ldo;
  for (int c = lane; c < C; c += 32) {
    const float msg = round_bf16((xr[c] - mu) * inv * gamma[c] + beta[c]);
    store_as(orow + c, rr ? round_bf16(__bfloat162float(rr[c]) + msg) : msg);
  }
}

template <typename OUT>
inline cudaError_t layernorm_self_bf16(const float* x, const bf16* res,
                                       const float* gamma, const float* beta,
                                       OUT* out, int ldo, int rows, int C,
                                       float eps, cudaStream_t stream) {
  const int blocks = ceil_div(rows, kLnRowsPerBlock);
  layernorm_self_bf16_kernel<OUT>
      <<<blocks, 32 * kLnRowsPerBlock, 0, stream>>>(x, res, gamma, beta, out,
                                                    ldo, rows, C, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace emip
