// Kernel I: softmax(corr, -1) @ values over a stored correlation volume,
// forward and backward.
//
// Replaces emip_tpu/ops/pallas/corr_softmax.py:softmax_expectation
// (_softmax_expectation_kernel, _softmax_expectation_bwd_kernel). corr
// [B, M, N] fp32 (read as B*M independent rows), values [N, 2], out
// [B, M, 2]. It serves global matching on the read-corr path: the model
// stores the [B, HW, HW] correlation anyway (the motion prompt's input), and
// the expectation over the pixel grid is taken from it, forward flow on
// corr and backward flow on its transpose.
//
// What bounds it on the card: bytes. Every corr element is read once (120
// MB at [8, 1936, 1936]) for ~10 operations, so the forward is one pass:
// one warp per row, each lane keeps an online max, sum and 2-wide
// accumulator over its strided elements, and the 32 partial states merge
// by their maxima. The probabilities are never stored, as on the TPU,
// where a row tile of corr sat in VMEM.
//
// Backward: dcorr = p (g values^T - g . out), dvalues = sum over all rows
// of p^T g. The TPU kernel reads the forward's output and accumulates
// dvalues over a sequential grid. Here one block owns a run of rows: per
// row it recomputes the max, sum and output (one read of the row, the
// second pass for p hits the cache), writes dcorr, and adds p g into its
// own [N, 2] partial in shared memory, where each thread owns the columns
// n = tid mod 256, so no two threads meet. The partials go to the
// workspace and an ordered column sum adds them: no atomics, the same bits
// every run. Either grad is skipped when its pointer is null (the model's
// values are the pixel grid, which takes no gradient).

#include "primitives.cuh"

namespace emip {
namespace {

constexpr int kSeFwdWarps = 8;
constexpr int kSeBwdThreads = 256;
constexpr int kSeBwdBlocks = 4 * kSmCount;  // with dvalues: one partial each

// Running softmax state of a set of elements: max, sum of exp(x - max) and
// the exp-weighted sums of the two value columns.
struct RowState {
  float m, s, a0, a1;
};

__device__ __forceinline__ void add_element(RowState& r, float x, float2 v) {
  const float mn = fmaxf(r.m, x);
  const float c = __expf(r.m - mn), p = __expf(x - mn);
  r.s = r.s * c + p;
  r.a0 = r.a0 * c + p * v.x;
  r.a1 = r.a1 * c + p * v.y;
  r.m = mn;
}

__device__ __forceinline__ RowState merge(RowState a, RowState b) {
  const float m = fmaxf(a.m, b.m);
  // a state that saw no element has m = -inf and s = 0
  const float ca = a.m == -INFINITY ? 0.f : __expf(a.m - m);
  const float cb = b.m == -INFINITY ? 0.f : __expf(b.m - m);
  return RowState{m, a.s * ca + b.s * cb, a.a0 * ca + b.a0 * cb,
                  a.a1 * ca + b.a1 * cb};
}

__device__ __forceinline__ RowState warp_merge(RowState r) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    RowState other;
    other.m = __shfl_xor_sync(0xffffffffu, r.m, o);
    other.s = __shfl_xor_sync(0xffffffffu, r.s, o);
    other.a0 = __shfl_xor_sync(0xffffffffu, r.a0, o);
    other.a1 = __shfl_xor_sync(0xffffffffu, r.a1, o);
    r = merge(r, other);
  }
  return r;
}

__global__ void __launch_bounds__(32 * kSeFwdWarps)
softmax_expectation_kernel(const float* __restrict__ corr,
                           const float2* __restrict__ values,
                           float2* __restrict__ out, long long rows, int N) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * kSeFwdWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const float* c = corr + row * N;
  RowState r{-INFINITY, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int n = lane; n < N; n += 32) add_element(r, c[n], values[n]);
  r = warp_merge(r);
  if (lane == 0) out[row] = make_float2(r.a0 / r.s, r.a1 / r.s);
}

// One block per run of rows_per_block rows. part: [gridDim.x, N, 2] or null.
__global__ void __launch_bounds__(kSeBwdThreads)
softmax_expectation_bwd_kernel(const float* __restrict__ corr,
                               const float2* __restrict__ values,
                               const float2* __restrict__ g,
                               float* __restrict__ dcorr,
                               float2* __restrict__ part, long long rows,
                               int N, int rows_per_block) {
  extern __shared__ float2 acc[];  // [N] dvalues partial (with part only)
  __shared__ RowState red[kSeBwdThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (part)
    for (int n = tid; n < N; n += kSeBwdThreads) acc[n] = make_float2(0.f, 0.f);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (long long row = r0; row < r1; ++row) {
    const float* c = corr + row * N;
    RowState r{-INFINITY, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int n = tid; n < N; n += kSeBwdThreads)
      add_element(r, c[n], values[n]);
    r = warp_merge(r);
    if (lane == 0) red[warp] = r;
    __syncthreads();
    RowState t = red[0];
#pragma unroll
    for (int w = 1; w < kSeBwdThreads / 32; ++w) t = merge(t, red[w]);
    __syncthreads();  // red is free for the next row
    const float inv = 1.0f / t.s;
    const float2 gr = g[row];
    const float inner = (gr.x * t.a0 + gr.y * t.a1) * inv;  // g . out
    for (int n = tid; n < N; n += kSeBwdThreads) {
      const float p = __expf(c[n] - t.m) * inv;
      if (dcorr) {
        const float2 v = values[n];
        dcorr[row * N + n] = p * (gr.x * v.x + gr.y * v.y - inner);
      }
      if (part) {
        float2 a = acc[n];
        a.x = fmaf(p, gr.x, a.x);
        a.y = fmaf(p, gr.y, a.y);
        acc[n] = a;
      }
    }
  }
  if (part)
    for (int n = tid; n < N; n += kSeBwdThreads)
      part[(long long)blockIdx.x * N + n] = acc[n];
}

}  // namespace
}  // namespace emip

extern "C" int emip_softmax_expectation(const float* corr,
                                        const float* values, float* out,
                                        long long rows, int N, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  softmax_expectation_kernel<<<ceil_div(rows, kSeFwdWarps), 32 * kSeFwdWarps,
                               0, s>>>(
      corr, reinterpret_cast<const float2*>(values),
      reinterpret_cast<float2*>(out), rows, N);
  return (int)cudaGetLastError();
}

// g: [rows, 2] gradient of out. dcorr [rows, N] and dvalues [N, 2] may each
// be null (not computed). ws: kSeBwdBlocks * N * 2 floats of partials when
// dvalues is asked for, and the column-sum workspace behind them.
extern "C" int emip_softmax_expectation_bwd(const float* corr,
                                            const float* values,
                                            const float* g, float* dcorr,
                                            float* dvalues, float* ws,
                                            long long ws_floats,
                                            long long rows, int N,
                                            void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Workspace w{ws, ws_floats};
  int blocks = (int)min(rows, (long long)(dvalues ? kSeBwdBlocks
                                                  : 16 * kSmCount));
  const int per = ceil_div(rows, blocks);
  blocks = ceil_div(rows, per);
  float* part = nullptr;
  size_t smem = 0;
  if (dvalues) {
    part = w.take((long long)blocks * N * 2);
    if (!part) return (int)cudaErrorInvalidValue;
    smem = sizeof(float2) * (size_t)N;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          softmax_expectation_bwd_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  softmax_expectation_bwd_kernel<<<blocks, kSeBwdThreads, smem, s>>>(
      corr, reinterpret_cast<const float2*>(values),
      reinterpret_cast<const float2*>(g), dcorr,
      reinterpret_cast<float2*>(part), rows, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !dvalues) return (int)err;
  return (int)colsum(part, 2LL * N, blocks, 2 * N, dvalues, w, s);
}
