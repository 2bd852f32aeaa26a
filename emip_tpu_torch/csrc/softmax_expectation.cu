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
// dvalues over a sequential grid. Here a block owns a run of rows and its
// threads own the same columns on every row: thread t the loads t, t + 256,
// ... of the row (float4 where N is a multiple of 4 and corr and dcorr are
// 16-byte aligned, else single floats), up to 4096 floats a row in all. A
// row is read once from DRAM (streaming loads) into registers, with the
// next row's loads issued before this row's reductions, so they stay in
// flight. The softmax takes two block reductions, the max and then the sum
// of e = exp(x - max) with the two sums of e v (no online rescaling, one
// exp per element); g . out comes from the row's own sums, dcorr goes out
// with streaming stores, and each thread keeps its columns' share of p g,
// the block's dvalues partial, in registers across the block's rows. The
// partials go to the workspace and an ordered column sum adds them: no
// atomics, no shared-memory read-modify-write, the same bits on every call.
// A row longer than the register tile takes the streaming instantiation:
// an online softmax pass, then a pass that writes dcorr and adds p g into
// the block's partial (in shared memory up to N = 28928, else in the
// workspace), each element by its own thread.
// Either grad is skipped when its pointer is null (the model's values are
// the pixel grid, which takes no gradient).

#include <stdint.h>

#include "primitives.cuh"

namespace emip {
namespace {

constexpr int kSeFwdWarps = 8;
constexpr int kSeBwdThreads = 256;
constexpr int kSeBwdWarps = kSeBwdThreads / 32;
// the register tile: up to 16 floats a thread, rows of up to 4096 floats
constexpr int kSeBwdTile = 16 * kSeBwdThreads;
constexpr int kSeStreamBlocks = 4 * kSmCount;

// Blocks an SM holds of the row kernel with E floats a thread (the launch
// bounds' register budget), and so blocks of a launch: each has its own
// dvalues partial.
constexpr int se_blocks_per_sm(int e) { return e <= 8 ? 3 : 2; }

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

template <int V>
__device__ __forceinline__ void load_cs(const float* p, float* d) {
  if constexpr (V == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else {
    d[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store_cs(float* p, const float* d) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(d[0], d[1], d[2], d[3]));
  else
    __stcs(p, d[0]);
}

// Loads of a row into the register tile: thread tid owns the P loads of V
// floats at columns V (tid + k 256); columns past N read as -inf (weight 0).
template <int V, int P>
__device__ __forceinline__ void load_row(const float* row, int N, int tid,
                                         float (&d)[V * P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int c = V * (tid + k * kSeBwdThreads);
    if (c < N) {
      load_cs<V>(row + c, d + k * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) d[k * V + e] = -INFINITY;
    }
  }
}

// The register-tile backward: rows [blockIdx.x * per, + per) of corr; part
// [gridDim.x, N, 2] when kDv.
template <int V, int P, bool kDv>
__global__ void __launch_bounds__(kSeBwdThreads, se_blocks_per_sm(V * P))
softmax_expectation_bwd_kernel(const float* __restrict__ corr,
                               const float* __restrict__ values,
                               const float2* __restrict__ g,
                               float* __restrict__ dcorr,
                               float* __restrict__ part, long long rows,
                               int N, int per) {
  constexpr int E = V * P;
  __shared__ float red_m[kSeBwdWarps];
  __shared__ float3 red_s[kSeBwdWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  // the owned columns' values, and their share of dvalues
  float vx[E], vy[E], dvx[E], dvy[E];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int c = V * (tid + k * kSeBwdThreads);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const bool in = c + e < N;
      vx[k * V + e] = in ? values[2 * (c + e)] : 0.f;
      vy[k * V + e] = in ? values[2 * (c + e) + 1] : 0.f;
      dvx[k * V + e] = dvy[k * V + e] = 0.f;
    }
  }
  float x[E], nx[E];
  if (r0 < r1) load_row<V, P>(corr + r0 * N, N, tid, x);
  for (long long row = r0; row < r1; ++row) {
    const float2 gr = g[row];
    if (row + 1 < r1) load_row<V, P>(corr + (row + 1) * N, N, tid, nx);
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < E; ++i) m = fmaxf(m, x[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red_m[warp] = m;
    __syncthreads();
    m = red_m[0];
#pragma unroll
    for (int w = 1; w < kSeBwdWarps; ++w) m = fmaxf(m, red_m[w]);
    float s = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float e = __expf(x[i] - m);
      x[i] = e;
      s += e;
      a0 = fmaf(e, vx[i], a0);
      a1 = fmaf(e, vy[i], a1);
    }
    s = warp_sum(s);
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    // red_m and red_s are each written once a row between the two
    // barriers that bracket their last reads: one buffer each is enough
    if (lane == 0) red_s[warp] = make_float3(s, a0, a1);
    __syncthreads();
    float3 t = red_s[0];
#pragma unroll
    for (int w = 1; w < kSeBwdWarps; ++w) {
      const float3 u = red_s[w];
      t.x += u.x, t.y += u.y, t.z += u.z;
    }
    const float inv = 1.0f / t.x;
    const float inner = (gr.x * t.y + gr.y * t.z) * inv;  // g . out
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float p = x[i] * inv;
      x[i] = p * (fmaf(gr.x, vx[i], gr.y * vy[i]) - inner);
      if (kDv) {
        dvx[i] = fmaf(p, gr.x, dvx[i]);
        dvy[i] = fmaf(p, gr.y, dvy[i]);
      }
    }
    if (dcorr) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int c = V * (tid + k * kSeBwdThreads);
        if (c < N) store_cs<V>(dcorr + row * N + c, x + k * V);
      }
    }
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = nx[i];
  }
  if (kDv) {
    float* out = part + (long long)blockIdx.x * N * 2;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int c = V * (tid + k * kSeBwdThreads);
      if (c >= N) continue;
      const int i = k * V;
      if constexpr (V == 4) {
        float4* o = reinterpret_cast<float4*>(out + 2 * c);
        o[0] = make_float4(dvx[i], dvy[i], dvx[i + 1], dvy[i + 1]);
        o[1] = make_float4(dvx[i + 2], dvy[i + 2], dvx[i + 3], dvy[i + 3]);
      } else {
        reinterpret_cast<float2*>(out)[c] = make_float2(dvx[i], dvy[i]);
      }
    }
  }
}

// Rows longer than the register tile: an online softmax pass, then dcorr
// and the block's dvalues partial (part [gridDim.x, N] or null), each
// element of the partial added to by its own thread only: with kSmem in
// shared memory (dynamic, N float2), else in place in the workspace. The
// bound of four blocks an SM schedules its loads better (measured).
template <bool kSmem>
__global__ void __launch_bounds__(kSeBwdThreads, 4)
softmax_expectation_bwd_stream_kernel(const float* __restrict__ corr,
                                      const float2* __restrict__ values,
                                      const float2* __restrict__ g,
                                      float* __restrict__ dcorr,
                                      float2* __restrict__ part,
                                      long long rows, int N, int per) {
  extern __shared__ float2 sacc[];
  __shared__ RowState red[kSeBwdWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float2* out = part ? part + (long long)blockIdx.x * N : nullptr;
  float2* acc = kSmem ? sacc : out;
  if (acc)
    for (int n = tid; n < N; n += kSeBwdThreads)
      acc[n] = make_float2(0.f, 0.f);
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
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
    for (int w = 1; w < kSeBwdWarps; ++w) t = merge(t, red[w]);
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
      if (acc) {
        float2 a = acc[n];
        a.x = fmaf(p, gr.x, a.x);
        a.y = fmaf(p, gr.y, a.y);
        acc[n] = a;
      }
    }
  }
  if (kSmem)
    for (int n = tid; n < N; n += kSeBwdThreads) out[n] = sacc[n];
}

// dvalues partials of the streaming instantiation up to this N sit in
// shared memory (the 227 KB a block may have, less 1 KB for red)
constexpr int kSeStreamSmemN = (232448 - 1024) / sizeof(float2);

// The backward's plan at a shape: the instantiation (V floats a load, P
// loads a thread; V = 0 the streaming one) and the blocks, each with a run
// of per rows.
struct SeBwdPlan {
  int v, p, blocks, per;
};

inline SeBwdPlan se_bwd_plan(long long rows, int N, bool vec) {
  SeBwdPlan plan{0, 0, kSeStreamBlocks, 0};
  if (vec && N <= kSeBwdTile) {
    plan.v = 4;
    plan.p = ceil_div(N, 4 * kSeBwdThreads);
  } else if (N <= kSeBwdTile) {
    plan.v = 1;
    plan.p = N <= 4 * kSeBwdThreads ? 4 : N <= 8 * kSeBwdThreads ? 8 : 16;
  }
  if (plan.v) plan.blocks = se_blocks_per_sm(plan.v * plan.p) * kSmCount;
  plan.blocks = (int)min(rows, (long long)plan.blocks);
  plan.per = ceil_div(rows, plan.blocks);
  plan.blocks = ceil_div(rows, plan.per);
  return plan;
}

// Floats of the dvalues partials and of their ordered column sum.
inline long long se_bwd_workspace(const SeBwdPlan& plan, int N) {
  const long long chunks = min(256, max(1, ceil_div(plan.blocks, 64)));
  return ((long long)plan.blocks + chunks) * 2 * N;
}

struct SeBwdArgs {
  const float* corr;
  const float* values;
  const float2* g;
  float* dcorr;
  float* part;
  long long rows;
  int N;
};

template <int V, int P>
cudaError_t se_bwd_launch(const SeBwdArgs& a, const SeBwdPlan& plan,
                          cudaStream_t s) {
  if (a.part)
    softmax_expectation_bwd_kernel<V, P, true>
        <<<plan.blocks, kSeBwdThreads, 0, s>>>(
            a.corr, a.values, a.g, a.dcorr, a.part, a.rows, a.N, plan.per);
  else
    softmax_expectation_bwd_kernel<V, P, false>
        <<<plan.blocks, kSeBwdThreads, 0, s>>>(
            a.corr, a.values, a.g, a.dcorr, a.part, a.rows, a.N, plan.per);
  return cudaGetLastError();
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

// Floats of workspace the backward needs at this shape when dvalues is
// asked for (the larger of its two plans, float4 and single loads).
extern "C" long long emip_softmax_expectation_bwd_workspace(long long rows,
                                                            int N) {
  using namespace emip;
  if (rows <= 0 || N <= 0) return 0;
  return max(se_bwd_workspace(se_bwd_plan(rows, N, N % 4 == 0), N),
             se_bwd_workspace(se_bwd_plan(rows, N, false), N));
}

// g: [rows, 2] gradient of out. dcorr [rows, N] and dvalues [N, 2] may each
// be null (not computed). ws: emip_softmax_expectation_bwd_workspace floats
// when dvalues is asked for.
extern "C" int emip_softmax_expectation_bwd(const float* corr,
                                            const float* values,
                                            const float* g, float* dcorr,
                                            float* dvalues, float* ws,
                                            long long ws_floats,
                                            long long rows, int N,
                                            void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || (!dcorr && !dvalues)) return (int)cudaSuccess;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = N % 4 == 0 && aligned(corr) && (!dcorr || aligned(dcorr));
  const SeBwdPlan plan = se_bwd_plan(rows, N, vec);
  Workspace w{ws, ws_floats};
  float* part = nullptr;
  if (dvalues) {
    if (ws_floats < se_bwd_workspace(plan, N))
      return (int)cudaErrorInvalidValue;
    part = w.take((long long)plan.blocks * N * 2);
  }
  const SeBwdArgs a{corr, values, reinterpret_cast<const float2*>(g), dcorr,
                    part, rows, N};
  cudaError_t err;
  switch (plan.v * 100 + plan.p) {
    case 401: err = se_bwd_launch<4, 1>(a, plan, s); break;
    case 402: err = se_bwd_launch<4, 2>(a, plan, s); break;
    case 403: err = se_bwd_launch<4, 3>(a, plan, s); break;
    case 404: err = se_bwd_launch<4, 4>(a, plan, s); break;
    case 104: err = se_bwd_launch<1, 4>(a, plan, s); break;
    case 108: err = se_bwd_launch<1, 8>(a, plan, s); break;
    case 116: err = se_bwd_launch<1, 16>(a, plan, s); break;
    default: {
      const bool in_smem = part && N <= kSeStreamSmemN;
      const size_t smem = in_smem ? sizeof(float2) * (size_t)N : 0;
      const auto kernel = in_smem
                              ? softmax_expectation_bwd_stream_kernel<true>
                              : softmax_expectation_bwd_stream_kernel<false>;
      err = cudaSuccess;
      if (smem > 48 * 1024)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<plan.blocks, kSeBwdThreads, smem, s>>>(
          corr, reinterpret_cast<const float2*>(values), a.g, dcorr,
          reinterpret_cast<float2*>(part), rows, N, plan.per);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess || !dvalues) return (int)err;
  return (int)colsum(part, 2LL * N, plan.blocks, 2 * N, dvalues, w, s);
}
