// Kernel F: the long-term memory read, forward and backward.
//
//   out = softmax(q k^T / sqrt(C) + bias, over the N keys) v
//
// Replaces emip_tpu/ops/pallas/memory_attention.py:masked_memory_attention
// (_fwd_kernel, _bwd_kernel). q [B, M, C] is the query frame's key map,
// k and v [B, N, C] the ring of memory keys and values flattened slot-major
// (N = slots * M), bias [B, N] is 0 on the keys of a written slot and -1e9
// on those of an empty one; out [B, M, C]. C = 128. At 352^2 inputs M = 1936
// and N = 9680, at 512^2 M = 4096 and N = 20480.
//
// Forward. What bounds it on the card: the two products, 4 * M * N * C FLOP
// per batch row (9.6 GFLOP at 352^2), in fp32 on the CUDA cores; the
// operands are ~12 MB. The TPU kernel keeps all N keys and a [tile, N] block
// of scores in VMEM; here neither fits in shared memory, so one block of 256
// threads owns 64 query rows and streams the keys and values in tiles of
// 64 with an online max and sum (the bias is added before the running
// max). Each thread holds a 4 x 4 patch of the score tile and a 4 x 8
// patch of the output in registers; q and k tiles sit in shared memory
// transposed ([C][64 + 1]) so that both products read them without bank
// conflicts. With few query tiles (B = 1) the keys are split across blocks
// and an ordered pass merges the partial outputs by their max and sum.
// All-masked tiles are not skipped: with every slot empty all scores are
// equal and the result is the plain mean of the values, as on the TPU.
//
// Backward. What bounds it: five M x N x C products per batch row when all
// three grads are asked for (the scores, dO v^T, dS k, dS^T q, P^T dO),
// 24 GFLOP at 352^2; at the fp32 rate of the CUDA cores that is the bound
// the records state. The first version ran them there out of 64 x 64 tiles
// with 4 x 4 register patches, a shared load for every two to three
// multiply-adds and no overlap of loads with arithmetic. This one
// (attention_bwd_tc of mma_tf32.cuh) runs all five on the tensor cores as
// 3xTF32 (fp32-grade: the long train step's grad check leaves no room for a
// single TF32 product): 8 warps own 128 rows of one side, kept in shared
// memory with their dO or v rows (132 KiB), and stream the other side in
// tiles of 32 rows through two cp.async stages (66 KiB), one block on an
// SM. The TPU kernel accumulates dk and dv over a sequential grid of query
// tiles. Blocks run in no order here, so a query-tiled pass writes dq (keys
// split across blocks when there are few query tiles, partials summed in
// order) and a key-tiled pass streams the queries and writes dk and dv; both
// recompute P = exp(S - m) / l from the row max m and sum l the forward kept
// (kept apart, not as m + log l: with every slot empty m is -1e9, where
// fp32 has no room for log l), so the scores and dO v^T are computed twice.
// dq alone runs the first pass only. No atomics: every run gives the same
// bits.

#include "mma_tf32.cuh"

// the backward's tiling: warps, fragments of 16 resident rows per warp,
// streamed rows per stage
constexpr int kMemBwdWarps = 8;
constexpr int kMemBwdMt = 1;
constexpr int kMemBwdStr = 32;

namespace emip {
namespace {

constexpr int kMemD = 128;       // key and value width
constexpr int kMemBQ = 64;       // query rows per tile
constexpr int kMemBK = 64;       // keys per tile
constexpr int kMemThreads = 256; // 16 x 16
constexpr int kMemLdT = kMemBQ + 1;   // leading dim of a transposed tile
constexpr int kMemLdS = kMemBK + 16;  // leading dim of a score tile
constexpr int kMemTileT = kMemD * kMemLdT;
constexpr int kMemTileS = kMemBQ * kMemLdS;

// dst[d][r] = src[(r0 + r), d] for a 64-row tile, zero past rows_total.
__device__ __forceinline__ void mem_load_t(float* dst, const float* src,
                                           int r0, int rows_total, int tid) {
  for (int i = tid; i < kMemBQ * kMemD; i += kMemThreads) {
    const int r = i / kMemD, d = i % kMemD;
    const int n = r0 + r;
    dst[d * kMemLdT + r] = n < rows_total ? src[(long long)n * kMemD + d] : 0.f;
  }
}

// dst[r][d] = src[(r0 + r), d], zero past rows_total.
__device__ __forceinline__ void mem_load_rows(float* dst, const float* src,
                                              int r0, int rows_total,
                                              int tid) {
  for (int i = tid; i < kMemBK * kMemD; i += kMemThreads) {
    const int n = r0 + i / kMemD;
    dst[i] = n < rows_total ? src[(long long)n * kMemD + i % kMemD] : 0.f;
  }
}

// Max / sum over the 16 threads (one half-warp) that share a score row.
__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr size_t kMemFwdBytes =
    sizeof(float) * (2 * kMemTileT + kMemBK * kMemD + kMemTileS + kMemBK);

// grid (query tiles, key splits, B). Split z of a batch row handles the key
// tiles [z * tiles_per_split, ...); with one split the block writes out and
// stats (if not null; [2, B, M]: row max, then row sum), else its normalised
// partial and that partial's max and sum ([2, B, splits, M]).
__global__ void __launch_bounds__(kMemThreads)
memory_attention_fwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            float* __restrict__ out, float* __restrict__ stats,
                            float* __restrict__ part_o,
                            float* __restrict__ part_stats, int M, int N,
                            float scale, int tiles_per_split) {
  extern __shared__ float smem[];
  float* Qt = smem;                    // [D][BQ+1]
  float* Kt = Qt + kMemTileT;          // [D][BK+1]
  float* Vs = Kt + kMemTileT;          // [BK][D]
  float* Ps = Vs + kMemBK * kMemD;     // [BQ][BK+16]
  float* bias_s = Ps + kMemTileS;      // [BK]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kMemBQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int b = blockIdx.z;
  q += (long long)b * M * kMemD;
  k += (long long)b * N * kMemD;
  v += (long long)b * N * kMemD;
  bias += (long long)b * N;

  mem_load_t(Qt, q, n0, M, tid);

  float acc[4][8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int key_tiles = (N + kMemBK - 1) / kMemBK;
  const int t_end = min(key_tiles, (split + 1) * tiles_per_split);
  for (int t = split * tiles_per_split; t < t_end; ++t) {
    const int m0 = t * kMemBK;
    __syncthreads();  // previous tile fully consumed
    mem_load_t(Kt, k, m0, N, tid);
    mem_load_rows(Vs, v, m0, N, tid);
    if (tid < kMemBK)
      bias_s[tid] = m0 + tid < N ? bias[m0 + tid] : -INFINITY;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kMemD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qt[d * kMemLdT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Kt[d * kMemLdT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a key past N has bias -inf and so weight 0
        s[i][j] = s[i][j] * scale + bias_s[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row16_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kMemLdS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = __expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + row16_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kMemBK; ++j) {
      float p[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kMemLdS + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) vv[c] = Vs[j * kMemD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  const long long B = gridDim.z;
  float* o_dst;
  float* m_dst;  // row max; the row sum lies `rows` floats further
  long long rows;
  if (splits == 1) {
    o_dst = out + (long long)b * M * kMemD;
    m_dst = stats ? stats + (long long)b * M : nullptr;
    rows = B * M;
  } else {
    const long long slot = (long long)b * splits + split;
    o_dst = part_o + slot * M * kMemD;
    m_dst = part_stats + slot * M;
    rows = B * splits * M;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= M) continue;
    const float inv = 1.0f / l_run[i];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      o_dst[(long long)n * kMemD + tx + 16 * c] = acc[i][c] * inv;
    if (m_dst && tx == 0) {
      m_dst[n] = m_run[i];
      m_dst[rows + n] = l_run[i];
    }
  }
}

// out = sum_z w_z part_o[z] / sum_z w_z with w_z = l_z exp(m_z - max m), the
// splits taken in order; stats (if not null) gets max m and sum_z w_z.
__global__ void memory_attention_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_stats,
    int splits, int B, int M, float* __restrict__ out,
    float* __restrict__ stats) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)B * M;
  if (idx >= rows * kMemD) return;
  const int d = (int)(idx % kMemD);
  const long long bm = idx / kMemD;
  const int n = (int)(bm % M), b = (int)(bm / M);
  const float* pm = part_stats + (long long)b * splits * M + n;
  const float* pl = pm + rows * splits;
  const float* po = part_o + ((long long)b * splits * M + n) * kMemD + d;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, pm[(long long)z * M]);
  float wsum = 0.f, o = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float w = pl[(long long)z * M] * __expf(pm[(long long)z * M] - mx);
    wsum += w;
    o = fmaf(w, po[(long long)z * M * kMemD], o);
  }
  out[idx] = o / wsum;
  if (stats && d == 0) {
    stats[bm] = mx;
    stats[rows + bm] = wsum;
  }
}

// Key splits of a query-tiled pass: as many as fill the card in one wave,
// and no more than the workspace holds (per_split floats each).
inline int mem_key_splits(int q_tiles, int B, int key_tiles,
                          long long per_split, long long ws_floats) {
  const long long blocks = (long long)q_tiles * B;
  long long splits = blocks < kSmCount ? kSmCount / blocks : 1;
  splits = min(splits, (long long)key_tiles);
  if (splits > 1) splits = min(splits, ws_floats / per_split);
  return (int)max(splits, 1LL);
}

}  // namespace
}  // namespace emip

// stats [2, B, M] (row max, row sum) may be null (no gradient will be
// taken). ws: scratch for the key-split partials.
extern "C" int emip_memory_attention(const float* q, const float* k,
                                     const float* v, const float* bias,
                                     float* out, float* stats, float* ws,
                                     long long ws_floats, int B, int M, int N,
                                     int C, void* stream) {
  using namespace emip;
  if (C != kMemD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)C);
  const int q_tiles = ceil_div(M, kMemBQ), key_tiles = ceil_div(N, kMemBK);
  const long long rows = (long long)B * M;
  int splits =
      mem_key_splits(q_tiles, B, key_tiles, rows * (kMemD + 2), ws_floats);
  const int per = ceil_div(key_tiles, splits);
  splits = ceil_div(key_tiles, per);  // no split without a tile
  float* part_o = nullptr;
  float* part_stats = nullptr;
  if (splits > 1) {
    part_o = ws;
    part_stats = ws + (long long)splits * rows * kMemD;
  }
  cudaError_t err = cudaFuncSetAttribute(
      memory_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMemFwdBytes);
  if (err != cudaSuccess) return (int)err;
  memory_attention_fwd_kernel<<<dim3(q_tiles, splits, B), kMemThreads,
                                kMemFwdBytes, s>>>(
      q, k, v, bias, out, stats, part_o, part_stats, M, N, scale, per);
  if (splits > 1)
    memory_attention_merge_kernel<<<ceil_div(rows * kMemD, 256), 256, 0, s>>>(
        part_o, part_stats, splits, B, M, out, stats);
  return (int)cudaGetLastError();
}

// g: [B, M, C] gradient of out; out and stats are the forward's. dq, dk, dv
// may each be null (not computed); the bias gets no gradient. ws: scratch
// for delta and the partials of a split pass.
extern "C" int emip_memory_attention_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const float* out, const float* stats, const float* g, float* dq, float* dk,
    float* dv, float* ws, long long ws_floats, int B, int M, int N, int C,
    void* stream) {
  using namespace emip;
  if (C != kMemD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)M * C, ksb = (long long)N * C;
  cudaError_t err =
      attention_bwd_tc<kMemD, kMemD, kMemBwdWarps, kMemBwdMt, kMemBwdStr>(
      AttnOperand{q, qsb, C}, AttnOperand{k, ksb, C}, AttnOperand{v, ksb, C},
      AttnOperand{out, qsb, C}, AttnOperand{g, qsb, C}, bias, stats,
      stats + (long long)B * M, AttnGrad{dq, qsb, C}, AttnGrad{dk, ksb, C},
      AttnGrad{dv, ksb, C}, B, M, N, 1.0f / sqrtf((float)C),
      Workspace{ws, ws_floats}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
