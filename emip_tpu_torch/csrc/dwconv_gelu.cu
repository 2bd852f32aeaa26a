// Kernel J: gelu_exact(dwconv3x3(u) + b) of the PVTv2 MixFFN on channel-last
// tokens, forward and backward.
//
// Replaces emip_tpu/ops/pallas/mixffn.py: fused_dwconv_gelu (_fwd_kernel,
// pallas_call at :170) and the backward it shares with
// dwconv_gelu_bwd_fused (_bwd_kernel, pallas_call at :185). u [B, H*W, F] is
// the fc1 output, wdw [3, 3, F] the depthwise taps, bdw [F]; out has u's
// shape. Zero padding at the image border. The TPU kernel works on the flat
// token axis, where a column shift wraps around the row end and is masked
// off; here every thread knows its (row, column) and the border is a bounds
// check.
//
// What bounds it on the card: bytes. The forward reads the hidden once and
// writes it once (63 MB each way at [8, 7744, 256], stage 1 of pvt_v2_b5 at
// 352^2) for 9 multiply-adds and one erf per element; the backward reads u
// and g and writes gu (three passes). Both kernels are stencils on the CUDA
// cores, and both are laid out so that each element comes from device
// memory about once:
//
// - A warp is one image column of 32 channel vectors (16-byte float4 loads,
//   512 contiguous bytes a row; an F that is not a multiple of 4, or a
//   pointer not 16-byte aligned, takes the scalar instantiation of the same
//   code). A block is a tile of up to 8 (forward) or 10 (backward) columns
//   by a strip of up to 16 rows (the forward cuts small maps into shorter
//   strips, so that its grid holds enough threads); the strips and tiles
//   are evened out over the image, so ragged maps (any H and W, one row,
//   one column) waste little. Image, strip, column and channel come from
//   the block index once, in 32-bit integers; only the image's base offset
//   is 64-bit.
// - Each thread keeps its channels' 9 taps and bias in registers and walks
//   down its column one input row at a time, with the next row's loads in
//   flight while it computes. The neighbour columns' loads are the
//   neighbouring warps' rows and hit L1 or L2.
// - Forward: a row feeds three output rows (through tap rows 2, 1, 0), so
//   three running sums stand for the 3 x 3 window; the finished row goes
//   out through gelu_exact (one erf per output).
// - Backward, one fused pass: the thread holds the 3 x 3 window of u around
//   its pixel, recomputes the pre-activation and gd = g * gelu'(pre) on the
//   tile plus a one-pixel halo (the two outer warps of the block are the
//   halo columns; the strip's walk starts one row early and ends one row
//   late), adds u(p + d) * gd(p) to its nine tap sums and gd to its bias
//   sum on the tile's own pixels, and passes gd through shared memory (a
//   double-buffered row, one barrier a row) to the warps beside it, which
//   apply the transposed taps as three running sums of gu rows. gd never
//   goes to device memory. Blocks are persistent, one per SM, each walking
//   its channel group's tiles in a fixed order; the tap and bias sums stay
//   in registers over all of a block's tiles, are added over its warps in
//   order through shared memory and written as one partial [blocks, 10, F];
//   a last pass adds the partials in order. No atomics: a second call gives
//   the same bits. Each of gu and the two parameter grads is skipped when
//   its pointer is null.
//
// The bf16 band (emip_dwconv_gelu_bf16, emip_dwconv_gelu_bwd_bf16) runs the
// same two kernels on bf16 storage, as the JAX kernels compute with a bf16
// u: u, the taps (which the model casts to bf16), g, out and gu are bf16,
// the bias fp32; every value is widened to fp32 where it is loaded, the
// stencil, the GELU and its gradient run in fp32, and each output is
// rounded once where it is stored. The backward's four channels a lane are
// one 8-byte load (256 contiguous bytes a row), the same tiling as the fp32
// float4 walk. The tap grad is summed in fp32 and rounded to bf16 by the
// last pass (the JAX backward returns it in the taps' dtype), the bias grad
// stays fp32.
//
// The bf16 forward (dwconv_gelu_fwd_staged_kernel, where F is a multiple of
// 8 and the pointers 16-byte aligned; else the column walk above at four or
// one channels a lane). What held the column walk back on bf16: each
// thread loaded its left, middle and right pixel of every row, two of them
// a neighbour warp's, in 8-byte loads (six load instructions for 256 useful
// bytes), with one row in flight in a chain where each load waits on the
// last; on the small maps its strips were a few rows long and it was
// latency-bound (2.9x its bound over the four stages, 0.75-0.99x the fp32
// row's time on half the bytes). The staged walk: eight channels a lane (one
// 16-byte copy), a block one channel group of 256 by up to 8 columns (a
// warp each); the rows go through a ring of four in shared memory, each the
// block's columns and a one-column halo copied by cp.async (zeros off the
// image), three rows in flight while one is summed, so each element leaves
// L2 once a strip (the halo columns twice) and the three columns a warp
// reads come from shared memory. Two blocks are resident an SM (128
// registers at most a thread, the taps 72 of them in fp32); the strips are
// cut so that the grid takes the fewest row steps in waves of those, so
// the small maps fill the card without a last, nearly empty wave. The sums
// are the column walk's in its order, so the bits are its bits.
//
// What held the bf16 backward back, and what its walk does about it: the
// walk runs a chain of row loads, each consumed one step after it is
// issued, at 168 registers a thread (12 warps, one block an SM: three
// warps a sub-partition). With its values widened where they were loaded,
// the bf16 walk spilled (ptxas: 8 bytes stored, 104 loaded a thread) and
// ran slower than fp32 on half the bytes. Now the next row's loads stay as
// loaded (Raw) until the step that uses them, and the window keeps bf16
// values as loaded, two a register, widened (exactly, by a shift or a
// mask) where each tap reads them: 162 registers, no spill, the same sums
// in the same order, so the same bits (the raw loads alone still spilled
// and ran level with fp32; the packed window took it under). Eight
// channels a lane (one 16-byte load, fp32's bytes a load) needs about
// twice the registers: at 168 it spilled 1.6 KB a thread, and in blocks of
// 8 warps (255 registers, 104 bytes of spill loads) it still ran slower
// than four channels, so the bf16 walk keeps fp32's tiling.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"
#include "primitives.cuh"

namespace emip {
namespace {

constexpr int kLanes = 32;      // channel vectors of a warp
constexpr int kFwdCols = 8;     // most columns of a forward block
constexpr int kBwdCols = 10;    // most output columns of a backward tile
constexpr int kStripRows = 16;  // most rows of a strip
constexpr int kBwdThreads = kLanes * (kBwdCols + 2);
// threads the forward grid should hold: about eight blocks for each SM, so
// that small maps are cut into shorter strips (a thread's walk is a chain
// of row loads, each waiting on the last)
constexpr int kFwdThreadsWanted = 8 * kSmCount * kLanes * kFwdCols;

// V consecutive channels of one pixel
template <int V>
struct alignas(4 * V) Pack {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pack<V> zeros() {
  Pack<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = 0.f;
  return r;
}

// V consecutive elements of storage type T (fp32 or bf16) at p, widened to
// fp32; zeros when !ok. V = 4: one 16-byte (fp32) or 8-byte (bf16) load.
template <typename T, int V>
__device__ __forceinline__ Pack<V> load(const T* p, bool ok) {
  Pack<V> r = zeros<V>();
  if (ok) {
    if constexpr (std::is_same_v<T, float>) {
      if constexpr (V == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
      } else {
        r.v[0] = __ldg(p);
      }
    } else if constexpr (V == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&t.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&t.y));
      r.v[0] = lo.x, r.v[1] = lo.y, r.v[2] = hi.x, r.v[3] = hi.y;
    } else {
      r.v[0] = __bfloat162float(__ldg(p));
    }
  }
  return r;
}

// a stored as T at p (rounded to nearest even where T is bf16)
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<V>& a) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(p) =
          make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
    else
      *p = a.v[0];
  } else if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.v[0], a.v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a.v[2], a.v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&lo);
    t.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    *p = __float2bfloat16_rn(a.v[0]);
  }
}

// V consecutive elements of storage type T as loaded, not yet widened
// (bf16: two a word, the lower index in the lower half): the backward walk
// keeps its next row's loads so while it computes the current row, so that
// no widening waits on them early, and its bf16 window so, in half the
// registers
template <typename T, int V>
struct Raw {
  Pack<V> p;  // fp32: the values themselves
};
template <int V>
struct Raw<__nv_bfloat16, V> {
  uint32_t w[(V + 1) / 2];
};

// V consecutive elements of T at p, as they lie; zeros when !ok (one 16-byte
// (fp32) or 8-byte (bf16) load for V = 4)
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p, bool ok) {
  if constexpr (std::is_same_v<T, float>) {
    return Raw<T, V>{load<T, V>(p, ok)};
  } else {
    Raw<T, V> r;
#pragma unroll
    for (int j = 0; j < (V + 1) / 2; ++j) r.w[j] = 0u;
    if (ok) {
      if constexpr (V == 4) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
        r.w[0] = t.x, r.w[1] = t.y;
      } else {
        r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
      }
    }
    return r;
  }
}

// the values of a raw load in fp32 (bf16 widened exactly)
template <typename T, int V>
__device__ __forceinline__ Pack<V> widen(const Raw<T, V>& r) {
  if constexpr (std::is_same_v<T, float>) {
    return r.p;
  } else {
    Pack<V> a;
#pragma unroll
    for (int j = 0; j < V; ++j)
      a.v[j] = __uint_as_float(j % 2 ? r.w[j / 2] & 0xffff0000u
                                     : r.w[j / 2] << 16);
    return a;
  }
}

// acc += a * b
template <int V>
__device__ __forceinline__ void fma_to(Pack<V>& acc, const Pack<V>& a,
                                       const Pack<V>& b) {
#pragma unroll
  for (int j = 0; j < V; ++j) acc.v[j] = fmaf(a.v[j], b.v[j], acc.v[j]);
}

// acc += w[0] * a + w[1] * b + w[2] * c
template <int V>
__device__ __forceinline__ void tap_row(Pack<V>& acc, const Pack<V>* w,
                                        const Pack<V>& a, const Pack<V>& b,
                                        const Pack<V>& c) {
  fma_to(acc, w[0], a);
  fma_to(acc, w[1], b);
  fma_to(acc, w[2], c);
}

// How the images are cut: groups of kLanes channel vectors, column tiles and
// row strips.
struct Tiling {
  int B, H, W, F;
  int groups;  // channel groups
  int cols, col_tiles;
  int rows, strips;
  __host__ __device__ int tiles() const { return B * strips * col_tiles; }
};

inline Tiling tiling(int B, int H, int W, int F, int V, int max_cols) {
  Tiling t{B, H, W, F};
  t.groups = ceil_div(F / V, kLanes);
  t.col_tiles = ceil_div(W, max_cols);
  t.cols = ceil_div(W, t.col_tiles);
  t.strips = ceil_div(H, kStripRows);
  t.rows = ceil_div(H, t.strips);
  return t;
}

inline Tiling fwd_tiling(int B, int H, int W, int F, int V) {
  Tiling t = tiling(B, H, W, F, V, kFwdCols);
  const long long per_strip =
      (long long)B * t.groups * t.col_tiles * t.cols * kLanes;
  const int want =
      (int)min((long long)H, (kFwdThreadsWanted + per_strip - 1) / per_strip);
  if (want > t.strips) {
    t.rows = ceil_div(H, want);
    t.strips = ceil_div(H, t.rows);
  }
  return t;
}

// Persistent backward blocks of one channel group: about one block an SM
// over all groups, the group's tiles evened out over them.
inline int bwd_blocks_per_group(const Tiling& t) {
  const int want = max(1, kSmCount / t.groups);
  return ceil_div(t.tiles(), ceil_div(t.tiles(), want));
}

// whether p may be read as vectors of four T
template <typename T>
inline bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// an image's elements must have 32-bit offsets
inline bool fits(int H, int W, int F) {
  return (long long)H * W * F < (1LL << 31);
}

template <typename T, int V>
__global__ void __launch_bounds__(kLanes* kFwdCols)
dwconv_gelu_fwd_kernel(const T* __restrict__ u, const T* __restrict__ wdw,
                       const float* __restrict__ bdw, T* __restrict__ out,
                       Tiling t) {
  const int lane = threadIdx.x % kLanes;
  const int group = blockIdx.x / t.col_tiles;
  const int x = (blockIdx.x - group * t.col_tiles) * t.cols +
                (int)threadIdx.x / kLanes;
  const int c = (group * kLanes + lane) * V;  // first channel
  if (c >= t.F || x >= t.W) return;
  const int y0 = blockIdx.y * t.rows, y1 = min(t.H, y0 + t.rows);
  const long long image = (long long)blockIdx.z * t.H * t.W * t.F;
  const T* src = u + image + c;
  T* dst = out + image + c;
  Pack<V> w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = load<T, V>(wdw + k * t.F + c, true);
  const Pack<V> bias = load<float, V>(bdw + c, true);
  const bool left = x > 0, right = x + 1 < t.W;
  // input row r's three columns, loaded one row ahead (zeros off the image)
  Pack<V> nl, nm, nr;
  auto fetch = [&](int r) {
    const bool ok = r >= 0 && r < t.H;
    const T* p = src + (r * t.W + x) * t.F;
    nl = load<T, V>(p - t.F, ok && left);
    nm = load<T, V>(p, ok);
    nr = load<T, V>(p + t.F, ok && right);
  };
  // running sums of output rows r - 1, r and r + 1
  Pack<V> a0 = zeros<V>(), a1 = zeros<V>(), a2 = zeros<V>();
  fetch(y0 - 1);
#pragma unroll 3
  for (int r = y0 - 1; r <= y1; ++r) {
    const Pack<V> l = nl, m = nm, rt = nr;
    if (r < y1) fetch(r + 1);
    tap_row(a2, w, l, m, rt);
    tap_row(a1, w + 3, l, m, rt);
    tap_row(a0, w + 6, l, m, rt);
    if (r - 1 >= y0) {
      Pack<V> y;
#pragma unroll
      for (int j = 0; j < V; ++j) y.v[j] = gelu_exact(a0.v[j] + bias.v[j]);
      store(dst + ((r - 1) * t.W + x) * t.F, y);
    }
    a0 = a1;
    a1 = a2;
    a2 = zeros<V>();
  }
}

// the eight fp32 values of eight bf16 as loaded (the lower index in the
// lower half of each word), widened exactly
__device__ __forceinline__ Pack<8> widen8(const uint4& r) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  Pack<8> a;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a.v[j] = __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
  return a;
}

// The bf16 forward, staged: a block is one channel group of 256 channels
// (eight a lane, one 16-byte copy) by up to kStagedCols columns (one warp
// each) by a strip of rows. Input rows go through a ring of kStagedRing
// rows in shared memory, each the block's columns plus a one-column halo,
// copied by cp.async (zeros off the image), so each element of u is copied
// once a strip and the three columns a warp reads come from shared memory;
// kStagedRing - 1 rows are in flight while a row is summed. The sums are the
// walk's, in its order (each output's running sum takes input rows top to
// bottom, each row's columns left, middle, right, then the bias, then
// gelu_exact), so the output has the bits of dwconv_gelu_fwd_kernel.
constexpr int kStagedCols = 8;
constexpr int kStagedRing = 4;
constexpr int kStagedChannels = kLanes * 8;

__global__ void __launch_bounds__(kLanes* kStagedCols, 2)
dwconv_gelu_fwd_staged_kernel(const __nv_bfloat16* __restrict__ u,
                              const __nv_bfloat16* __restrict__ wdw,
                              const float* __restrict__ bdw,
                              __nv_bfloat16* __restrict__ out, Tiling t) {
  __shared__ uint4 ring[kStagedRing][kStagedCols + 2][kLanes];
  __shared__ Pack<8> bias_s[kLanes];
  const int lane = threadIdx.x % kLanes, wi = threadIdx.x / kLanes;
  const int group = blockIdx.x / t.col_tiles;
  const int x0 = (blockIdx.x - group * t.col_tiles) * t.cols;
  const int x = x0 + wi;
  const int c = group * kStagedChannels + lane * 8;  // first channel
  const bool chan = c < t.F;
  const int y0 = blockIdx.y * t.rows, y1 = min(t.H, y0 + t.rows);
  const int n_in = y1 - y0 + 2;  // input rows y0 - 1 .. y1
  const long long image = (long long)blockIdx.z * t.H * t.W * t.F;
  const __nv_bfloat16* src = u + image + c;
  for (int i = threadIdx.x; i < kStagedChannels; i += blockDim.x)
    bias_s[i / 8].v[i % 8] = group * kStagedChannels + i < t.F
                                 ? bdw[group * kStagedChannels + i]
                                 : 0.f;
  Pack<8> w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    w[k] = chan ? widen8(__ldg(reinterpret_cast<const uint4*>(wdw + k * t.F +
                                                              c)))
                : zeros<8>();
  // ring column j holds image column x0 - 1 + j: each warp copies its own,
  // warp 0 the left halo and warp min(1, cols - 1) the right one (zeros off
  // the image); each copy's source walks down its column a row an issue
  const long long row_step = (long long)t.W * t.F;
  const int right = min(1, t.cols - 1);
  const bool own_ok = chan && x < t.W;
  const bool left_ok = chan && x0 > 0;
  const bool right_ok = chan && x0 + t.cols < t.W;
  const __nv_bfloat16* p_own = src + ((long long)(y0 - 1) * t.W + x) * t.F;
  const __nv_bfloat16* p_left = p_own - (long long)(wi + 1) * t.F;
  const __nv_bfloat16* p_right = p_own + (long long)(t.cols - wi) * t.F;
  int r = y0 - 1, slot = 0;  // the row the next issue copies, its slot
  auto issue = [&]() {
    if (r <= y1) {
      const bool in = r >= 0 && r < t.H;
      cp_async<16>(&ring[slot][wi + 1][lane], in && own_ok ? p_own : u,
                   in && own_ok);
      if (wi == 0)
        cp_async<16>(&ring[slot][0][lane], in && left_ok ? p_left : u,
                     in && left_ok);
      if (wi == right)
        cp_async<16>(&ring[slot][t.cols + 1][lane],
                     in && right_ok ? p_right : u, in && right_ok);
    }
    cp_async_commit();
    ++r;
    slot = slot + 1 == kStagedRing ? 0 : slot + 1;
    p_own += row_step;
    p_left += row_step;
    p_right += row_step;
  };
#pragma unroll
  for (int i = 0; i < kStagedRing - 1; ++i) issue();
  // running sums of output rows r - 1, r and r + 1 at input row r
  Pack<8> a0 = zeros<8>(), a1 = zeros<8>(), a2 = zeros<8>();
  __nv_bfloat16* dst = out + image + c + ((long long)y0 * t.W + x) * t.F;
  for (int i = 0, read = 0; i < n_in; ++i) {
    // row i has landed (this thread's copies; the barrier: everyone's),
    // and every warp is done with row i - 1, whose slot takes row i + 3
    cp_async_wait<kStagedRing - 2>();
    __syncthreads();
    issue();
    const uint4* row = ring[read][wi];
    read = read + 1 == kStagedRing ? 0 : read + 1;
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // left, middle, right
      const Pack<8> v = widen8(row[j * kLanes + lane]);
      fma_to(a2, w[j], v);
      fma_to(a1, w[3 + j], v);
      fma_to(a0, w[6 + j], v);
    }
    if (i >= 2) {  // output row y0 + i - 2 is whole
      if (own_ok) {
        const Pack<8> bias = bias_s[lane];
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              gelu_exact(a0.v[2 * j] + bias.v[2 * j]),
              gelu_exact(a0.v[2 * j + 1] + bias.v[2 * j + 1]));
          o[j] = *reinterpret_cast<const uint32_t*>(&p);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
      }
      dst += row_step;
    }
    a0 = a1;
    a1 = a2;
    a2 = zeros<8>();
  }
}

// One block: the tiles p, p + blocks, ... of channel group blockIdx.x /
// blocks; warp i is column (tile's first) + i - 1 (warps 0 and cols + 1 are
// the halo). part[p][k][F]: tap k's sum (k < 9) and the bias sum (k = 9)
// over the block's tiles.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, 1)
dwconv_gelu_bwd_kernel(const T* __restrict__ u, const T* __restrict__ wdw,
                       const float* __restrict__ bdw, const T* __restrict__ g,
                       T* __restrict__ gu, float* __restrict__ part, Tiling t,
                       int blocks) {
  // gd of the current row, one Pack per (warp, lane), double-buffered
  __shared__ Pack<V> row_gd[2][kBwdCols + 2][kLanes];
  const int lane = threadIdx.x % kLanes, wi = threadIdx.x / kLanes;
  const int group = blockIdx.x / blocks, p = blockIdx.x - group * blocks;
  const int c = (group * kLanes + lane) * V;
  const bool chan = c < t.F;
  const bool inner = wi >= 1 && wi <= t.cols;
  Pack<V> w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = load<T, V>(wdw + k * t.F + c, chan);
  const Pack<V> bias = load<float, V>(bdw + c, chan);
  Pack<V> acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = zeros<V>();
  const bool want_params = part != nullptr;
  int buf = 0;
  for (int tile = p; tile < t.tiles(); tile += blocks) {
    const int ct = tile % t.col_tiles;
    const int s = (tile / t.col_tiles) % t.strips;
    const int b = tile / (t.col_tiles * t.strips);
    const int x = ct * t.cols + wi - 1;
    const int y0 = s * t.rows, y1 = min(t.H, y0 + t.rows);
    const bool xin = chan && x >= 0 && x < t.W;
    const bool mine = inner && xin;  // an output pixel column of this tile
    const bool left = xin && x > 0, right = xin && x + 1 < t.W;
    const long long image = (long long)b * t.H * t.W * t.F;
    const T* su = u + image + c;
    const T* sg = g + image + c;
    // win[3 * i + j] = u(r - 1 + i, x - 1 + j) at step r, and the next
    // row's loads (u's three columns, g), kept as loaded and widened where
    // they are used
    Raw<T, V> win[9], nl, nm, nr, gn;
    auto fetch = [&](int r) {
      const bool ok = r >= 0 && r < t.H;
      const T* q = su + (r * t.W + x) * t.F;
      nl = load_raw<T, V>(q - t.F, ok && left);
      nm = load_raw<T, V>(q, ok && xin);
      nr = load_raw<T, V>(q + t.F, ok && right);
    };
    auto fetch_g = [&](int r) {
      gn = load_raw<T, V>(sg + (r * t.W + x) * t.F,
                          r >= 0 && r < t.H && xin);
    };
    fetch(y0 - 2);
    win[3] = nl, win[4] = nm, win[5] = nr;
    fetch(y0 - 1);
    win[6] = nl, win[7] = nm, win[8] = nr;
    fetch(y0);
    fetch_g(y0 - 1);
    // running sums of gu rows r - 1, r and r + 1
    Pack<V> g0 = zeros<V>(), g1 = zeros<V>(), g2 = zeros<V>();
    // (unrolled, the window's and the sums' shifts are renamings)
#pragma unroll 4
    for (int r = y0 - 1; r <= y1; ++r) {
#pragma unroll
      for (int k = 0; k < 6; ++k) win[k] = win[k + 3];
      win[6] = nl, win[7] = nm, win[8] = nr;
      const Pack<V> gv = widen(gn);
      if (r < y1) {
        fetch(r + 2);
        fetch_g(r + 1);
      }
      Pack<V> gd = zeros<V>();
      if (xin && r >= 0 && r < t.H) {
        Pack<V> pre = bias;
#pragma unroll
        for (int k = 0; k < 9; ++k) fma_to(pre, w[k], widen(win[k]));
#pragma unroll
        for (int j = 0; j < V; ++j) gd.v[j] = gv.v[j] * gelu_grad(pre.v[j]);
      }
      if (want_params && mine && r >= y0 && r < y1) {
#pragma unroll
        for (int k = 0; k < 9; ++k) fma_to(acc[k], widen(win[k]), gd);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[9].v[j] += gd.v[j];
      }
      if (gu) {
        row_gd[buf][wi][lane] = gd;
        __syncthreads();
        if (inner) {
          const Pack<V> gl = row_gd[buf][wi - 1][lane];
          const Pack<V> gr = row_gd[buf][wi + 1][lane];
          // gd(r, x + 1 - j) meets tap column j
          tap_row(g0, w, gr, gd, gl);
          tap_row(g1, w + 3, gr, gd, gl);
          tap_row(g2, w + 6, gr, gd, gl);
          if (mine && r - 1 >= y0)
            store(gu + image + c + ((r - 1) * t.W + x) * t.F, g0);
        }
        g0 = g1;
        g1 = g2;
        g2 = zeros<V>();
        buf ^= 1;
      }
    }
  }
  if (!want_params) return;
  // the block's sums over its warps, in order, one column k at a time
  for (int k = 0; k < 10; ++k) {
    __syncthreads();
    row_gd[0][wi][lane] = acc[k];
    __syncthreads();
    if (wi == 0 && chan) {
      Pack<V> sum = zeros<V>();
      for (int i = 1; i <= t.cols; ++i) {
        const Pack<V> v = row_gd[0][i][lane];
#pragma unroll
        for (int j = 0; j < V; ++j) sum.v[j] += v.v[j];
      }
      store<float, V>(part + ((long long)p * 10 + k) * t.F + c, sum);
    }
  }
}

// gwdw[k, f] (k < 9) and gbdw[f] (k = 9) = sum over the blocks' partials:
// thread row i adds partials i, i + 8, ... in order, then row 0 adds the 8
// runs in order. gwdw is stored as TW (the taps' type: a bf16 tap grad is
// rounded here), gbdw in fp32.
template <typename TW>
__global__ void __launch_bounds__(256)
dwconv_param_final_kernel(const float* __restrict__ part, int blocks, int F,
                          TW* gwdw, float* gbdw) {
  __shared__ float red[8][kLanes];
  const int idx = blockIdx.x * kLanes + threadIdx.x;
  float t = 0.f;
  if (idx < 10 * F)
    for (int j = threadIdx.y; j < blocks; j += 8)
      t += part[(long long)j * 10 * F + idx];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y != 0 || idx >= 10 * F) return;
  t = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) t += red[i][threadIdx.x];
  if (idx < 9 * F) {
    if (gwdw) store<TW, 1>(gwdw + idx, Pack<1>{{t}});
  } else if (gbdw) {
    gbdw[idx - 9 * F] = t;
  }
}

template <typename T, int V>
void fwd_launch(const T* u, const T* wdw, const float* bdw, T* out, int B,
                int H, int W, int F, cudaStream_t s) {
  const Tiling t = fwd_tiling(B, H, W, F, V);
  dwconv_gelu_fwd_kernel<T, V>
      <<<dim3(t.groups * t.col_tiles, t.strips, B), kLanes * t.cols, 0, s>>>(
          u, wdw, bdw, out, t);
}

// the staged bf16 forward's cut: the strips whose grid takes the fewest
// row steps, a block's steps being its rows and two halo rows and the grid
// running in waves of two blocks an SM (the fewest strips among equals)
inline Tiling staged_tiling(int B, int H, int W, int F) {
  Tiling t = tiling(B, H, W, F, 8, kStagedCols);
  const long long per_strip = (long long)B * t.groups * t.col_tiles;
  long long best = -1;
  for (int s = 1; s <= H; ++s) {
    const int rows = ceil_div(H, s);
    if (ceil_div(H, rows) != s) continue;  // the same cut as fewer strips
    const long long steps =
        (per_strip * s + 2 * kSmCount - 1) / (2 * kSmCount) * (rows + 2);
    if (best < 0 || steps < best) {
      best = steps;
      t.rows = rows;
      t.strips = s;
    }
  }
  return t;
}

template <int V>
long long bwd_partial_floats(int B, int H, int W, int F) {
  const Tiling t = tiling(B, H, W, F, V, kBwdCols);
  return (long long)bwd_blocks_per_group(t) * 10 * F;
}

template <typename T, int V>
cudaError_t bwd_launch(const T* u, const T* wdw, const float* bdw, const T* g,
                       T* gu, T* gwdw, float* gbdw, float* ws,
                       long long ws_floats, int B, int H, int W, int F,
                       cudaStream_t s) {
  const Tiling t = tiling(B, H, W, F, V, kBwdCols);
  const int blocks = bwd_blocks_per_group(t);
  float* part = nullptr;
  if (gwdw || gbdw) {
    if (!ws || ws_floats < (long long)blocks * 10 * F)
      return cudaErrorInvalidValue;
    part = ws;
  }
  dwconv_gelu_bwd_kernel<T, V><<<t.groups * blocks, kLanes * (t.cols + 2),
                                 0, s>>>(u, wdw, bdw, g, gu, part, t,
                                         blocks);
  if (part)
    dwconv_param_final_kernel<T><<<ceil_div(10LL * F, kLanes),
                                   dim3(kLanes, 8), 0, s>>>(part, blocks, F,
                                                            gwdw, gbdw);
  return cudaGetLastError();
}

// the forward on storage type T: float4 / 8-byte walks where F and every
// pointer allow them, else the scalar instantiation
template <typename T>
int fwd(const T* u, const T* wdw, const float* bdw, T* out, int B, int H,
        int W, int F, void* stream) {
  if (!fits(H, W, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // eight bf16 a lane: 16-byte copies
    if (F % 8 == 0 && aligned4<float>(u) && aligned4<float>(wdw) &&
        aligned4<float>(out)) {
      const Tiling t = staged_tiling(B, H, W, F);
      dwconv_gelu_fwd_staged_kernel<<<
          dim3(t.groups * t.col_tiles, t.strips, B), kLanes * t.cols, 0, s>>>(
          u, wdw, bdw, out, t);
      return (int)cudaGetLastError();
    }
  }
  if (F % 4 == 0 && aligned4<T>(u) && aligned4<T>(wdw) &&
      aligned4<float>(bdw) && aligned4<T>(out))
    fwd_launch<T, 4>(u, wdw, bdw, out, B, H, W, F, s);
  else
    fwd_launch<T, 1>(u, wdw, bdw, out, B, H, W, F, s);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const T* u, const T* wdw, const float* bdw, const T* g, T* gu,
        T* gwdw, float* gbdw, float* ws, long long ws_floats, int B, int H,
        int W, int F, void* stream) {
  if (!fits(H, W, F)) return (int)cudaErrorInvalidValue;
  if (!gu && !gwdw && !gbdw) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && aligned4<T>(u) && aligned4<T>(wdw) &&
                   aligned4<float>(bdw) && aligned4<T>(g) && aligned4<T>(gu);
  return (int)(vec ? bwd_launch<T, 4>(u, wdw, bdw, g, gu, gwdw, gbdw, ws,
                                      ws_floats, B, H, W, F, s)
                   : bwd_launch<T, 1>(u, wdw, bdw, g, gu, gwdw, gbdw, ws,
                                      ws_floats, B, H, W, F, s));
}

}  // namespace
}  // namespace emip

// (the bf16 entry points spell __nv_bfloat16: nvcc's host stubs do not
// resolve an alias declared in an unnamed namespace)
extern "C" int emip_dwconv_gelu(const float* u, const float* wdw,
                                const float* bdw, float* out, int B, int H,
                                int W, int F, void* stream) {
  return emip::fwd(u, wdw, bdw, out, B, H, W, F, stream);
}

// The bf16 forward: u, wdw and out bf16, bdw fp32.
extern "C" int emip_dwconv_gelu_bf16(const void* u, const void* wdw,
                                     const float* bdw, void* out, int B,
                                     int H, int W, int F, void* stream) {
  return emip::fwd(static_cast<const __nv_bfloat16*>(u),
                   static_cast<const __nv_bfloat16*>(wdw), bdw,
                   static_cast<__nv_bfloat16*>(out), B, H, W, F, stream);
}

// Floats of the tap-grad partials emip_dwconv_gelu_bwd(_bf16) takes when a
// parameter grad is asked for, at the larger of its two vector widths.
extern "C" long long emip_dwconv_gelu_bwd_workspace(int B, int H, int W,
                                                    int F) {
  using namespace emip;
  const long long scalar = bwd_partial_floats<1>(B, H, W, F);
  return F % 4 ? scalar : max(scalar, bwd_partial_floats<4>(B, H, W, F));
}

// g: gradient of out. gu [B, H*W, F], gwdw [3, 3, F] and gbdw [F] may each
// be null. ws: emip_dwconv_gelu_bwd_workspace floats when a parameter grad
// is asked for, else unused.
extern "C" int emip_dwconv_gelu_bwd(const float* u, const float* wdw,
                                    const float* bdw, const float* g,
                                    float* gu, float* gwdw, float* gbdw,
                                    float* ws, long long ws_floats, int B,
                                    int H, int W, int F, void* stream) {
  return emip::bwd(u, wdw, bdw, g, gu, gwdw, gbdw, ws, ws_floats, B, H, W, F,
                   stream);
}

// The bf16 backward: u, wdw, g, gu and gwdw bf16, bdw and gbdw fp32.
extern "C" int emip_dwconv_gelu_bwd_bf16(const void* u, const void* wdw,
                                         const float* bdw, const void* g,
                                         void* gu, void* gwdw, float* gbdw,
                                         float* ws, long long ws_floats,
                                         int B, int H, int W, int F,
                                         void* stream) {
  return emip::bwd(static_cast<const __nv_bfloat16*>(u),
                   static_cast<const __nv_bfloat16*>(wdw), bdw,
                   static_cast<const __nv_bfloat16*>(g),
                   static_cast<__nv_bfloat16*>(gu),
                   static_cast<__nv_bfloat16*>(gwdw), gbdw, ws, ws_floats, B,
                   H, W, F, stream);
}
