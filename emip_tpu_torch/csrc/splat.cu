// Kernel E: forward bilinear splat density.
//
// Replaces emip_tpu/ops/pallas/splat.py:splat_density_pallas (_kernel).
// coords [N, H, W, 2] of (x, y) targets -> density [N, H, W]:
//   density[n, i, j] = sum_q max(0, 1 - |y_q - i|) * max(0, 1 - |x_q - j|)
// i.e. every source pixel q adds a unit mass, split bilinearly over the
// four integer corners around its target; corners outside the image and
// sources with a non-finite coordinate are dropped (reference
// loss/warp_utils.py:26-80). The gradient is torch ops in the wrapper.
//
// What bounds it on the card: bytes (coords read once, 8 bytes a pixel, and
// the density written once, 4) and, in the way of that, the scatter: four
// adds per source pixel (4M at [8, 352, 352]) into cells that neighbouring
// sources share. The TPU kernel turned the scatter into a hat-weight matmul
// because TPU scatters are slow; here it stays a scatter.
//
// Order-independent sum. Each corner weight w (in [0, 1]; a product of two
// fp32 hat weights, as the plain version forms it) is rounded to a multiple
// of 2^-32 and added as an unsigned 64-bit integer. Integer addition is
// associative, so the atomics may land in any order and the density has the
// same bits on every call. A cell receives at most one unit from each source
// (2^18 sources at 512^2), so its sum stays under 2^51. A last pass
// converts each cell once: density = fp32(sum) * 2^-32, one rounding. Error
// against the exact sum of the fp32 weights: at most 2^-33 per weight added
// (2.3e-10 in the 9-odd weights a cell usually gets) plus half an fp32 ulp
// of the result, the rounding that any fp32 sum has at its end.
//
// Privatized local part. A block owns a tile of kTileW x kTileH source
// pixels. Flow is locally coherent, so the tile's targets land near the
// tile moved by its mean displacement: the block first takes that mean
// over its finite sources (one block reduction), keeps a window of (kTileW
// + 2 kHalo + 1) x (kTileH + 2 kHalo + 1) cells there in shared memory and
// adds the corners that land in it with shared-memory atomics; corners of
// a source displaced more than about kHalo px from the mean go straight to
// the global accumulator. A window cell holds its sum as two 32-bit halves
// (the weights' high and low 16 bits, each sum under 2^27 for the tile's
// 1024 sources): 32-bit shared atomics are native, a 64-bit shared add is a
// compare-and-swap loop on this card. At the end the block adds its
// window's non-zero cells inside the image to global as 64-bit sums: about
// one global atomic per target cell, against four per source. A corner of
// weight under 2^-33 rounds to 0 and is skipped. Where the window sits
// changes which adds are local, never the sum.
//
// The accumulator is zeroed by a memset ahead of the splat, in a workspace
// the wrapper allocates with the call: no state survives a call. (Zeroing
// it in the conversion pass instead, for the next call, measured slower.)
// Device time at [8, 352, 352] is about 3 us of memset, 4 us of
// conversion and 13-15 us of splat: the 64-bit accumulator's own traffic
// is a third of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;   // source columns of a block, one per lane
constexpr int kTileH = 32;   // source rows of a block
constexpr int kRowsPerPass = 8;  // warps of a block
constexpr int kThreads = 32 * kRowsPerPass;
constexpr int kHalo = 4;     // px of displacement beyond the mean's
constexpr int kWinW = kTileW + 2 * kHalo + 1;
constexpr int kWinH = kTileH + 2 * kHalo + 1;
constexpr float kFix = 4294967296.0f;         // 2^32
constexpr float kUnfix = 2.3283064365386963e-10f;  // 2^-32

// A coordinate clamped to [-2, size + 1]: every corner that can land in
// the image survives, and the float -> int conversion of its floor stays in
// range.
__device__ __forceinline__ float clamp_coord(float v, int size) {
  return fminf(fmaxf(v, -2.f), (float)size + 1.f);
}

constexpr int kPixels = kTileH / kRowsPerPass;  // source pixels a thread

// The weight w in [0, 1] as a multiple of 2^-32, rounded to nearest, split
// into its high and low 16 bits: u = hi 2^16 + lo with hi <= 2^16.
__device__ __forceinline__ void fix_split(float w, unsigned& hi,
                                          unsigned& lo) {
  if (w >= 1.f) {  // 2^32 needs 33 bits
    hi = 1u << 16;
    lo = 0u;
    return;
  }
  const unsigned u = __float2uint_rn(w * kFix);  // < 2^32: w < 1
  hi = u >> 16;
  lo = u & 0xffffu;
}

__global__ void __launch_bounds__(kThreads)
splat_density_kernel(const float2* __restrict__ coords,
                     unsigned long long* __restrict__ acc, int H, int W,
                     int tiles_x, int tiles_y) {
  // the window's high and low halves: a cell gets at most one corner of
  // each of the block's 1024 sources, so either stays under 2^27
  __shared__ unsigned win_hi[kWinH * kWinW], win_lo[kWinH * kWinW];
  __shared__ float3 red[kRowsPerPass];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x % (tiles_x * tiles_y);
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int tx0 = (tile % tiles_x) * kTileW, ty0 = (tile / tiles_x) * kTileH;
  const long long hw = (long long)H * W;
  const float2* c = coords + n * hw;
  unsigned long long* a = acc + n * hw;

  // this thread's sources (column tx0 + lane, rows warp, warp + 8, ...),
  // clamped; ok is false where there is none or it is not finite
  const int col = tx0 + lane;
  float xs[kPixels], ys[kPixels];
  bool ok[kPixels];
  float3 sum = make_float3(0.f, 0.f, 0.f);  // displacement x, y; count
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int row = ty0 + warp + k * kRowsPerPass;
    ok[k] = false;
    xs[k] = ys[k] = 0.f;
    if (row >= H || col >= W) continue;
    const float2 p = c[(long long)row * W + col];
    if (!isfinite(p.x) || !isfinite(p.y)) continue;
    ok[k] = true;
    xs[k] = clamp_coord(p.x, W);
    ys[k] = clamp_coord(p.y, H);
    sum.x += xs[k] - col;
    sum.y += ys[k] - row;
    sum.z += 1.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum.x += __shfl_xor_sync(0xffffffffu, sum.x, o);
    sum.y += __shfl_xor_sync(0xffffffffu, sum.y, o);
    sum.z += __shfl_xor_sync(0xffffffffu, sum.z, o);
  }
  if (lane == 0) red[warp] = sum;
  for (int i = tid; i < kWinH * kWinW; i += kThreads)
    win_hi[i] = win_lo[i] = 0u;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < kRowsPerPass; ++w)
    sum.x += red[w].x, sum.y += red[w].y, sum.z += red[w].z;
  // the window's first cell: the tile moved by its mean displacement
  const int ox = tx0 - kHalo +
                 (sum.z > 0.f ? (int)floorf(sum.x / sum.z) : 0);
  const int oy = ty0 - kHalo +
                 (sum.z > 0.f ? (int)floorf(sum.y / sum.z) : 0);

#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    if (!ok[k]) continue;
    const float x0 = floorf(xs[k]), y0 = floorf(ys[k]);
    const float wx1 = xs[k] - x0, wy1 = ys[k] - y0;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
    const int ix = (int)x0, iy = (int)y0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dx = j & 1, dy = j >> 1;
      const int jx = ix + dx, jy = iy + dy;
      const float w = (dx ? wx1 : wx0) * (dy ? wy1 : wy0);
      if (jx < 0 || jx >= W || jy < 0 || jy >= H || w < 0x1p-33f) continue;
      unsigned hi, lo;
      fix_split(w, hi, lo);
      const int lx = jx - ox, ly = jy - oy;
      if (lx >= 0 && lx < kWinW && ly >= 0 && ly < kWinH) {
        atomicAdd(win_lo + ly * kWinW + lx, lo);
        if (hi) atomicAdd(win_hi + ly * kWinW + lx, hi);
      } else {
        atomicAdd(a + (long long)jy * W + jx,
                  ((unsigned long long)hi << 16) + lo);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kWinH * kWinW; i += kThreads) {
    const unsigned long long w =
        ((unsigned long long)win_hi[i] << 16) + win_lo[i];
    const int jx = ox + i % kWinW, jy = oy + i / kWinW;
    if (w != 0ull && jx >= 0 && jx < W && jy >= 0 && jy < H)
      atomicAdd(a + (long long)jy * W + jx, w);
  }
}

// density = acc * 2^-32, two cells a thread
__global__ void splat_convert_kernel(
    const unsigned long long* __restrict__ acc, float* __restrict__ density,
    long long total) {
  const long long i =
      2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i + 1 < total) {
    const ulonglong2 v = reinterpret_cast<const ulonglong2*>(acc)[i / 2];
    reinterpret_cast<float2*>(density)[i / 2] = make_float2(
        __ull2float_rn(v.x) * kUnfix, __ull2float_rn(v.y) * kUnfix);
  } else if (i < total) {
    density[i] = __ull2float_rn(acc[i]) * kUnfix;
  }
}

inline int ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

}  // namespace

// Floats of the 64-bit accumulator the splat needs at this shape.
extern "C" long long emip_splat_density_workspace(int N, int H, int W) {
  return 2LL * N * H * W;
}

// coords [N, H, W, 2] -> density [N, H, W]; ws: at least
// emip_splat_density_workspace floats, 16-byte aligned; coords and density
// 8-byte aligned.
extern "C" int emip_splat_density(const float* coords, float* density,
                                  float* ws, long long ws_floats, int N,
                                  int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * H * W;
  if (total == 0) return (int)cudaSuccess;
  if (ws_floats < emip_splat_density_workspace(N, H, W) ||
      (reinterpret_cast<uintptr_t>(ws) & 15) ||
      (reinterpret_cast<uintptr_t>(coords) & 7) ||
      (reinterpret_cast<uintptr_t>(density) & 7))
    return (int)cudaErrorInvalidValue;
  auto* acc = reinterpret_cast<unsigned long long*>(ws);
  cudaError_t err = cudaMemsetAsync(acc, 0, total * sizeof(*acc), s);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = ceil_div(W, kTileW), tiles_y = ceil_div(H, kTileH);
  splat_density_kernel<<<(unsigned)N * tiles_x * tiles_y, kThreads, 0, s>>>(
      reinterpret_cast<const float2*>(coords), acc, H, W, tiles_x, tiles_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  splat_convert_kernel<<<ceil_div(ceil_div(total, 2), threads), threads, 0,
                         s>>>(acc, density, total);
  return (int)cudaGetLastError();
}
