// Kernel J: gelu_exact(dwconv3x3(u) + b) of the PVTv2 MixFFN on channel-last
// tokens, forward and backward.
//
// Replaces emip_tpu/ops/pallas/mixffn.py: fused_dwconv_gelu (_fwd_kernel)
// and the backward it shares with dwconv_gelu_bwd_fused (_bwd_kernel). u
// [B, H*W, F] is the fc1 output, wdw [3, 3, F] the depthwise taps, bdw [F];
// out has u's shape. Zero padding at the image border.
//
// What bounds it on the card: bytes. The forward reads the hidden once and
// writes it once (63 MB each way at [8, 7744, 256], stage 1 of pvt_v2_b5
// at 352^2) for 9 multiply-adds and one erf per element. One
// thread per (pixel, channel), channels fastest, so a warp reads 32
// neighbouring channels of each of the 9 neighbouring pixels (the 8
// re-reads hit the cache) and the 9 taps of its channels. The TPU kernel
// works on the flat token axis, where a column shift wraps around the row
// end and has to be masked off; here the pixel's (y, x) is computed and the
// border is a bounds check.
//
// Backward: gd = g * gelu'(d) with the pre-activation d recomputed from u
// (it is never stored), gu = the transposed taps applied to gd, and the tap
// and bias grads are sums over every pixel of u(shifted) * gd and gd. The
// TPU kernel does all of it per image in VMEM and accumulates the tap grads
// over a sequential grid. Here gd goes through the workspace once (gu
// needs gd at the 9 neighbours, each of which would otherwise recompute 9
// taps), then one pass writes gu and one pass sums the 10 per-channel
// columns over a run of pixels per block into ordered partials that a last
// pass adds: no atomics. Each of gu and the two parameter grads is skipped
// when its pointer is null.

#include "primitives.cuh"

namespace emip {
namespace {

constexpr int kDwThreads = 256;
constexpr int kDwMaxChunks = 256;  // pixel runs of the tap-grad partials

struct Image {
  int B, H, W, F;
  __host__ __device__ long long pixels() const {
    return (long long)B * H * W;
  }
};

// Sum over the 3x3 neighbourhood of pixel (y, x) of image img (a [H, W, F]
// base pointer) at channel f: src(y + sy*dy, x + sx*dx) * wdw[dy, dx, f].
// sign = +1: the convolution; sign = -1: its transpose (gu from gd).
template <int kSign>
__device__ __forceinline__ float taps(const float* __restrict__ img,
                                      const float* __restrict__ wdw, int y,
                                      int x, int f, Image d) {
  float acc = 0.f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + kSign * dy;
    if (yy < 0 || yy >= d.H) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + kSign * dx;
      if (xx < 0 || xx >= d.W) continue;
      acc = fmaf(img[((long long)yy * d.W + xx) * d.F + f],
                 wdw[((dy + 1) * 3 + dx + 1) * d.F + f], acc);
    }
  }
  return acc;
}

// kMode 0: out = gelu(conv(u) + b); 1: out = g * gelu'(conv(u) + b);
// 2: out = conv^T(u) (u is gd, no bias).
template <int kMode>
__global__ void __launch_bounds__(kDwThreads)
dwconv_kernel(const float* __restrict__ u, const float* __restrict__ wdw,
              const float* __restrict__ bdw, const float* __restrict__ g,
              float* __restrict__ out, Image d) {
  const long long idx = (long long)blockIdx.x * kDwThreads + threadIdx.x;
  if (idx >= d.pixels() * d.F) return;
  const int f = (int)(idx % d.F);
  const long long pix = idx / d.F;
  const int x = (int)(pix % d.W), y = (int)((pix / d.W) % d.H);
  const float* img = u + (pix / ((long long)d.W * d.H)) * d.H * d.W * d.F;
  if (kMode == 2) {
    out[idx] = taps<-1>(img, wdw, y, x, f, d);
    return;
  }
  const float pre = taps<1>(img, wdw, y, x, f, d) + bdw[f];
  out[idx] = kMode == 0 ? gelu_exact(pre) : g[idx] * gelu_grad(pre);
}

// part[chunk][k][f], k < 9: sum over the chunk's pixels of u(y + dy, x + dx,
// f) * gd(y, x, f) for tap k = (dy + 1) * 3 + dx + 1; k = 9: sum of gd.
__global__ void __launch_bounds__(256)
dwconv_param_partial_kernel(const float* __restrict__ u,
                            const float* __restrict__ gd, Image d,
                            long long pixels_per_chunk,
                            float* __restrict__ part) {
  __shared__ float red[8][10][33];
  const int f = blockIdx.x * 32 + threadIdx.x;
  const long long p0 = (long long)blockIdx.y * pixels_per_chunk;
  const long long p1 = min(d.pixels(), p0 + pixels_per_chunk);
  float acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0.f;
  if (f < d.F) {
    for (long long pix = p0 + threadIdx.y; pix < p1; pix += 8) {
      const int x = (int)(pix % d.W), y = (int)((pix / d.W) % d.H);
      const float* img = u + (pix / ((long long)d.W * d.H)) * d.H * d.W * d.F;
      const float gv = gd[pix * d.F + f];
      acc[9] += gv;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= d.H) continue;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= d.W) continue;
          acc[(dy + 1) * 3 + dx + 1] = fmaf(
              img[((long long)yy * d.W + xx) * d.F + f], gv,
              acc[(dy + 1) * 3 + dx + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) red[threadIdx.y][k][threadIdx.x] = acc[k];
  __syncthreads();
  if (f < d.F)
    for (int k = threadIdx.y; k < 10; k += 8) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) t += red[j][k][threadIdx.x];
      part[((long long)blockIdx.y * 10 + k) * d.F + f] = t;
    }
}

// gwdw[k, f] (k < 9) and gbdw[f] (k = 9) = sum over chunks, in order.
__global__ void dwconv_param_final_kernel(const float* __restrict__ part,
                                          int chunks, int F, float* gwdw,
                                          float* gbdw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 10 * F) return;
  float t = 0.f;
  for (int j = 0; j < chunks; ++j) t += part[(long long)j * 10 * F + idx];
  if (idx < 9 * F) {
    if (gwdw) gwdw[idx] = t;
  } else if (gbdw) {
    gbdw[idx - 9 * F] = t;
  }
}

}  // namespace
}  // namespace emip

extern "C" int emip_dwconv_gelu(const float* u, const float* wdw,
                                const float* bdw, float* out, int B, int H,
                                int W, int F, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Image d{B, H, W, F};
  dwconv_kernel<0><<<ceil_div(d.pixels() * F, kDwThreads), kDwThreads, 0,
                     s>>>(u, wdw, bdw, nullptr, out, d);
  return (int)cudaGetLastError();
}

// g: gradient of out. gu [B, H*W, F], gwdw [3, 3, F] and gbdw [F] may each
// be null. ws: B*H*W*F floats for gd, then kDwMaxChunks * 10 * F of
// partials when a parameter grad is asked for.
extern "C" int emip_dwconv_gelu_bwd(const float* u, const float* wdw,
                                    const float* bdw, const float* g,
                                    float* gu, float* gwdw, float* gbdw,
                                    float* ws, long long ws_floats, int B,
                                    int H, int W, int F, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Image d{B, H, W, F};
  const long long total = d.pixels() * F;
  Workspace w{ws, ws_floats};
  float* gd = w.take(total);
  if (!gd) return (int)cudaErrorInvalidValue;
  const int blocks = ceil_div(total, kDwThreads);
  dwconv_kernel<1><<<blocks, kDwThreads, 0, s>>>(u, wdw, bdw, g, gd, d);
  if (gu)
    dwconv_kernel<2><<<blocks, kDwThreads, 0, s>>>(gd, wdw, nullptr, nullptr,
                                                   gu, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (!gwdw && !gbdw)) return (int)err;
  int chunks = min(kDwMaxChunks, max(1, ceil_div(d.pixels(), 64)));
  const long long per = (d.pixels() + chunks - 1) / chunks;
  chunks = ceil_div(d.pixels(), per);
  float* part = w.take((long long)chunks * 10 * F);
  if (!part) return (int)cudaErrorInvalidValue;
  dwconv_param_partial_kernel<<<dim3(ceil_div(F, 32), chunks), dim3(32, 8), 0,
                                s>>>(u, gd, d, per, part);
  dwconv_param_final_kernel<<<ceil_div(10 * F, 256), 256, 0, s>>>(
      part, chunks, F, gwdw, gbdw);
  return (int)cudaGetLastError();
}
