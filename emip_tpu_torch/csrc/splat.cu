// Kernel E: forward bilinear splat density.
//
// Replaces emip_tpu/ops/pallas/splat.py:splat_density_pallas (_kernel).
// coords [N, H, W, 2] of (x, y) targets -> density [N, H, W]:
//   density[n, i, j] = sum_q max(0, 1 - |y_q - i|) * max(0, 1 - |x_q - j|)
// i.e. every source pixel q adds a unit mass, split bilinearly over the
// four integer corners around its target; corners outside the image are
// dropped (reference loss/warp_utils.py:26-80).
//
// What bounds it on the card: memory traffic, about 20 bytes and four
// atomic adds per source pixel (1M pixels at [8, 352, 352]). The TPU kernel
// turned the scatter into a hat-weight matmul because TPU scatters are
// slow; the card has fast atomics on global memory, so this is the direct
// scatter: one thread per source pixel, atomicAdd into the four corners.
// The order of the atomics varies from run to run, so the density differs
// in its last bits between runs; its one consumer thresholds it at 0.2
// (the occlusion mask), where such a difference can flip a bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void splat_density_kernel(const float* __restrict__ coords,
                                     float* __restrict__ density, int N,
                                     int H, int W) {
  const long long hw = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * hw) return;
  const float x = coords[idx * 2], y = coords[idx * 2 + 1];
  if (!isfinite(x) || !isfinite(y)) return;
  // corners that cannot land in the image are dropped; clamping first keeps
  // the float -> int conversion in range
  const float x0 = floorf(fminf(fmaxf(x, -2.f), (float)W + 1.f));
  const float y0 = floorf(fminf(fmaxf(y, -2.f), (float)H + 1.f));
  const float wx1 = fminf(fmaxf(x, -2.f), (float)W + 1.f) - x0;
  const float wy1 = fminf(fmaxf(y, -2.f), (float)H + 1.f) - y0;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  const int ix = (int)x0, iy = (int)y0;
  float* d = density + (idx / hw) * hw;
  const int cx[4] = {ix, ix + 1, ix, ix + 1};
  const int cy[4] = {iy, iy, iy + 1, iy + 1};
  const float wt[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (cx[c] >= 0 && cx[c] < W && cy[c] >= 0 && cy[c] < H)
      atomicAdd(d + (long long)cy[c] * W + cx[c], wt[c]);
}

}  // namespace

extern "C" int emip_splat_density(const float* coords, float* density, int N,
                                  int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * H * W;
  cudaError_t err =
      cudaMemsetAsync(density, 0, total * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  splat_density_kernel<<<(unsigned)((total + threads - 1) / threads),
                         threads, 0, s>>>(coords, density, N, H, W);
  return (int)cudaGetLastError();
}
