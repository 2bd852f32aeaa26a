// Kernel D: RAFT convex x K flow upsampling, forward.
//
// Replaces emip_tpu/ops/pallas/convex_upsample.py:convex_upsample_pallas
// (_kernel). flow [B, h, w, 2], mask logits [B, h, w, 9*K*K] with channels
// ordered (n, ky, kx) -> out [B, h*K, w*K, 2]:
//   out[b, hy*K+ky, wx*K+kx] = sum_n softmax_n(mask[b, hy, wx, n, ky, kx])
//                              * K * flow[b, hy+dy_n-1, wx+dx_n-1]
// with the 3x3 neighbourhood zero-padded at the border.
//
// What bounds it on the card: bytes. It does ~30 FLOP per output value
// and reads 9 logits for it: about 71 MB of fp32 logits at B = 16,
// 44 x 44, K = 8. One thread per output pixel writes [B, hK, wK, 2]
// directly in its final layout, so the TPU kernel's (hy, ky) / (wx, kx)
// interleave transpose does not exist here; neighbouring threads read
// neighbouring kx logits, so the loads coalesce.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void convex_upsample_kernel(const float* __restrict__ flow,
                                       const float* __restrict__ mask,
                                       float* __restrict__ out, int B, int h,
                                       int w, int K) {
  const long long total = (long long)B * h * K * w * K;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int W = w * K, H = h * K;
  const int X = (int)(idx % W);
  const int Y = (int)((idx / W) % H);
  const int b = (int)(idx / ((long long)W * H));
  const int hy = Y / K, ky = Y % K, wx = X / K, kx = X % K;
  const int KK = K * K;
  const float* lg =
      mask + (((long long)b * h + hy) * w + wx) * 9 * KK + ky * K + kx;
  float l[9];
  float mx = -INFINITY;
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    l[n] = lg[n * KK];
    mx = fmaxf(mx, l[n]);
  }
  float sum = 0.f, ox = 0.f, oy = 0.f;
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    const float e = expf(l[n] - mx);
    sum += e;
    const int yy = hy + n / 3 - 1, xx = wx + n % 3 - 1;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      const float* f = flow + (((long long)b * h + yy) * w + xx) * 2;
      ox = fmaf(e, f[0] * K, ox);
      oy = fmaf(e, f[1] * K, oy);
    }
  }
  out[idx * 2] = ox / sum;
  out[idx * 2 + 1] = oy / sum;
}

}  // namespace

extern "C" int emip_convex_upsample(const float* flow, const float* mask,
                                    float* out, int B, int h, int w, int K,
                                    void* stream) {
  const long long total = (long long)B * h * K * w * K;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  convex_upsample_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      flow, mask, out, B, h, w, K);
  return (int)cudaGetLastError();
}
