// Kernel D: RAFT convex x K flow upsampling, forward and backward, each
// also with bf16 mask logits (the bf16 band: inference and the train step).
//
// Replaces emip_tpu/ops/pallas/convex_upsample.py:convex_upsample_pallas
// (_kernel, _bwd_kernel). flow [B, h, w, 2], mask logits [B, h, w, 9*K*K]
// with channels ordered (n, ky, kx) -> out [B, h*K, w*K, 2]:
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
//
// Backward, also bound by bytes (it reads the logits and writes their
// grad, 142 MB at the shapes above). With p_n the softmax weights:
//   d mask_n = p_n ((nb_n - out) . g)            per sub-pixel
//   d nb_n   = sum over the K*K sub-pixels of p_n g
//   d flow   = K * sum over the coarse pixels whose 3x3 window reads it
// One block per coarse pixel, one thread per sub-pixel, writes d mask in
// place and reduces d nb_n over its sub-pixels (warp shuffles, then shared
// memory); a second kernel gathers d flow from the 3x3 neighbours' d nb
// (border clamps as _neighbors_3x3), so every sum has a fixed order and
// no atomics are needed. With bf16 logits (the bf16 train step) the same
// kernel reads them as bf16, computes in fp32 and rounds d mask once to
// bf16 at its store, as the JAX kernel upcasts its logits and rounds its
// grad to their dtype; d flow stays fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// TM: the logits' storage type, fp32 or (the bf16 band) bf16; the logits
// are read in it and everything after the load is fp32, as the JAX kernel
// upcasts its logits slices.
template <typename TM>
__global__ void convex_upsample_kernel(const float* __restrict__ flow,
                                       const TM* __restrict__ mask,
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
  const TM* lg =
      mask + (((long long)b * h + hy) * w + wx) * 9 * KK + ky * K + kx;
  float l[9];
  float mx = -INFINITY;
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    l[n] = to_f32(lg[n * KK]);
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

// One block per coarse pixel (b, hy, wx); thread s = ky*K + kx. TM: the
// logits' and their grad's storage type, as in the forward.
template <typename TM>
__global__ void convex_upsample_bwd_kernel(const float* __restrict__ flow,
                                           const TM* __restrict__ mask,
                                           const float* __restrict__ g,
                                           TM* __restrict__ gmask,
                                           float* __restrict__ gnb, int h,
                                           int w, int K) {
  __shared__ float red[18][32];  // [(n, xy)][warp]
  const long long pix = blockIdx.x;
  const int wx = (int)(pix % w);
  const int hy = (int)((pix / w) % h);
  const long long b = pix / ((long long)w * h);
  const int KK = K * K;
  const int s = threadIdx.x;
  const bool active = s < KK;

  float nbx[9], nby[9];
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    const int yy = hy + n / 3 - 1, xx = wx + n % 3 - 1;
    nbx[n] = nby[n] = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      const float* f = flow + ((b * h + yy) * w + xx) * 2;
      nbx[n] = f[0] * K;
      nby[n] = f[1] * K;
    }
  }
  float p[9];
  float gx = 0.f, gy = 0.f;
#pragma unroll
  for (int n = 0; n < 9; ++n) p[n] = 0.f;
  if (active) {
    const TM* lg = mask + pix * 9 * KK + s;
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 9; ++n) {
      p[n] = to_f32(lg[n * KK]);
      mx = fmaxf(mx, p[n]);
    }
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 9; ++n) {
      p[n] = expf(p[n] - mx);
      sum += p[n];
    }
    float ox = 0.f, oy = 0.f;
#pragma unroll
    for (int n = 0; n < 9; ++n) {
      p[n] /= sum;
      ox = fmaf(p[n], nbx[n], ox);
      oy = fmaf(p[n], nby[n], oy);
    }
    const int ky = s / K, kx = s % K;
    const long long Y = (long long)hy * K + ky, X = (long long)wx * K + kx;
    const float* gp = g + ((b * h * K + Y) * w * K + X) * 2;
    gx = gp[0];
    gy = gp[1];
    TM* gm = gmask + pix * 9 * KK + s;
#pragma unroll
    for (int n = 0; n < 9; ++n)
      gm[n * KK] =
          from_f32<TM>(p[n] * ((nbx[n] - ox) * gx + (nby[n] - oy) * gy));
  }
  const int lane = s % 32, warp = s / 32;
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    float vx = p[n] * gx, vy = p[n] * gy;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      vx += __shfl_xor_sync(0xffffffffu, vx, o);
      vy += __shfl_xor_sync(0xffffffffu, vy, o);
    }
    if (lane == 0) {
      red[2 * n][warp] = vx;
      red[2 * n + 1][warp] = vy;
    }
  }
  __syncthreads();
  if (s < 18) {
    float t = 0.f;
    for (int j = 0; j < (int)(blockDim.x / 32); ++j) t += red[s][j];
    gnb[pix * 18 + s] = t;
  }
}

// d flow[b, y, x] = K * sum_n gnb[b, y - dy_n + 1, x - dx_n + 1, n].
__global__ void convex_upsample_gflow_kernel(const float* __restrict__ gnb,
                                             float* __restrict__ gflow,
                                             int B, int h, int w, int K) {
  const long long total = (long long)B * h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % w);
  const int y = (int)((idx / w) % h);
  const long long b = idx / ((long long)w * h);
  float gx = 0.f, gy = 0.f;
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    const int py = y - n / 3 + 1, px = x - n % 3 + 1;
    if (py >= 0 && py < h && px >= 0 && px < w) {
      const float* src = gnb + ((b * h + py) * w + px) * 18 + 2 * n;
      gx += src[0];
      gy += src[1];
    }
  }
  gflow[idx * 2] = gx * K;
  gflow[idx * 2 + 1] = gy * K;
}

template <typename TM>
int convex_upsample_bwd(const float* flow, const TM* mask, const float* g,
                        float* gflow, TM* gmask, float* gnb, int B, int h,
                        int w, int K, cudaStream_t s) {
  const int threads = ((K * K + 31) / 32) * 32;
  const unsigned pixels = (unsigned)((long long)B * h * w);
  convex_upsample_bwd_kernel<TM><<<pixels, threads, 0, s>>>(
      flow, mask, g, gmask, gnb, h, w, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  convex_upsample_gflow_kernel<<<(pixels + 255) / 256, 256, 0, s>>>(
      gnb, gflow, B, h, w, K);
  return (int)cudaGetLastError();
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

// The bf16 band: mask logits [B, h, w, 9*K*K] bf16, read as bf16 and
// computed in fp32; flow and out fp32 as above.
extern "C" int emip_convex_upsample_bf16(const float* flow, const void* mask,
                                         float* out, int B, int h, int w,
                                         int K, void* stream) {
  const long long total = (long long)B * h * K * w * K;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  convex_upsample_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      flow, static_cast<const __nv_bfloat16*>(mask), out, B, h, w, K);
  return (int)cudaGetLastError();
}

// g: [B, h*K, w*K, 2] gradient of out. Writes gflow [B, h, w, 2] and gmask
// [B, h, w, 9*K*K]; gnb [B, h, w, 9, 2] is scratch. K*K <= 1024.
extern "C" int emip_convex_upsample_bwd(const float* flow, const float* mask,
                                        const float* g, float* gflow,
                                        float* gmask, float* gnb, int B,
                                        int h, int w, int K, void* stream) {
  return convex_upsample_bwd(flow, mask, g, gflow, gmask, gnb, B, h, w, K,
                             static_cast<cudaStream_t>(stream));
}

// The bf16 train step: mask logits and gmask bf16, the rest as above.
extern "C" int emip_convex_upsample_bwd_bf16(const float* flow,
                                             const void* mask, const float* g,
                                             float* gflow, void* gmask,
                                             float* gnb, int B, int h, int w,
                                             int K, void* stream) {
  return convex_upsample_bwd(flow, static_cast<const __nv_bfloat16*>(mask),
                             g, gflow, static_cast<__nv_bfloat16*>(gmask),
                             gnb, B, h, w, K,
                             static_cast<cudaStream_t>(stream));
}
