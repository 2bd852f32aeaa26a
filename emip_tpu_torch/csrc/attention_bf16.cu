// The bf16 forward attention of kernels B and C (declared in
// attention_bf16.cuh), beside the 3xTF32 attention_fwd_tc of mma_tf32.cuh
// that their fp32 entry points run. A's bf16 forward runs the same key
// loop (AbKeys of attention_bf16.cuh) inside its fused kernel
// (sr_attention.cu).
//
// Replaces, in the bf16 band, the attention inside
// emip_tpu/ops/pallas/window_attention.py:_block_self_forward (B's self
// layer) and corr_softmax.py:_flow_attention_kernel (C), and the attention
// of sr_attention.py:_fwd_kernel (A) through that loop. The JAX kernels
// take bf16 q and k, accumulate q k^T in fp32 and run the softmax in fp32;
// A and B round the normalised P to bf16 for P v (fp32 accumulation) and
// round o to bf16; C keeps P in fp32 and upcasts its 2-wide v. Here the
// softmax is online: P = exp(s - m_running) is rounded to bf16 for the
// tensor-core P v and the sum is divided out at the end, the same function
// within the bf16 band; C's 2-wide P v stays on the CUDA cores in fp32.
//
// What bounds it: the q k^T product (and with DV = D the P v product), 2 Nq
// Nk D operations each per batch row, at the bf16 tensor-core rate. A block
// of 4 warps owns 64 query rows of one batch row (a warp 16 rows, its q
// fragments in registers for the whole key loop); keys and values stream
// in tiles of 32 through two cp.async stages, fragments read with ldmatrix
// (v transposed by ldmatrix.trans); the scores stay in registers (see
// AbKeys::run). The shifted-window mask of B (3.7 MiB at T = 484)
// is read from L2 where it is added. The [Nq, Nk] scores never reach device
// memory. One split of the keys: B's 64 windows of 484 tokens make 512
// blocks, C's 16 rows of 1936 queries 496.

#include "attention_bf16.cuh"

namespace emip {
namespace {

struct AttnBf16Args {
  const bf16* q;
  long long q_sb;
  int q_sn;
  const bf16* k;
  long long k_sb;
  int k_sn;
  const void* v;
  long long v_sb;
  int v_sn;
  const float* mask;
  int mask_nw;
  void* out;
  long long o_sb;
  int o_sn;
  int Nq, Nk;
  float scale;
};

// the block's q tile [kAbRows][D + 8] bf16, then the key loop's stages
template <int D, int DV>
struct AbPlan {
  using Keys = AbKeyPlan<D, DV>;
  static constexpr int kQ = kAbRows * Keys::kLd;  // bf16
  static constexpr size_t kBytes = sizeof(bf16) * kQ + Keys::kBytes;
};

// Grid (query tiles, B): batch row b's row n of q and k lies at p[b sb + n
// sn], of v and out at the same with their strides.
template <int D, int DV, bool MASKED>
__global__ void __launch_bounds__(kAbThreads)
attention_bf16_kernel(AttnBf16Args a) {
  using L = AbPlan<D, DV>;
  using K = typename L::Keys;
  extern __shared__ __align__(16) unsigned char ab_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(ab_smem);  // [kAbRows][kLd]
  bf16* Ks = Qs + L::kQ;                        // [2][kAbKt][kLd]
  unsigned char* Vs = reinterpret_cast<unsigned char*>(Ks + 2 * K::kK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kAbRows;
  const bf16* qp = a.q + b * a.q_sb;
  const float* mask =
      MASKED && a.mask ? a.mask + (long long)(b % a.mask_nw) * a.Nq * a.Nk
                       : nullptr;

  constexpr int kChunks = D / 8;  // 16-byte chunks of a q row
  for (int e = tid; e < kAbRows * kChunks; e += kAbThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = q0 + r < a.Nq;
    cp_async<16>(Qs + r * K::kLd + c,
                 ok ? qp + (long long)(q0 + r) * a.q_sn + c : qp, ok);
  }

  const AbKeys<D, DV, MASKED> keys{
      a.k + b * a.k_sb, a.k_sn,
      K::kWide ? static_cast<const void*>(static_cast<const bf16*>(a.v) +
                                          b * a.v_sb)
               : static_cast<const void*>(static_cast<const float*>(a.v) +
                                          b * a.v_sb),
      a.v_sn, a.Nk, Ks, Vs};
  const int row_a = q0 + warp * 16 + g;  // this thread's first row
  uint32_t qf[D / 16][4];
  float o[K::kAccN][4], inv[2];
  keys.start();  // also commits the q copies
  keys.run(mask, a.Nq, a.scale, row_a, qf, o, inv, [&] {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * K::kLd + kk * 16 +
                              (lane / 16) * 8);
  });

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int n = row_a + 8 * hf;
    if (n >= a.Nq) continue;
    if constexpr (K::kWide) {
      bf16* dst = static_cast<bf16*>(a.out) + b * a.o_sb +
                  (long long)n * a.o_sn;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c + 2 * t) =
            __floats2bfloat162_rn(o[c][2 * hf] * inv[hf],
                                  o[c][2 * hf + 1] * inv[hf]);
    } else if (t == 0) {
      float* dst = static_cast<float*>(a.out) + b * a.o_sb +
                   (long long)n * a.o_sn;
      *reinterpret_cast<float2*>(dst) =
          make_float2(o[0][2 * hf] * inv[hf], o[0][2 * hf + 1] * inv[hf]);
    }
  }
}

template <int D, int DV, bool MASKED>
cudaError_t attention_bf16_launch(const AttnBf16Args& a, int B,
                                  cudaStream_t stream) {
  using L = AbPlan<D, DV>;
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bf16_kernel<D, DV, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ceil_div(a.Nq, kAbRows), B);
  attention_bf16_kernel<D, DV, MASKED>
      <<<grid, kAbThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace emip

extern "C" int emip_attention_fwd_bf16(const void* q, long long q_sb,
                                       int q_sn, const void* k,
                                       long long k_sb, int k_sn,
                                       const void* v, long long v_sb,
                                       int v_sn, const float* mask,
                                       int mask_nw, void* out, long long o_sb,
                                       int o_sn, int B, int Nq, int Nk, int D,
                                       int DV, int windows, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Nq <= 0 || Nk <= 0 || B <= 0 || q_sn % 8 || k_sn % 8 || q_sb % 8 ||
      k_sb % 8 || !aligned16_ptr(q) || !aligned16_ptr(k) ||
      (mask && !windows))
    return (int)cudaErrorInvalidValue;
  AttnBf16Args a;
  a.q = static_cast<const bf16*>(q); a.q_sb = q_sb; a.q_sn = q_sn;
  a.k = static_cast<const bf16*>(k); a.k_sb = k_sb; a.k_sn = k_sn;
  a.v = v; a.v_sb = v_sb; a.v_sn = v_sn;
  a.mask = mask; a.mask_nw = mask_nw > 0 ? mask_nw : 1;
  a.out = out; a.o_sb = o_sb; a.o_sn = o_sn;
  a.Nq = Nq; a.Nk = Nk;
  a.scale = 1.0f / sqrtf((float)D);
  cudaError_t err;
  if (DV == 2) {  // kernel C: fp32 v and out
    if (windows || v_sn % 2 || v_sb % 2) return (int)cudaErrorInvalidValue;
    if (D == 128)
      err = attention_bf16_launch<128, 2, false>(a, B, s);
    else if (D == 64)
      err = attention_bf16_launch<64, 2, false>(a, B, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (DV != D || !windows || Nq != Nk || v_sn % 8 || v_sb % 8 ||
             !aligned16_ptr(v)) {
    return (int)cudaErrorInvalidValue;
  } else if (D == 128) {  // kernel B's windows
    err = attention_bf16_launch<128, 128, true>(a, B, s);
  } else if (D == 64) {
    err = attention_bf16_launch<64, 64, true>(a, B, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
