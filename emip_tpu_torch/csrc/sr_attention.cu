// Kernel A: PVTv2 spatial-reduction attention, forward.
//
// Replaces emip_tpu/ops/pallas/sr_attention.py:fused_sr_attention
// (_fwd_kernel). Per image:
//   q = x Wq^T + bq                      [N, C]
//   [k | v] = kv_in Wkv^T + bkv          [M, 2C]
//   o_h = softmax(q_h k_h^T / sqrt(ch)) v_h for every head h (ch = C/heads)
//   out = concat_h(o_h) Wp^T + bp        [N, C]
//
// What bounds it on the card: the q / proj products and the attention are
// all fp32 FMAs on the CUDA cores (no tensor cores yet), so it is bound by
// arithmetic, not bytes. At 352^2 every stage has M = 121 keys, so the
// attention is short: each block streams the 121 keys of one (image, head)
// through shared memory in four tiles, keeping the softmax online and the
// [N, M] probabilities out of device memory, as the TPU kernel kept them
// in VMEM. The sr conv + LayerNorm that produce kv_in stay in PyTorch,
// as they stayed in XLA. The TPU kernel's one-image-per-grid-step layout
// is replaced by four launches of the shared building blocks (three tiled
// GEMMs and one attention), each filling the card with many blocks.

#include "primitives.cuh"

extern "C" int emip_sr_attention(const float* x, const float* kv_in,
                                 const float* wq, const float* bq,
                                 const float* wkv, const float* bkv,
                                 const float* wp, const float* bp,
                                 float* q_buf, float* kv_buf, float* o_buf,
                                 float* out, int B, int N, int M, int C,
                                 int heads, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ch = C / heads;
  linear(x, C, wq, bq, q_buf, C, B * N, C, C, false, s);
  linear(kv_in, C, wkv, bkv, kv_buf, 2 * C, B * M, 2 * C, C, false, s);
  cudaError_t err = attention(
      ch, ch, q_buf, (long long)N * C, C, kv_buf, (long long)M * 2 * C,
      2 * C, kv_buf + C, (long long)M * 2 * C, 2 * C, o_buf,
      (long long)N * C, C, nullptr, 1, B, heads, N, M,
      1.0f / sqrtf((float)ch), s);
  if (err != cudaSuccess) return (int)err;
  linear(o_buf, C, wp, bp, out, C, B * N, C, C, false, s);
  return (int)cudaGetLastError();
}
