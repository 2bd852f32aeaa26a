// Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v, forward.
//
// Replaces emip_tpu/ops/pallas/corr_softmax.py:fused_flow_attention
// (_flow_attention_kernel). q, k [B, L, C]; v [B, L, 2]; out [B, L, 2].
// It serves global matching in both directions (v = the pixel grid) and
// flow propagation (v = the flow).
//
// What bounds it on the card: the q k^T product, about 2 * L^2 * C FLOP
// per batch row (0.96 GFLOP at L = 1936, C = 128), in fp32 on the CUDA
// cores. The [L, L] scores are never stored: one block per 32 query rows
// streams all L keys through shared memory in tiles of 32 with an online
// max and sum, and accumulates the 2-wide output in registers, as the TPU
// kernel kept a row tile of scores in VMEM.

#include "primitives.cuh"

extern "C" int emip_flow_attention(const float* q, const float* k,
                                   const float* v, float* out, int B, int L,
                                   int C, int DV, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = attention(
      C, DV, q, (long long)L * C, C, k, (long long)L * C, C, v,
      (long long)L * DV, DV, out, (long long)L * DV, DV, nullptr, 1, B, 1, L,
      L, 1.0f / sqrtf((float)C), s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
