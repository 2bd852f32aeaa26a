// Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v, forward and
// backward.
//
// Replaces emip_tpu/ops/pallas/corr_softmax.py:fused_flow_attention
// (_flow_attention_kernel, _flow_attention_bwd_kernel). q, k [B, L, C];
// v [B, L, 2]; out [B, L, 2]. It serves global matching in both directions
// (v = the pixel grid) and flow propagation (v = the flow).
//
// What bounds it on the card: the q k^T product, about 2 * L^2 * C FLOP
// per batch row (0.96 GFLOP at L = 1936, C = 128), in fp32 on the CUDA
// cores. The [L, L] scores are never stored: one block per 32 query rows
// streams all L keys through shared memory in tiles of 32 with an online
// max and sum, and accumulates the 2-wide output in registers, as the TPU
// kernel kept a row tile of scores in VMEM.
//
// Backward: the TPU kernel accumulates dk and dv over a sequential grid of
// query tiles. Here a query-tiled pass recomputes each row's log-sum-exp
// and writes dq, and a key-tiled pass recomputes the scores per tile and
// accumulates dk (and dv when asked for), so no [L, L] array exists in
// either direction and no block depends on another's order. At L = 1936
// the key-tiled pass has 61 tiles per batch row, enough blocks to fill the
// card without splitting the queries. On the train path v is the pixel
// grid or the detached flow, so dv is not asked for.

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

// g: [B, L, DV] gradient of out; out is the forward's output. dq, dk, dv
// may each be null (not computed). ws: the attention workspace.
extern "C" int emip_flow_attention_bwd(const float* q, const float* k,
                                       const float* v, const float* out,
                                       const float* g, float* dq, float* dk,
                                       float* dv, float* ws,
                                       long long ws_floats, int B, int L,
                                       int C, int DV, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)L * C, vsb = (long long)L * DV;
  cudaError_t err = attention_bwd(
      C, DV, AttnOperand{q, qsb, C}, AttnOperand{k, qsb, C},
      AttnOperand{v, vsb, DV}, AttnOperand{out, vsb, DV},
      AttnOperand{g, vsb, DV}, AttnGrad{dq, qsb, C}, AttnGrad{dk, qsb, C},
      AttnGrad{dv, vsb, DV}, nullptr, 1, B, 1, L, L, 1.0f / sqrtf((float)C),
      Workspace{ws, ws_floats}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
