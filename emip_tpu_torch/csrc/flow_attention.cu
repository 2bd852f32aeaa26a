// Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v, forward and
// backward.
//
// Replaces emip_tpu/ops/pallas/corr_softmax.py:fused_flow_attention
// (_flow_attention_kernel, _flow_attention_bwd_kernel). q, k [B, L, C];
// v [B, L, 2]; out [B, L, 2]. It serves global matching in both directions
// (v = the pixel grid) and flow propagation (v = the flow).
//
// Forward. What bounds it on the card: the q k^T product, about
// 2 * L^2 * C FLOP per batch row (0.96 GFLOP at L = 1936, C = 128), in fp32
// on the CUDA cores. The [L, L] scores are never stored: one block per 32
// query rows streams all L keys through shared memory in tiles of 32 with an
// online max and sum, and accumulates the 2-wide output in registers, as the
// TPU kernel kept a row tile of scores in VMEM. When a gradient will be
// taken it also writes each row's max and sum (stats [2, B, L]; 2 * B * L
// floats more), so the backward need not stream the keys once more to
// rebuild them.
//
// Backward. What bounds it: three L x L x C products per batch row that no
// grad can do without (the scores, dS k for dq, dS^T q for dk), 1.9 GFLOP
// at L = 1936; at the fp32 rate of the CUDA cores that is the bound the
// records state. The first version ran them there, out of 32 x 32 tiles
// with scalar shared loads (two loads per multiply-add), and computed the
// scores three times. This one (attention_bwd_tc of mma_tf32.cuh) runs them
// on the tensor cores as 3xTF32 (fp32-grade: a single TF32 product would
// not hold the train step's grad tolerances). A block owns 128 rows of one
// side: 4 warps of 32 rows, two 16-row fragments each, so that every
// fragment of the streamed side is loaded and split into its TF32 halves
// once for two mma; the other side streams in tiles of 32 rows through two
// cp.async stages; two blocks share an SM. It reads the forward's
// statistics: the scores are computed twice, once per pass. The TPU kernel
// accumulates dk and dv over a sequential grid of query tiles; here a
// query-tiled pass writes dq and a key-tiled pass dk (and dv when asked
// for), so no [L, L] array exists in either direction, no block depends on
// another's order and two runs give the same bits. The 2-wide products
// (dO v^T, P^T dO) stay on the CUDA cores. At L = 1936 and B = 8 each pass
// has 16 x 8 = 128 blocks for the card's 264 places, so the streamed side is
// split in two and the partials summed in order; at B = 16 the 256 blocks
// run unsplit. On the train path v is the pixel grid or the detached flow,
// so dv is not asked for.

#include "mma_tf32.cuh"

// the backward's tiling: warps, fragments of 16 resident rows per warp,
// streamed rows per stage
constexpr int kFlowBwdWarps = 4;
constexpr int kFlowBwdMt = 2;
constexpr int kFlowBwdStr = 32;

// stats [2, B, L] (row max, row sum) may be null (no gradient will be
// taken).
extern "C" int emip_flow_attention(const float* q, const float* k,
                                   const float* v, float* out, float* stats,
                                   int B, int L, int C, int DV,
                                   void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = attention(
      C, DV, q, (long long)L * C, C, k, (long long)L * C, C, v,
      (long long)L * DV, DV, out, (long long)L * DV, DV, nullptr, 1, B, 1, L,
      L, 1.0f / sqrtf((float)C), s, stats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// g: [B, L, DV] gradient of out; out and stats are the forward's. dq, dk,
// dv may each be null (not computed). ws: scratch for delta and the
// partials of a split pass.
extern "C" int emip_flow_attention_bwd(const float* q, const float* k,
                                       const float* v, const float* out,
                                       const float* stats, const float* g,
                                       float* dq, float* dk, float* dv,
                                       float* ws, long long ws_floats, int B,
                                       int L, int C, int DV, void* stream) {
  using namespace emip;
  if (C != 128 || DV != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)L * C, vsb = (long long)L * DV;
  cudaError_t err =
      attention_bwd_tc<128, 2, kFlowBwdWarps, kFlowBwdMt, kFlowBwdStr>(
      AttnOperand{q, qsb, C}, AttnOperand{k, qsb, C}, AttnOperand{v, vsb, DV},
      AttnOperand{out, vsb, DV}, AttnOperand{g, vsb, DV}, nullptr, stats,
      stats + (long long)B * L, AttnGrad{dq, qsb, C}, AttnGrad{dk, qsb, C},
      AttnGrad{dv, vsb, DV}, B, L, L, 1.0f / sqrtf((float)C),
      Workspace{ws, ws_floats}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
