// Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v, forward and
// backward.
//
// Replaces emip_tpu/ops/pallas/corr_softmax.py:fused_flow_attention
// (_flow_attention_kernel, _flow_attention_bwd_kernel). q, k [B, L, C]
// with C = 128 (pvt_v2_b5's GMFlow) or 64 (pvt_v2_b0's); v [B, L, 2]; out
// [B, L, 2]. It serves global matching in both directions
// (v = the pixel grid) and flow propagation (v = the flow).
//
// Forward. What bounds it on the card: the q k^T product, about
// 2 * L^2 * C operations per batch row (0.96 GFLOP at L = 1936, C = 128);
// the 2-wide P v adds 1/64 of that. The first version ran it on the CUDA
// cores out of generic 32 x 32 tiles with scalar shared loads (6.4x its fp32
// bound, 1.32x the library's fused attention), and the copy that kept the
// statistics needed a launch bound of its own to get its registers back.
// This one (attention_fwd_tc of mma_tf32.cuh) runs q k^T on the tensor cores
// as 3xTF32; P v and the row sums stay on the CUDA cores. A block owns 256
// query rows (8 warps of two 16-row fragments, so that a streamed fragment
// is loaded and split once for two mma), streams the keys in tiles of 32
// through two cp.async stages, keeps the online max and sum on the score
// fragments in registers and masks the keys past L (1936 is no multiple of
// 32) to -inf; one block on an SM. The [L, L] scores are never stored,
// as the TPU kernel kept a row tile of them in VMEM. When a gradient will be
// taken the same kernel, instantiated with KEEP, also writes each row's max
// and sum (stats [2, B, L]), so the backward need not stream the keys once
// more to rebuild them. At [16, 1936] and [8, 4096] 128 blocks fill the
// card's 132 places; at [8, 1936] (the train step's matching) the keys are
// split in two and the partials merged in order.
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

// the tilings: warps, fragments of 16 resident rows per warp, streamed rows
// per stage
constexpr int kFlowFwdWarps = 8;
constexpr int kFlowFwdMt = 2;
constexpr int kFlowFwdStr = 32;
constexpr int kFlowBwdWarps = 4;
constexpr int kFlowBwdMt = 2;
constexpr int kFlowBwdStr = 32;

// stats [2, B, L] (row max, row sum) may be null (no gradient will be
// taken). ws: scratch for the key-split partials. C = 128 (pvt_v2_b5's
// GMFlow) or 64 (b0's); DV = 2.
extern "C" int emip_flow_attention(const float* q, const float* k,
                                   const float* v, float* out, float* stats,
                                   float* ws, long long ws_floats, int B,
                                   int L, int C, int DV, void* stream) {
  using namespace emip;
  if (DV != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)L * C, vsb = (long long)L * DV;
  float* row_sum = stats ? stats + (long long)B * L : nullptr;
  const Workspace w{ws, ws_floats};
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128)
    err = attention_fwd_tc<128, 2, kFlowFwdWarps, kFlowFwdMt, kFlowFwdStr>(
        AttnOperand{q, qsb, C}, AttnOperand{k, qsb, C},
        AttnOperand{v, vsb, DV}, nullptr, out, stats, row_sum, B, L, L,
        scale, w, s);
  else if (C == 64)
    err = attention_fwd_tc<64, 2, kFlowFwdWarps, kFlowFwdMt, kFlowFwdStr>(
        AttnOperand{q, qsb, C}, AttnOperand{k, qsb, C},
        AttnOperand{v, vsb, DV}, nullptr, out, stats, row_sum, B, L, L,
        scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
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
  if (DV != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)L * C, vsb = (long long)L * DV;
  const AttnOperand qo{q, qsb, C}, ko{k, qsb, C}, vo{v, vsb, DV};
  const AttnOperand oo{out, vsb, DV}, go{g, vsb, DV};
  const AttnGrad dqg{dq, qsb, C}, dkg{dk, qsb, C}, dvg{dv, vsb, DV};
  const float* row_sum = stats + (long long)B * L;
  const Workspace w{ws, ws_floats};
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128)
    err = attention_bwd_tc<128, 2, kFlowBwdWarps, kFlowBwdMt, kFlowBwdStr>(
        qo, ko, vo, oo, go, nullptr, stats, row_sum, dqg, dkg, dvg, B, L, L,
        scale, w, s);
  else if (C == 64)
    err = attention_bwd_tc<64, 2, kFlowBwdWarps, kFlowBwdMt, kFlowBwdStr>(
        qo, ko, vo, oo, go, nullptr, stats, row_sum, dqg, dkg, dvg, B, L, L,
        scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
