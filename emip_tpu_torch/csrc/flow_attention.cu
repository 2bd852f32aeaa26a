// Kernel C: flow-valued attention softmax(q k^T / sqrt(C)) v, forward and
// backward.
//
// Replaces emip_tpu/ops/pallas/corr_softmax.py:fused_flow_attention
// (the Pallas kernels of _flow_attention_fwd_impl and _flow_attention_bwd,
// corr_softmax.py:182 and :236). q, k [B, L, C] with C = 128 (pvt_v2_b5's
// GMFlow) or 64 (pvt_v2_b0's); v [B, L, 2]; out [B, L, 2]. It serves
// global matching in both directions (v = the pixel grid) and flow
// propagation (v = the flow).
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
//
// The bf16 backward (the bf16 train step: q, k bf16, v fp32), as the JAX
// kernel computes it: the scores and P recomputed in fp32 from q and k,
// dq and dk rounded to bf16 once at the end. q and k are read as bf16 where
// they lie: copied by cp.async into bf16 tiles (rows D + 8 values apart,
// half the bytes of the fp32 tiles) and widened exactly, a shift, as the
// fragments are built. A bf16 value is exact in TF32, so the products of
// its zero low half are left out (mma_3xtf32's A_EXACT / B_EXACT): q k^T
// is one TF32 product, dS k and dS^T q two; the 2-wide products stay on the
// CUDA cores. Two launches and their merge: a statistics pass
// (attention_fwd_tc with STATS_BF16: the fp32 forward's tiling, splits and
// merge, no P v) gives the row max and sum (the bf16 forward keeps none,
// and its scores, mma.m16n8k16 bf16 products, sum in another order), then
// attention_bwd_tc with Q16 and K16 at the fp32 backward's tiling and
// splits, delta from the bf16 forward's fp32 output as the JAX kernel reads
// its forward's out; dq and dk are rounded where they are finished (the unsplit
// pass, or the ordered sum of the split partials), dv stays fp32. Every
// term left out added +0, so the grads are the bits of the fp32 backward on
// the upcast q and k, rounded: no scratch copy of the inputs, no fp32 dq and
// dk, no conversion launches.
//
// Budget of the bf16 backward's passes at width 128 (64): a block of 4 warps
// owns 128 rows, 34 KiB (18 KiB) of bf16 tile; each streamed stage is a bf16
// tile of 32 rows and its vectors, 9.3 KiB (5.3 KiB). The registers (two
// 16-row fragments a warp, <= 255 a thread) allow two blocks an SM, as in
// fp32, and the fp32 tiling's block count is kept so that the splits, and
// so the sums, are the fp32 backward's. The halved tiles buy a third stage
// instead (62 KiB a block, against 103 KiB for fp32 with two), so that two
// tiles are in flight while one is multiplied; a wider resident tile would
// change the splits and the bits. The statistics pass keeps the forward's
// tiling: 256 query rows of 8 warps, one block an SM (registers), 86 KiB.

#include "attention_bf16.cuh"
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
        AttnOperand{v, vsb, DV}, nullptr, nullptr, 1,
        AttnGrad{out, vsb, DV}, stats, row_sum, B, 1, L, L, scale, w, s);
  else if (C == 64)
    err = attention_fwd_tc<64, 2, kFlowFwdWarps, kFlowFwdMt, kFlowFwdStr>(
        AttnOperand{q, qsb, C}, AttnOperand{k, qsb, C},
        AttnOperand{v, vsb, DV}, nullptr, nullptr, 1,
        AttnGrad{out, vsb, DV}, stats, row_sum, B, 1, L, L, scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The bf16 forward (the bf16 band of short inference): q, k [B, L, C] bf16,
// v [B, L, 2] fp32, out [B, L, 2] fp32, as the JAX kernel takes them in a
// bf16 model (q k^T from bf16 operands into fp32, P and P v in fp32). The
// bf16 attention of attention_bf16.cu; no statistics (the bf16 backward
// recomputes them).
extern "C" int emip_flow_attention_bf16(const void* q, const void* k,
                                        const float* v, float* out, int B,
                                        int L, int C, void* stream) {
  const long long qsb = (long long)L * C, vsb = (long long)L * 2;
  return emip_attention_fwd_bf16(q, qsb, C, k, qsb, C, v, vsb, 2, nullptr, 0,
                                 1, nullptr, out, vsb, 2, B, L, L, C, 2, 0,
                                 stream);
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
        qo, ko, vo, oo, go, nullptr, nullptr, 1, stats, row_sum, dqg, dkg,
        dvg, B, 1, L, L, scale, w, s);
  else if (C == 64)
    err = attention_bwd_tc<64, 2, kFlowBwdWarps, kFlowBwdMt, kFlowBwdStr>(
        qo, ko, vo, oo, go, nullptr, nullptr, 1, stats, row_sum, dqg, dkg,
        dvg, B, 1, L, L, scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The bf16 backward: q, k [B, L, C] bf16; v, out, g [B, L, 2] fp32 (out the
// bf16 forward's); dq, dk bf16 and dv fp32, each null when not wanted. ws:
// 2 B L floats for the row statistics, then the backward's delta (B L) and
// the partials of its split passes, which the statistics pass's partials
// use first.
extern "C" int emip_flow_attention_bwd_bf16(const void* q, const void* k,
                                            const float* v, const float* out,
                                            const float* g, void* dq,
                                            void* dk, float* dv, float* ws,
                                            long long ws_floats, int B, int L,
                                            int C, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)L * C, vsb = (long long)L * 2;
  const AttnOperand qo{static_cast<const float*>(q), qsb, C},
      ko{static_cast<const float*>(k), qsb, C}, vo{v, vsb, 2},
      oo{out, vsb, 2}, go{g, vsb, 2};
  const AttnGrad dqg{static_cast<float*>(dq), qsb, C},
      dkg{static_cast<float*>(dk), qsb, C}, dvg{dv, vsb, 2},
      none{nullptr, vsb, 2};
  Workspace all{ws, ws_floats};
  float* stats = all.take(2LL * B * L);
  if (!stats) return (int)cudaErrorInvalidValue;
  float* row_sum = stats + (long long)B * L;
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128) {
    err = attention_fwd_tc<128, 2, kFlowFwdWarps, kFlowFwdMt, kFlowFwdStr,
                           false, false, true>(
        qo, ko, vo, nullptr, nullptr, 1, none, stats, row_sum, B, 1, L, L,
        scale, all, s);
    if (err == cudaSuccess)
      err = attention_bwd_tc<128, 2, kFlowBwdWarps, kFlowBwdMt, kFlowBwdStr,
                             false, true>(qo, ko, vo, oo, go, nullptr,
                                          nullptr, 1, stats, row_sum, dqg,
                                          dkg, dvg, B, 1, L, L, scale, all,
                                          s);
  } else if (C == 64) {
    err = attention_fwd_tc<64, 2, kFlowFwdWarps, kFlowFwdMt, kFlowFwdStr,
                           false, false, true>(
        qo, ko, vo, nullptr, nullptr, 1, none, stats, row_sum, B, 1, L, L,
        scale, all, s);
    if (err == cudaSuccess)
      err = attention_bwd_tc<64, 2, kFlowBwdWarps, kFlowBwdMt, kFlowBwdStr,
                             false, true>(qo, ko, vo, oo, go, nullptr,
                                          nullptr, 1, stats, row_sum, dqg,
                                          dkg, dvg, B, 1, L, L, scale, all,
                                          s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
