// Kernel F: the long-term memory read, forward and backward.
//
//   out = softmax(q k^T / sqrt(C) + bias, over the N keys) v
//
// Replaces emip_tpu/ops/pallas/memory_attention.py:masked_memory_attention
// (_fwd_kernel, _bwd_kernel). q [B, M, C] is the query frame's key map,
// k and v [B, N, C] the ring of memory keys and values flattened slot-major
// (N = slots * M), bias [B, N] is 0 on the keys of a written slot and -1e9
// on those of an empty one; out [B, M, C]. C is GMFlow's feature width, at
// which EMIPLong builds its memory: 128 (pvt_v2_b5's configuration) or 64
// (b0's). At 352^2 inputs M = 1936 and N = 9680, at 512^2 M = 4096 and
// N = 20480.
//
// Forward. What bounds it on the card: the two products, 4 * M * N * C
// operations per batch row (9.6 GFLOP at 352^2); the operands are ~12 MB.
// The TPU kernel keeps all N keys and a [tile, N] block of scores in VMEM;
// here neither fits in shared memory. The first version ran both products
// on the CUDA cores out of 64 x 64 tiles with 4 x 4 register patches,
// transposed k and q into shared memory by scalar loads with no overlap of
// loads and arithmetic, and sent P through shared memory (three barriers per
// tile): 4.7x its fp32 bound, 1.34x the library's fused attention. This one
// (attention_fwd_tc of mma_tf32.cuh) runs both on the tensor cores as
// 3xTF32: 8 warps of two 16-row fragments own 256 query rows, kept in shared
// memory (132 KiB), so that each streamed fragment is loaded and split once
// for two mma; the keys and values stream in tiles of 32 through two
// cp.async stages (66 KiB), one block on an SM. The online max and sum run
// on the score fragments in registers, P stays there as the A operand of
// P v, and the bias (0 or -1e9 per key) is staged beside each tile and added
// before the running max. Keys past N are masked to -inf. With few query
// tiles (1 clip: 8 blocks; 4 clips: 32; 512^2: 16) the keys are split across
// blocks so that the last wave is full, and an ordered pass merges the
// partial outputs by their max and sum. All-masked tiles are
// not skipped: with every slot empty all scores are equal and the result is
// the plain mean of the values, as on the TPU.
//
// Backward. What bounds it: five M x N x C products per batch row when all
// three grads are asked for (the scores, dO v^T, dS k, dS^T q, P^T dO),
// 24 GFLOP at 352^2; at the fp32 rate of the CUDA cores that is the bound
// the records state. The first version ran them there out of 64 x 64 tiles
// with 4 x 4 register patches, a shared load for every two to three
// multiply-adds and no overlap of loads with arithmetic. This one
// (attention_bwd_tc of mma_tf32.cuh) runs all five on the tensor cores as
// 3xTF32 (fp32-grade: the long train step's grad check leaves no room for a
// single TF32 product): 8 warps own 128 rows of one side, kept in shared
// memory with their dO or v rows (132 KiB), and stream the other side in
// tiles of 32 rows through two cp.async stages (66 KiB), one block on an
// SM. The TPU kernel accumulates dk and dv over a sequential grid of query
// tiles. Blocks run in no order here, so a query-tiled pass writes dq (keys
// split across blocks when there are few query tiles, partials summed in
// order) and a key-tiled pass streams the queries and writes dk and dv; both
// recompute P = exp(S - m) / l from the row max m and sum l the forward kept
// (kept apart, not as m + log l: with every slot empty m is -1e9, where
// fp32 has no room for log l), so the scores and dO v^T are computed twice.
// dq alone runs the first pass only. No atomics: every run gives the same
// bits.

#include "mma_tf32.cuh"

// the tilings: warps, fragments of 16 resident rows per warp, streamed rows
// per stage
constexpr int kMemFwdWarps = 8;
constexpr int kMemFwdMt = 2;
constexpr int kMemFwdStr = 32;
constexpr int kMemBwdWarps = 8;
constexpr int kMemBwdMt = 1;
constexpr int kMemBwdStr = 32;

// stats [2, B, M] (row max, row sum) may be null (no gradient will be
// taken). ws: scratch for the key-split partials.
extern "C" int emip_memory_attention(const float* q, const float* k,
                                     const float* v, const float* bias,
                                     float* out, float* stats, float* ws,
                                     long long ws_floats, int B, int M, int N,
                                     int C, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)M * C, ksb = (long long)N * C;
  const AttnOperand qo{q, qsb, C}, ko{k, ksb, C}, vo{v, ksb, C};
  float* row_sum = stats ? stats + (long long)B * M : nullptr;
  const Workspace w{ws, ws_floats};
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128)
    err = attention_fwd_tc<128, 128, kMemFwdWarps, kMemFwdMt, kMemFwdStr>(
        qo, ko, vo, bias, out, stats, row_sum, B, M, N, scale, w, s);
  else if (C == 64)
    err = attention_fwd_tc<64, 64, kMemFwdWarps, kMemFwdMt, kMemFwdStr>(
        qo, ko, vo, bias, out, stats, row_sum, B, M, N, scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// g: [B, M, C] gradient of out; out and stats are the forward's. dq, dk, dv
// may each be null (not computed); the bias gets no gradient. ws: scratch
// for delta and the partials of a split pass.
extern "C" int emip_memory_attention_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const float* out, const float* stats, const float* g, float* dq, float* dk,
    float* dv, float* ws, long long ws_floats, int B, int M, int N, int C,
    void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)M * C, ksb = (long long)N * C;
  const AttnOperand qo{q, qsb, C}, ko{k, ksb, C}, vo{v, ksb, C};
  const AttnOperand oo{out, qsb, C}, go{g, qsb, C};
  const AttnGrad dqg{dq, qsb, C}, dkg{dk, ksb, C}, dvg{dv, ksb, C};
  const float* row_sum = stats + (long long)B * M;
  const Workspace w{ws, ws_floats};
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128)
    err = attention_bwd_tc<128, 128, kMemBwdWarps, kMemBwdMt, kMemBwdStr>(
        qo, ko, vo, oo, go, bias, stats, row_sum, dqg, dkg, dvg, B, M, N,
        scale, w, s);
  else if (C == 64)
    err = attention_bwd_tc<64, 64, kMemBwdWarps, kMemBwdMt, kMemBwdStr>(
        qo, ko, vo, oo, go, bias, stats, row_sum, dqg, dkg, dvg, B, M, N,
        scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
