// Kernel A: PVTv2 spatial-reduction attention, forward and backward.
//
// Replaces emip_tpu/ops/pallas/sr_attention.py:fused_sr_attention
// (_fwd_kernel, _bwd_kernel). Per image:
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
//
// Backward: the TPU kernel walks a sequential grid and carries the weight
// grads and g_kv_in across its steps. Hopper blocks run in no order, so the
// weight grads become split-K GEMMs over all B*N (or B*M) rows summed in an
// ordered second pass, the bias grads ordered column sums, and gx / g_kv_in
// GEMMs with the weights. The forward keeps q, [k | v] and o (what the
// backward reads); the attention backward recomputes P from them. At
// stage 1 there are only B * heads = 8 (image, head) pairs of N = 7744
// queries over 121 keys, so the key-tiled pass splits the queries across
// blocks and sums the partial dk, dv in a second, ordered pass.

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
  cudaError_t err;
  if ((err = linear(x, C, wq, bq, q_buf, C, B * N, C, C, false, s))) return err;
  if ((err = linear(kv_in, C, wkv, bkv, kv_buf, 2 * C, B * M, 2 * C, C, false,
                    s)))
    return err;
  err = attention(ch, ch, q_buf, (long long)N * C, C, kv_buf,
                  (long long)M * 2 * C, 2 * C, kv_buf + C,
                  (long long)M * 2 * C, 2 * C, o_buf, (long long)N * C, C,
                  nullptr, 1, B, heads, N, M, 1.0f / sqrtf((float)ch), s);
  if (err != cudaSuccess) return (int)err;
  if ((err = linear(o_buf, C, wp, bp, out, C, B * N, C, C, false, s)))
    return err;
  return (int)cudaGetLastError();
}

// g: [B, N, C] gradient of out. q_buf, kv_buf, o_buf: the forward's saved
// intermediates. Grads whose pointer is null are not computed. go, gq
// [B, N, C] and gkv [B, M, 2C] are scratch; ws is the split-K / attention
// workspace.
extern "C" int emip_sr_attention_bwd(
    const float* x, const float* kv_in, const float* wq, const float* wkv,
    const float* wp, const float* q_buf, const float* kv_buf,
    const float* o_buf, const float* g, float* gx, float* gkv_in, float* gwq,
    float* gbq, float* gwkv, float* gbkv, float* gwp, float* gbp, float* go,
    float* gq, float* gkv, float* ws, long long ws_floats, int B, int N,
    int M, int C, int heads, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w{ws, ws_floats};
  const int ch = C / heads;
  const int rq = B * N, rk = B * M;
  cudaError_t err;
#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;

  // out = o Wp^T + bp
  EMIP_TRY(weight_grad(g, C, o_buf, C, gwp, C, C, rq, w, s));
  EMIP_TRY(colsum(g, C, rq, C, gbp, w, s));
  EMIP_TRY(input_grad(g, C, wp, C, C, go, C, rq, false, s));

  // o = attention(q, k, v)
  const long long qsb = (long long)N * C, ksb = (long long)M * 2 * C;
  EMIP_TRY(attention_bwd(
      ch, ch, AttnOperand{q_buf, qsb, C}, AttnOperand{kv_buf, ksb, 2 * C},
      AttnOperand{kv_buf + C, ksb, 2 * C}, AttnOperand{o_buf, qsb, C},
      AttnOperand{go, qsb, C}, AttnGrad{gq, qsb, C},
      AttnGrad{gkv, ksb, 2 * C}, AttnGrad{gkv + C, ksb, 2 * C}, nullptr, 1,
      B, heads, N, M, 1.0f / sqrtf((float)ch), w, s));

  // q = x Wq^T + bq; [k | v] = kv_in Wkv^T + bkv
  EMIP_TRY(weight_grad(gq, C, x, C, gwq, C, C, rq, w, s));
  EMIP_TRY(colsum(gq, C, rq, C, gbq, w, s));
  EMIP_TRY(weight_grad(gkv, 2 * C, kv_in, C, gwkv, 2 * C, C, rk, w, s));
  EMIP_TRY(colsum(gkv, 2 * C, rk, 2 * C, gbkv, w, s));
  if (gx) EMIP_TRY(input_grad(gq, C, wq, C, C, gx, C, rq, false, s));
  if (gkv_in)
    EMIP_TRY(input_grad(gkv, 2 * C, wkv, 2 * C, C, gkv_in, C, rk, false, s));
#undef EMIP_TRY
  return (int)cudaGetLastError();
}
