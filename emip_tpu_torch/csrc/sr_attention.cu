// Kernel A: PVTv2 spatial-reduction attention, forward and backward.
//
// Replaces emip_tpu/ops/pallas/sr_attention.py:fused_sr_attention
// (_fwd_kernel, _bwd_kernel). Per image:
//   q = x Wq^T + bq                      [N, C]
//   [k | v] = kv_in Wkv^T + bkv          [M, 2C]
//   o_h = softmax(q_h k_h^T / sqrt(ch)) v_h for every head h (ch = C/heads)
//   out = concat_h(o_h) Wp^T + bp        [N, C]
//
// What bounds it on the card: arithmetic, not bytes. The q / kv / proj
// products run as the shared 3xTF32 GEMM on the tensor cores
// (gemm_tf32.cuh), over all B*N (or B*M) rows at once. The attention
// forward is attention_fwd_tc of mma_tf32.cuh (3xTF32 on the tensor cores;
// its tilings in attention.cu) with one batch row per (image, head),
// reading q and the two halves of [k | v] in place at the head's columns
// and writing o at them: at 352^2 every stage has M = 121 keys,
// streamed in four tiles of 32 (the last ragged) with the softmax kept
// online and the [N, M] probabilities out of device memory, as the TPU
// kernel kept them in VMEM; where a gradient will be taken it also keeps
// each row's max and sum (stats [2, B * heads, N]). At stage 4 (64 image-
// head rows of 121 queries, 64 blocks) the keys are split across blocks and
// merged in order (ws holds the partials). The sr conv + LayerNorm that
// produce kv_in stay in PyTorch, as they stayed in XLA. The TPU kernel's
// one-image-per-grid-step layout is replaced by four launches (three GEMMs
// and one attention, five with a merge), each filling the card with blocks.
//
// Backward: the TPU kernel walks a sequential grid and carries the weight
// grads and g_kv_in across its steps. Hopper blocks run in no order, so the
// weight grads become split-K GEMMs over all B*N (or B*M) rows summed in an
// ordered second pass, the bias grads ordered column sums, and gx / g_kv_in
// GEMMs with the weights. The attention backward is attention_bwd_tc of
// mma_tf32.cuh (3xTF32 on the tensor cores) with one batch row per (image,
// head): it reads q and [k | v] in place at the head's columns and
// recomputes P from the row statistics the forward kept. Its tiling is 4
// warps of two 16-row fragments (128 resident rows, so the M = 121 keys of
// an image's head fit one key tile), streamed tiles of 32, two blocks on an
// SM. At stage 1 there are only B * heads = 8 (image, head) pairs of N =
// 7744 queries over 121 keys, so the key-tiled pass splits the queries 16
// ways (128 blocks) and sums the partial dk, dv in an ordered pass. Grads
// that are not asked for are not computed: dq only for gx, Wq or bq, dk and
// dv only for g_kv_in, Wkv or bkv.
//
// The bf16 backward (the bf16 train step), as the JAX kernel computes it:
// q, [k | v], o and the row statistics recomputed in fp32 from the bf16 x,
// kv_in and weights (the bf16 forward's own buffers are rounded and are
// not reused; it keeps only its inputs), the fp32 backward above, and gx,
// g_kv_in and the three weight grads rounded to bf16 once (g_kv_in and the
// weight grads summed in fp32 over all rows first); the bias grads stay
// fp32. The GEMMs read bf16 operands as they lie (gemm_tf32.cuh: bf16
// tiles, widened as the fragments are built) and leave out the TF32 terms
// of their zero low halves: x Wq^T, kv_in Wkv^T and g Wp one TF32 product,
// g^T o, gq^T x, gkv^T kv_in, gq Wq and gkv Wkv two; the attention keeps its
// fp32 math on the recomputed q, k, v (three). The recompute stops at o and
// the statistics (no output projection), gbp sums g in bf16, and a bf16
// grad is rounded by the GEMM's epilogue or the ordered sum of its split-K
// partials: no scratch copy of the inputs, no conversion launches. Every
// term left out added +0, so the grads are the bits of the fp32 backward on
// the upcast inputs, rounded.

#include "attention_bf16.cuh"
#include "attention_fwd.cuh"
#include "gemm_bf16.cuh"
#include "gemm_tf32.cuh"

// the tiling of the attention backward: warps, fragments of 16 resident
// rows per warp, streamed rows per stage
constexpr int kSrBwdWarps = 4;
constexpr int kSrBwdMt = 2;
constexpr int kSrBwdStr = 32;

// stats [2, B, heads, N] (row max, row sum) may be null (no gradient will
// be taken). ws: scratch for the attention's key-split partials.
extern "C" int emip_sr_attention(const float* x, const float* kv_in,
                                 const float* wq, const float* bq,
                                 const float* wkv, const float* bkv,
                                 const float* wp, const float* bp,
                                 float* q_buf, float* kv_buf, float* o_buf,
                                 float* stats, float* out, float* ws,
                                 long long ws_floats, int B, int N, int M,
                                 int C, int heads, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ch = C / heads;
  cudaError_t err;
  if ((err = linear(x, C, wq, bq, q_buf, C, B * N, C, C, false, s))) return err;
  if ((err = linear(kv_in, C, wkv, bkv, kv_buf, 2 * C, B * M, 2 * C, C, false,
                    s)))
    return err;
  const long long qsb = (long long)N * C, ksb = (long long)M * 2 * C;
  if (int rc = emip_attention_fwd(q_buf, qsb, C, kv_buf, ksb, 2 * C,
                                  kv_buf + C, ksb, 2 * C, nullptr, 1, o_buf,
                                  qsb, C, stats, ws, ws_floats, B, heads, N,
                                  M, ch, 0, stream))
    return rc;
  if ((err = linear(o_buf, C, wp, bp, out, C, B * N, C, C, false, s)))
    return err;
  return (int)cudaGetLastError();
}

// The bf16 forward (the bf16 band of short inference), as the JAX kernel
// computes it with a bf16 storage dtype: x, kv_in and the three weights
// bf16, the biases fp32. q = bf16(x Wq^T + bq) and [k | v] = bf16(kv_in
// Wkv^T + bkv) (fp32 sums, the bias added before the one rounding), o the
// bf16 attention of attention_bf16.cu per head (fp32 scores and softmax, P
// rounded to bf16 for P v), out = bf16(o Wp^T + bp). Four launches, as the
// fp32 forward; no statistics are kept: there is no bf16 backward yet.
extern "C" int emip_sr_attention_bf16(const void* x, const void* kv_in,
                                      const void* wq, const float* bq,
                                      const void* wkv, const float* bkv,
                                      const void* wp, const float* bp,
                                      void* q_buf, void* kv_buf, void* o_buf,
                                      void* out, int B, int N, int M, int C,
                                      int heads, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ch = C / heads;
  const bf16 *xb = static_cast<const bf16*>(x),
             *kvb = static_cast<const bf16*>(kv_in);
  bf16* kvbuf = static_cast<bf16*>(kv_buf);
  cudaError_t err;
  if ((err = linear_bf16(xb, C, static_cast<const bf16*>(wq), C, bq, q_buf, C,
                         B * N, C, C, true, s)))
    return err;
  if ((err = linear_bf16(kvb, C, static_cast<const bf16*>(wkv), C, bkv,
                         kv_buf, 2 * C, B * M, 2 * C, C, true, s)))
    return err;
  const long long qsb = (long long)N * C, ksb = (long long)M * 2 * C;
  if (int rc = emip_attention_fwd_bf16(q_buf, qsb, C, kvbuf, ksb, 2 * C,
                                       kvbuf + C, ksb, 2 * C, nullptr, 1,
                                       o_buf, qsb, C, B, heads, N, M, ch, ch,
                                       0, stream))
    return rc;
  if ((err = linear_bf16(static_cast<const bf16*>(o_buf), C,
                         static_cast<const bf16*>(wp), C, bp, out, C, B * N,
                         C, C, true, s)))
    return err;
  return (int)cudaGetLastError();
}

// g: [B, N, C] gradient of out. q_buf, kv_buf, o_buf, stats: the forward's
// saved intermediates and row statistics. Grads whose pointer is null are
// not computed. go, gq [B, N, C] and gkv [B, M, 2C] are scratch; ws is the
// split-K / attention workspace.
extern "C" int emip_sr_attention_bwd(
    const float* x, const float* kv_in, const float* wq, const float* wkv,
    const float* wp, const float* q_buf, const float* kv_buf,
    const float* o_buf, const float* stats, const float* g, float* gx,
    float* gkv_in, float* gwq, float* gbq, float* gwkv, float* gbkv,
    float* gwp, float* gbp, float* go, float* gq, float* gkv, float* ws,
    long long ws_floats, int B, int N, int M, int C, int heads,
    void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w{ws, ws_floats};
  const int ch = C / heads;
  const int rq = B * N, rk = B * M;
  const bool want_q = gx || gwq || gbq, want_kv = gkv_in || gwkv || gbkv;
  cudaError_t err;
#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;

  // out = o Wp^T + bp
  EMIP_TRY(weight_grad(g, C, o_buf, C, gwp, C, C, rq, w, s));
  EMIP_TRY(colsum(g, C, rq, C, gbp, w, s));
  if (!want_q && !want_kv) return (int)cudaGetLastError();
  EMIP_TRY(input_grad(g, C, wp, C, C, go, C, rq, false, s));

  // o = attention(q, k, v), one batch row per (image, head)
  const long long qsb = (long long)N * C, ksb = (long long)M * 2 * C;
  const AttnOperand qo{q_buf, qsb, C}, ko{kv_buf, ksb, 2 * C},
      vo{kv_buf + C, ksb, 2 * C}, oo{o_buf, qsb, C}, goo{go, qsb, C};
  const AttnGrad dq{want_q ? gq : nullptr, qsb, C},
      dk{want_kv ? gkv : nullptr, ksb, 2 * C},
      dv{want_kv ? gkv + C : nullptr, ksb, 2 * C};
  const float* row_sum = stats + (long long)B * heads * N;
  const float scale = 1.0f / sqrtf((float)ch);
  if (ch == 64)
    err = attention_bwd_tc<64, 64, kSrBwdWarps, kSrBwdMt, kSrBwdStr>(
        qo, ko, vo, oo, goo, nullptr, nullptr, 1, stats, row_sum, dq, dk, dv,
        B, heads, N, M, scale, w, s);
  else if (ch == 32)
    err = attention_bwd_tc<32, 32, kSrBwdWarps, kSrBwdMt, kSrBwdStr>(
        qo, ko, vo, oo, goo, nullptr, nullptr, 1, stats, row_sum, dq, dk, dv,
        B, heads, N, M, scale, w, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

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

// The bf16 backward. x [B, N, C], kv_in [B, M, C], wq, wp [C, C], wkv [2C,
// C] and g [B, N, C] bf16, the biases fp32. gx, gkv_in and the weight grads
// are written in bf16, the bias grads in fp32; each only when its pointer
// is set. ws: fp32 scratch for the recomputed q, [k | v], o and row
// statistics and for go, gq and gkv, then the attention's and the split-K
// and column sums' workspace.
extern "C" int emip_sr_attention_bwd_bf16(
    const void* x, const void* kv_in, const void* wq, const float* bq,
    const void* wkv, const float* bkv, const void* wp, const float* bp,
    const void* g, void* gx, void* gkv_in, void* gwq, float* gbq, void* gwkv,
    float* gbkv, void* gwp, float* gbp, float* ws, long long ws_floats,
    int B, int N, int M, int C, int heads, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nq = (long long)B * N * C, nk = (long long)B * M * C;
  const int ch = C / heads;
  const int rq = B * N, rk = B * M;
  const bf16 *xb = static_cast<const bf16*>(x),
             *kvb = static_cast<const bf16*>(kv_in),
             *wqb = static_cast<const bf16*>(wq),
             *wkvb = static_cast<const bf16*>(wkv),
             *wpb = static_cast<const bf16*>(wp),
             *gb = static_cast<const bf16*>(g);
  bf16 *gxb = static_cast<bf16*>(gx), *gkvb = static_cast<bf16*>(gkv_in);
  const bool want_q = gx || gwq || gbq, want_kv = gkv_in || gwkv || gbkv;
  Workspace all{ws, ws_floats};
  float* q_buf = all.take(nq);
  float* kv_buf = all.take(2 * nk);
  float* o_buf = all.take(nq);
  float* stats = all.take(2LL * B * heads * N);
  float* go = all.take(nq);
  float* gq = all.take(nq);
  float* gkv = all.take(2 * nk);
  if (!q_buf || !kv_buf || !o_buf || !stats || !go || !gq || !gkv)
    return (int)cudaErrorInvalidValue;
  const Workspace w = all;
  cudaError_t err;
#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;

  // the forward up to o and the row statistics: q = x Wq^T + bq and [k | v]
  // = kv_in Wkv^T + bkv on bf16 operands, the attention in fp32
  EMIP_TRY(linear_exact(xb, C, wqb, bq, q_buf, C, rq, C, C, s));
  EMIP_TRY(linear_exact(kvb, C, wkvb, bkv, kv_buf, 2 * C, rk, 2 * C, C, s));
  const long long qsb = (long long)N * C, ksb = (long long)M * 2 * C;
  if (int rc = emip_attention_fwd(q_buf, qsb, C, kv_buf, ksb, 2 * C,
                                  kv_buf + C, ksb, 2 * C, nullptr, 1, o_buf,
                                  qsb, C, stats, w.p, w.n, B, heads, N, M, ch,
                                  0, stream))
    return rc;

  // out = o Wp^T + bp
  EMIP_TRY(weight_grad_exact(gb, C, o_buf, C, static_cast<bf16*>(gwp), C, C,
                             rq, w, s));
  EMIP_TRY(colsum(reinterpret_cast<const uint16_t*>(gb), C, rq, C, gbp, w,
                  s));
  if (!want_q && !want_kv) return (int)cudaGetLastError();
  EMIP_TRY(input_grad_exact(gb, C, wpb, C, C, go, C, rq, s));

  // o = attention(q, k, v), one batch row per (image, head), in fp32
  const AttnOperand qo{q_buf, qsb, C}, ko{kv_buf, ksb, 2 * C},
      vo{kv_buf + C, ksb, 2 * C}, oo{o_buf, qsb, C}, goo{go, qsb, C};
  const AttnGrad dq{want_q ? gq : nullptr, qsb, C},
      dk{want_kv ? gkv : nullptr, ksb, 2 * C},
      dv{want_kv ? gkv + C : nullptr, ksb, 2 * C};
  const float* row_sum = stats + (long long)B * heads * N;
  const float scale = 1.0f / sqrtf((float)ch);
  if (ch == 64)
    err = attention_bwd_tc<64, 64, kSrBwdWarps, kSrBwdMt, kSrBwdStr>(
        qo, ko, vo, oo, goo, nullptr, nullptr, 1, stats, row_sum, dq, dk, dv,
        B, heads, N, M, scale, w, s);
  else if (ch == 32)
    err = attention_bwd_tc<32, 32, kSrBwdWarps, kSrBwdMt, kSrBwdStr>(
        qo, ko, vo, oo, goo, nullptr, nullptr, 1, stats, row_sum, dq, dk, dv,
        B, heads, N, M, scale, w, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  // q = x Wq^T + bq; [k | v] = kv_in Wkv^T + bkv
  EMIP_TRY(weight_grad_exact(gq, C, xb, C, static_cast<bf16*>(gwq), C, C, rq,
                             w, s));
  EMIP_TRY(colsum(gq, C, rq, C, gbq, w, s));
  EMIP_TRY(weight_grad_exact(gkv, 2 * C, kvb, C, static_cast<bf16*>(gwkv),
                             2 * C, C, rk, w, s));
  EMIP_TRY(colsum(gkv, 2 * C, rk, 2 * C, gbkv, w, s));
  if (gx) EMIP_TRY(input_grad_exact(gq, C, wqb, C, C, gxb, C, rq, s));
  if (gkv_in)
    EMIP_TRY(input_grad_exact(gkv, 2 * C, wkvb, 2 * C, C, gkvb, C, rk, s));
#undef EMIP_TRY
  return (int)cudaGetLastError();
}
