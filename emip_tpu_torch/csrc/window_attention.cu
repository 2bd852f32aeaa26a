// Kernels B, G and H: the GMFlow swin transformer per window, forward and
// backward. B is one whole TransformerBlock (self-attention layer, then
// cross-attention + FFN layer); G and H are its two layers as entry points
// of their own, which the model runs where a window is too large for B
// (T = 1024 tokens at 512^2).
//
// Replaces emip_tpu/ops/pallas/window_attention.py:
//   B  fused_window_attention_block      (_block_kernel, _block_bwd_kernel)
//   G  fused_window_attention_layer      (_kernel, _kernel_rows, _bwd_kernel)
//   H  fused_window_attention_ffn_layer  (_ffn_kernel, _ffn_kernel_rows,
//                                         _ffn_bwd_kernel)
// Per window of T tokens, with msg(a, b) = LN1(softmax(a Wq (b Wk)^T /
// sqrt(C) + mask) b Wv Wm):
//   G    out = msg(x, t) (+ x with add_residual)
//   H    out = x + LN2(gelu_exact([x, msg(x, t)] W0) W2)
//   B    x1 = G(x, x) with the self layer's weights, out = H(x1, t)
// The [K*K, T, T] shift mask (or none) applies to every attention.
//
// What bounds them on the card: arithmetic. The projections and the FFN
// (256 -> 1024 -> 128) are ~85% of B's FLOPs and run as the shared 3xTF32
// GEMM on the tensor cores (gemm_tf32.cuh; in the bf16 forwards of B and H
// and, but for the weight grads, in the bf16 backwards of G and H the
// wgmma product of gemm_wgmma.cuh) over all B*K*K*T rows at once;
// the attention forward is attention_fwd_tc of mma_tf32.cuh (3xTF32 on the
// tensor cores; its tilings and where the shift mask is read in
// attention.cu): a block owns 256 query rows of one window and streams
// the window's keys and values in tiles of 32. It takes any T: at T = 484
// the last key tile is masked by -inf and the last query tile is
// bounds-checked, T = 1024 is a whole number of tiles. So the TPU's split
// into a whole-window form and a row-tiled form with the window's k / v in
// VMEM scratch has no counterpart: one q-tiled family serves every T (at T
// = 484 and 64 windows 128 blocks; at T = 1024 and 8 windows the keys are
// split four ways and the partials merged in order, in the forward's
// workspace). B is 12 launches, G 6 and H 9 (a split adds a merge each),
// instead of one grid cell per window; the TPU kernels fused them to save
// per-cell sequencing overhead, which does not exist in this form. x (B:
// x1) and msg are written side by side into one [R, 2C] buffer, so [x, msg]
// W0 is one GEMM against the reference's one [F, 2C] weight (the TPU
// kernel takes W0 in two halves).
//
// Backward: the TPU kernels recompute the whole layer per window. Here a
// forward that will be differentiated keeps every intermediate (q/k/v,
// attention output, its row max and sum and the pre-LN message of each
// layer, the concat, the FFN pre-activation h and u = gelu(h), and z = u
// W2^T; about 0.43 GB for B at R = 30,976 rows), so the backward recomputes
// only the attention probabilities. Order: LN2 -> W2 -> GELU' (fused into
// the W2 grad GEMM) -> the split W0 -> message (LN1 -> Wm -> attention
// backward, k and v from t giving gt) -> for B the residual and the self
// layer's message.
// Input grads that read one gradient block run over the weights stacked in
// the workspace: gt = [gk | gv] [Wk; Wv], and in B's self layer, where x
// gives q, k and v, gx += [gq | gk | gv] [Wq; Wk; Wv]; each weight grad is
// a product of its own. The attention backward is attention_bwd_tc of
// mma_tf32.cuh (3xTF32 on the tensor cores; 8 warps own 128 rows of one
// window, the other side streams in tiles of 32; the shifted-window mask is
// read per tile from L2 into the score fragments): at T = 484 and 64
// windows each pass is 256 blocks, at T = 1024 and 16 windows 128. The
// weight grads are split-K GEMMs and ordered column sums, each only when
// its pointer is set (GMFlow is frozen on the train path, so only gx and gt
// are asked for); dk and dv are computed only where gt or the k / v weight
// grads are wanted. The inference forward passes one buffer where the
// backward would need two.
//
// G's and H's bf16 forwards (the bf16 band at 512^2), bf16 x, t and out,
// fp32 parameters, as the JAX kernels (_kernel / _kernel_rows, _ffn_kernel
// / _ffn_kernel_rows) compute them with a bf16 storage dtype; they are the
// two halves of B's bf16 forward below. G in bf16: q = bf16(x Wq), k, v =
// bf16(t W) (one launch of the bf16 wgmma product of gemm_wgmma.cuh over
// the weights cast at use), the bf16 attention (fp32 softmax, P rounded
// for P v), m = o Wm in fp32 and out = bf16(x + bf16(LN1(m))) or
// bf16(LN1(m)) in that product's epilogue: three launches. H: the
// fp32 layer on the fp32 weights with x and t read as bf16 where they lie
// (cross_ffn_bf16), the output rounded once.
// cross_ffn_bf16 runs H's products on the wgmma product of gemm_wgmma.cuh
// (3xTF32, two terms where A is bf16): the weights split into their TF32
// halves once per call, q, k, v one launch (x and t bf16, two terms), the
// 3xTF32 attention_fwd_tc, msg = LN1(o Wm^T) in Wm's epilogue, u =
// gelu(x W0[:, :C]^T + msg W0[:, C:]^T) with W0 in JAX's two halves (x's
// K tiles first, two terms, then msg's, three; no concat buffer), out =
// bf16(x + LN2(u W2^T)) in W2's epilogue: 6 launches (7 where the
// attention splits its keys), no upcast scratch.
// Their bf16 backwards (the bf16 train step at 512^2) recompute the layer
// in fp32 (the forward's bf16 buffers are not the JAX backward's) and run
// its backward, gx and gt rounded once, as B's below; they read x, t and
// the gradient as bf16 where they lie and run the recompute's x W^T and
// the input grads dy W on the wgmma product (dy W on the transposed
// weights, split once a call), the attention on attention_fwd_tc (with its
// statistics) and attention_bwd_tc, the weight grads on gemm_tf32.cuh: no
// upcast scratch, no conversion launch, no concat buffer.
//
// B's bf16 backward (the bf16 train step), as the JAX kernel
// (_block_bwd_kernel) computes it with a bf16 storage dtype: the self
// layer recomputed in fp32 on the fp32 weights (message_fwd; the bf16
// forward's self layer ran bf16 products, so its buffers are not the JAX
// backward's and are not kept), x1 = bf16(x + bf16(LN1s(m))) as the
// forward rounded it (layernorm_self_bf16 fed with the fp32 m), the fp32
// cross layer and FFN with their buffers kept, then the block backward,
// which passes x1's roundings straight through; gx and gt are rounded to
// bf16, the parameter grads stay fp32. It reads x, t and the gradient as
// bf16 where they lie: the GEMM copies their bf16 tiles and widens them as
// the fragments are built, LN2's backward and the residual into gx1 read
// the gradient's bf16 bits. A bf16 value is exact in TF32, and so is x1,
// kept in fp32 in cat (read as ExactF32), so the products they enter take
// two TF32 terms instead of three: x Wq1, x Wk1, x Wv1, x1 Wq2, t Wk2,
// t Wv2, and the grads of those six weights; the terms left out add +0, so
// every grad has the bits of the fp32 backward on the upcast inputs. [x1,
// msg] W0^T and its weight grad keep three (one product over both halves
// of K: two would sum in another order). Each rounding is in the epilogue
// of the product that finishes its grad: gt = bf16([gk | gv] [Wk2; Wv2]),
// gx = bf16(gx1 + [gq | gk | gv] [Wq1; Wk1; Wv1]), the addend read there
// (so the fp32 backward, too, adds its residuals in the epilogue: gx1 = g
// + (gh W0)[:, :C] with no copy of g first). No upcast scratch and no
// conversion launches.

#include "attention_bf16.cuh"
#include "attention_fwd.cuh"
#include "gemm_tf32.cuh"
#include "gemm_wgmma.cuh"

// the tiling of the attention backward: warps, fragments of 16 resident
// rows per warp, streamed rows per stage
constexpr int kWinBwdWarps = 8;
constexpr int kWinBwdMt = 1;
constexpr int kWinBwdStr = 32;

namespace emip {
namespace {

#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return err;

// The windows of one call: `windows` of T tokens and C channels, and the
// additive mask [mask_nw, T, T] (or null) that window i reads at i % mask_nw.
struct Windows {
  int windows, T, C;
  const float* mask;
  int mask_nw;
  int rows() const { return windows * T; }
};

struct LayerWeights {
  const float *wq, *wk, *wv, *wm;
};
struct LayerGrads {  // each null: not wanted
  float *gwq, *gwk, *gwv, *gwm, *gs1, *gb1;
};

// m = softmax(xq Wq (t Wk)^T / sqrt(C) + mask) t Wv Wm, the message before
// its LayerNorm. xq [R, C] with leading dimension ldxq; qkv [R, 3C]; stats
// [2, windows, T] (the attention's row max and sum) or null; ws holds the
// attention's key-split partials. xq and t: fp32, or exact (bf16, or
// ExactF32: bf16 values in fp32), whose projections take two TF32 terms
// (linear_exact).
template <typename TX, typename TT>
cudaError_t message_fwd(const TX* xq, int ldxq, const TT* t, LayerWeights w,
                        Windows d, float* qkv, float* o, float* m,
                        float* stats, Workspace ws, cudaStream_t s) {
  const int R = d.rows(), C = d.C, C3 = 3 * C;
  const long long wsb = (long long)d.T * C3;  // window stride inside qkv
  cudaError_t err;
  EMIP_TRY(linear_exact(xq, ldxq, w.wq, nullptr, qkv, C3, R, C, C, s));
  EMIP_TRY(linear_exact(t, C, w.wk, nullptr, qkv + C, C3, R, C, C, s));
  EMIP_TRY(linear_exact(t, C, w.wv, nullptr, qkv + 2 * C, C3, R, C, C, s));
  EMIP_TRY((cudaError_t)emip_attention_fwd(
      qkv, wsb, C3, qkv + C, wsb, C3, qkv + 2 * C, wsb, C3, d.mask, d.mask_nw,
      o, (long long)d.T * C, C, stats, ws.p, ws.n, d.windows, 1, d.T, d.T, C,
      1, s));
  return linear(o, C, w.wm, nullptr, m, C, R, C, C, false, s);
}

// The attention backward of a layer on its forward's buffers (qkv [R, 3C],
// o [R, C], stats its row max, then row sum) for go, the gradient of o:
// dq (want_q) and dk, dv (want_kv) into gqkv [R, 3C]. attention_bwd_tc of
// mma_tf32.cuh (3xTF32) with the window mask.
cudaError_t layer_attention_bwd(const float* qkv, const float* o,
                                const float* go, const float* stats,
                                bool want_q, bool want_kv, float* gqkv,
                                Windows d, Workspace ws, cudaStream_t s) {
  const int C = d.C, C3 = 3 * C, C2 = 2 * C;
  const long long sb3 = (long long)d.T * C3, sb1 = (long long)d.T * C;
  const AttnOperand q{qkv, sb3, C3}, k{qkv + C, sb3, C3},
      v{qkv + C2, sb3, C3}, oo{o, sb1, C}, goo{go, sb1, C};
  const AttnGrad dq{want_q ? gqkv : nullptr, sb3, C3},
      dk{want_kv ? gqkv + C : nullptr, sb3, C3},
      dv{want_kv ? gqkv + C2 : nullptr, sb3, C3};
  const float* row_sum = stats + (long long)d.rows();
  const float scale = 1.0f / sqrtf((float)C);
  if (C == 128)
    return attention_bwd_tc<128, 128, kWinBwdWarps, kWinBwdMt, kWinBwdStr,
                            true>(
        q, k, v, oo, goo, nullptr, d.mask, d.mask_nw, stats, row_sum, dq, dk,
        dv, d.windows, 1, d.T, d.T, scale, ws, s);
  if (C == 64)
    return attention_bwd_tc<64, 64, kWinBwdWarps, kWinBwdMt, kWinBwdStr,
                            true>(
        q, k, v, oo, goo, nullptr, d.mask, d.mask_nw, stats, row_sum, dq, dk,
        dv, d.windows, 1, d.T, d.T, scale, ws, s);
  return cudaErrorInvalidValue;
}

// An input grad that one product finishes: fp32 at p, or with bf16 rounded
// to bf16 there in its epilogue; add (fp32, bf16 with add_bf16, or null;
// leading dimension ldadd, or the grad's width where 0) is added first.
struct GradOut {
  void* p;  // null: not wanted
  bool bf16;
  const void* add;
  bool add_bf16 = false;
  long long ldadd = 0;
};

// out = (out.add +) dy W for W [N, K] read in place, on gemm_tf32.cuh: dy
// [R, N] (leading dimension ldy), out [R, K].
cudaError_t input_grad_out(const float* dy, int ldy, const float* W, int N,
                           int K, GradOut out, int R, cudaStream_t s) {
  GemmArgs a = gemm_args(dy, ldy, 1, W, K, 1, static_cast<float*>(out.p), K,
                         R, K, N);
  a.c_bf16 = out.bf16;
  a.add = out.add;
  a.ldadd = out.ldadd ? out.ldadd : K;
  a.add_bf16 = out.add_bf16;
  return gemm(a, kEpiNone, s);
}

// Backward of msg = LN1(m) with m from message_fwd (stats its attention's
// row statistics). gmsg [R, C] (leading dimension ldg) is the gradient of
// msg. Writes the weight grads that are set, gxq = (gxq.add +) gq Wq (or
// gxq += gq Wq with accumulate_xq) if gxq is set, and gt = (gt.add +) gk
// Wk + gv Wv if gt is set. In B's self layer (self_layer: xq is t, and q,
// k and v all come from it) gxq is unset and gt = (gt.add +) gq Wq + gk Wk
// + gv Wv. gm, go [R, C] and gqkv [R, 3C] are scratch; the stacked weights
// come from ws. xq and t as in message_fwd: an exact one makes its weight
// grads two-term products.
template <typename TX, typename TT>
cudaError_t message_bwd(const TX* xq, int ldxq, const TT* t, LayerWeights w,
                        const float* s1, Windows d, const float* qkv,
                        const float* o, const float* m, const float* stats,
                        const float* gmsg, int ldg, LayerGrads g, GradOut gxq,
                        bool accumulate_xq, GradOut gt, bool self_layer,
                        float* gm, float* go, float* gqkv, float eps,
                        Workspace ws, cudaStream_t s) {
  const int R = d.rows(), C = d.C, C3 = 3 * C, C2 = 2 * C;
  const bool want_q = gxq.p || g.gwq || (self_layer && gt.p),
             want_kv = gt.p || g.gwk || g.gwv;
  cudaError_t err;
  EMIP_TRY(layernorm_bwd(m, C, gmsg, ldg, s1, gm, C, false, g.gs1, g.gb1, R,
                         C, eps, ws, s));
  EMIP_TRY(weight_grad(gm, C, o, C, g.gwm, C, C, R, ws, s));
  if (!want_q && !want_kv) return cudaSuccess;
  EMIP_TRY(input_grad(gm, C, w.wm, C, C, go, C, R, false, s));
  EMIP_TRY(layer_attention_bwd(qkv, o, go, stats, want_q, want_kv, gqkv, d,
                               ws, s));
  EMIP_TRY(weight_grad_exact(gqkv, C3, xq, ldxq, g.gwq, C, C, R, ws, s));
  EMIP_TRY(weight_grad_exact(gqkv + C, C3, t, C, g.gwk, C, C, R, ws, s));
  EMIP_TRY(weight_grad_exact(gqkv + C2, C3, t, C, g.gwv, C, C, R, ws, s));
  // q, k and v are one [R, 3C] block of gqkv: the input grads that share an
  // input run as one product over the weights stacked in the workspace
  // ([Wk; Wv], in the self layer [Wq; Wk; Wv])
  auto stacked = [&](const float* const* wt, int n) -> const float* {
    float* st = ws.take((long long)n * C * C);
    for (int i = 0; st && i < n; ++i)
      if (cudaMemcpyAsync(st + (long long)i * C * C, wt[i],
                          (long long)C * C * sizeof(float),
                          cudaMemcpyDeviceToDevice, s) != cudaSuccess)
        return nullptr;
    return st;
  };
  if (gxq.p && accumulate_xq) {
    EMIP_TRY(input_grad(gqkv, C3, w.wq, C, C, static_cast<float*>(gxq.p), C,
                        R, true, s));
  } else if (gxq.p) {
    EMIP_TRY(input_grad_out(gqkv, C3, w.wq, C, C, gxq, R, s));
  }
  if (gt.p) {
    const float* const wqkv[3] = {w.wq, w.wk, w.wv};
    const int first = self_layer ? 0 : 1;
    const float* st = stacked(wqkv + first, 3 - first);
    if (!st) return cudaErrorInvalidValue;
    GemmArgs a = gemm_args(gqkv + first * C, C3, 1, st, C, 1,
                           static_cast<float*>(gt.p), C, R, C,
                           (3 - first) * C);
    a.c_bf16 = gt.bf16;
    a.add = gt.add;
    a.ldadd = C;
    EMIP_TRY(gemm(a, kEpiNone, s));
  }
  return cudaSuccess;
}

// out = cat[:, :C] + LN2(gelu(cat W0^T) W2^T) for cat = [x, msg] [R, 2C];
// h (the pre-activation) is written only when it is set.
cudaError_t ffn_fwd(const float* cat, const float* w0, const float* w2,
                    const float* s2, const float* b2, float* h, float* u,
                    float* z, float* out, int R, int C, int F, float eps,
                    cudaStream_t s) {
  cudaError_t err;
  EMIP_TRY(linear(cat, 2 * C, w0, nullptr, u, F, R, F, 2 * C, true, s, h, F));
  EMIP_TRY(linear(u, F, w2, nullptr, z, C, R, C, F, false, s));
  layernorm(z, C, cat, 2 * C, s2, b2, out, C, R, C, eps, s);
  return cudaGetLastError();
}

// Backward of ffn_fwd for the gradient g [R, C] of out (fp32, or bf16 read
// as it lies): gmsg [R, C], the weight grads that are set and, if gx is
// set, gx = g + (gh W0)[:, :C] (the residual, added in the product's
// epilogue, and the x half of the concat). gz [R, C] and gh [R, F] are
// scratch.
template <typename TG>
cudaError_t ffn_bwd(const float* cat, const float* h, const float* u,
                    const float* z, const TG* g, const float* w0,
                    const float* w2, const float* s2, float* gw0, float* gw2,
                    float* gs2, float* gb2, float* gz, float* gh, float* gx,
                    float* gmsg, int R, int C, int F, float eps, Workspace ws,
                    cudaStream_t s) {
  const int C2 = 2 * C;
  cudaError_t err;
  EMIP_TRY(layernorm_bwd(z, C, reinterpret_cast<const GemmElem<TG>*>(g), C,
                         s2, gz, C, false, gs2, gb2, R, C, eps, ws, s));
  EMIP_TRY(weight_grad(gz, C, u, F, gw2, C, F, R, ws, s));
  {
    GemmArgs a = gemm_args(gz, C, 1, w2, F, 1, gh, F, R, F, C);
    a.aux = const_cast<float*>(h);
    a.ldaux = F;
    EMIP_TRY(gemm(a, kEpiGeluGrad, s));  // gh = (gz W2) * gelu'(h)
  }
  EMIP_TRY(weight_grad(gh, F, cat, C2, gw0, F, C2, R, ws, s));
  if (gx) {
    GemmArgs a = gemm_args(gh, F, 1, w0, C2, 1, gx, C, R, C, F);
    a.add = g;
    a.ldadd = C;
    a.add_bf16 = std::is_same_v<TG, __nv_bfloat16>;
    EMIP_TRY(gemm(a, kEpiNone, s));
  }
  GemmArgs a = gemm_args(gh, F, 1, w0 + C, C2, 1, gmsg, C, R, C, F);
  return gemm(a, kEpiNone, s);
}

// B's backward from its forward's buffers (kept, or recomputed): out = x1 +
// LN2c(gelu([x1, msg] W0^T) W2^T), msg = LN1c(message(x1, t)), x1 = x +
// LN1s(message(x, x)). x, t and the gradient g are TX, TT, TG (fp32, or
// bf16 read as it lies); x1 = cat[:, :C] is read as TX1 (float, or
// ExactF32 where it holds bf16 values); gx and gt are written as their
// GradOut says. all holds the [R, 8C + F] activation-grad scratch and the
// split-K / column-sum / attention workspace behind it.
template <typename TX, typename TT, typename TX1, typename TG>
cudaError_t block_bwd(const TX* x, const TT* t, LayerWeights w1,
                      const float* s1, LayerWeights w2, const float* sa,
                      const float* w0, const float* wf2, const float* sb,
                      Windows d, const float* qkv1, const float* qkv2,
                      const float* o1, const float* o2, const float* m1,
                      const float* m2, const float* stats1,
                      const float* stats2, const float* cat, const float* h,
                      const float* u, const float* z, const TG* g, GradOut gx,
                      GradOut gt, LayerGrads g1, LayerGrads g2, float* gw0,
                      float* gw2, float* gsb, float* gbb, int F, float eps,
                      Workspace all, cudaStream_t s) {
  const int R = d.rows(), C = d.C, C2 = 2 * C;
  const long long rc = (long long)R * C;
  float* gz = all.take(rc);
  float* gh = all.take((long long)R * F);
  float* gx1 = all.take(rc);
  float* gmsg = all.take(rc);
  float* gm = all.take(rc);
  float* go = all.take(rc);
  float* gqkv = all.take(3 * rc);
  if (!gz || !gh || !gx1 || !gmsg || !gm || !go || !gqkv)
    return cudaErrorInvalidValue;
  cudaError_t err;
  // out = x1 + LN2c(gelu([x1, msg] W0^T) W2^T)
  EMIP_TRY(ffn_bwd(cat, h, u, z, g, w0, wf2, sb, gw0, gw2, gsb, gbb, gz, gh,
                   gx1, gmsg, R, C, F, eps, all, s));
  // msg = LN1c(message(x1, t)): q from x1, k and v from t
  EMIP_TRY(message_bwd(reinterpret_cast<const TX1*>(cat), C2, t, w2, sa, d,
                       qkv2, o2, m2, stats2, gmsg, C, g2,
                       GradOut{gx1, false, nullptr}, true, gt, false, gm, go,
                       gqkv, eps, all, s));
  // x1 = x + LN1s(message(x, x)): q, k and v from x; gx = gx1 + their grads
  gx.add = gx1;
  return message_bwd(x, C, x, w1, s1, d, qkv1, o1, m1, stats1, gx1, C, g1,
                     GradOut{nullptr, false, nullptr}, false, gx, true, gm,
                     go, gqkv, eps, all, s);
}

// H's layer in the bf16 band (B's cross layer and FFN on its bf16 x1): out
// = bf16(x + LN2(gelu([x, msg] W0^T) W2^T)), msg = LN1(message(x, t)),
// every product on the wgmma product of gemm_wgmma.cuh. x, t, out [R, C]
// bf16; the weights fp32, split into their TF32 halves in wsplit [8 C^2 + 6
// C F]; fp32 buffers qkv [R, 3C], o, msg [R, C], u [R, F]; ws holds the
// attention's key-split partials.
cudaError_t cross_ffn_bf16(const bf16* x, const bf16* t, LayerWeights w,
                           const float* s1, const float* b1, const float* w0,
                           const float* w2, const float* s2, const float* b2,
                           Windows d, int F, float* wsplit, float* qkv,
                           float* o, float* msg, float* u, bf16* out,
                           float eps, Workspace ws, cudaStream_t s) {
  const int R = d.rows(), C = d.C, C3 = 3 * C;
  const long long cc = (long long)C * C, cf = (long long)C * F;
  float* sqkv = wsplit;      // [Wq; Wk; Wv]: hi [3C, C], then lo
  float* sm = sqkv + 6 * cc;  // Wm [2C, C]
  float* s0 = sm + 2 * cc;    // W0 [2F, 2C]
  float* sw2 = s0 + 4 * cf;   // W2 [2C, F]
  WgSplitArgs sa;
  sa.seg[0] = WgSplitSeg{w.wq, sqkv, sqkv + 3 * cc, C, C, C, false};
  sa.seg[1] = WgSplitSeg{w.wk, sqkv + cc, sqkv + 4 * cc, C, C, C, false};
  sa.seg[2] = WgSplitSeg{w.wv, sqkv + 2 * cc, sqkv + 5 * cc, C, C, C, false};
  sa.seg[3] = WgSplitSeg{w.wm, sm, sm + cc, C, C, C, false};
  sa.seg[4] = WgSplitSeg{w0, s0, s0 + 2 * cf, F, 2 * C, 2 * C, false};
  sa.seg[5] = WgSplitSeg{w2, sw2, sw2 + cf, C, F, F, false};
  cudaError_t err;
  EMIP_TRY(wg_split_weights(sa, 6, s));
  const WgSource xs{x, C, C}, ts{t, C, C}, no{nullptr, 0, 0};
  const WgEpilogue plain{nullptr, nullptr, nullptr, 0, eps};
  // q from x, k and v from t: one launch over [Wq; Wk; Wv]
  EMIP_TRY((wg_linear<uint16_t, uint16_t, kWgEpiNone>(
      xs, ts, C, sqkv, R, C3, C, qkv, C3, plain, s)));
  const long long wsb = (long long)d.T * C3;
  EMIP_TRY((cudaError_t)emip_attention_fwd(
      qkv, wsb, C3, qkv + C, wsb, C3, qkv + 2 * C, wsb, C3, d.mask, d.mask_nw,
      o, (long long)d.T * C, C, nullptr, ws.p, ws.n, d.windows, 1, d.T, d.T,
      C, 1, s));
  EMIP_TRY((wg_linear<float, float, kWgEpiLn>(
      WgSource{o, C, C}, no, C, sm, R, C, C, msg, C,
      WgEpilogue{s1, b1, nullptr, 0, eps}, s)));
  EMIP_TRY((wg_linear<uint16_t, float, kWgEpiGelu>(
      xs, WgSource{msg, C, C}, F, s0, R, F, 128, u, F, plain, s)));
  return wg_linear<float, float, kWgEpiLnOut>(
      WgSource{u, F, F}, no, C, sw2, R, C, C, out, C,
      WgEpilogue{s2, b2, x, C, eps}, s);
}

// G's and H's weights split into their TF32 halves once per call for the
// wgmma product, each [2N, K] (hi rows, then lo rows): as they are for the
// recompute's x W^T, transposed for the input grads' dy W = dy (W^T)^T
// that run on it (go, gt and H's gh W0; gx and H's gh stay on mma.sync,
// where the card ran them faster: gemm_wgmma lines of chip_smoke.py).
struct SplitLayer {
  float* qkv;  // [Wq; Wk; Wv]: N 3C, K C
  float* m;    // Wm
  float* mt;   // Wm^T
  float* kvt;  // [Wk; Wv]^T = [Wk^T | Wv^T]: N C, K 2C
  float* w0;   // W0: N F, K 2C (H only)
  float* w2;   // W2: N C, K F
  float* w0t;  // W0^T: N 2C, K F
};

inline long long split_layer_floats(int C, int F) {
  return 14LL * C * C + 10LL * C * F;
}

// one launch: G's four weights (F = 0), or H's six
cudaError_t split_layer(LayerWeights w, const float* w0, const float* w2,
                        int C, int F, float* p, SplitLayer* sl,
                        cudaStream_t s) {
  const long long cc = (long long)C * C, cf = (long long)C * F;
  sl->qkv = p;
  sl->m = sl->qkv + 6 * cc;
  sl->mt = sl->m + 2 * cc;
  sl->kvt = sl->mt + 2 * cc;
  sl->w0 = sl->kvt + 4 * cc;
  sl->w2 = sl->w0 + 4 * cf;
  sl->w0t = sl->w2 + 2 * cf;
  WgSplitArgs a;
  int n = 0;
  // src [rows, cols] into hi at ld (lo n_lo floats after it)
  auto seg = [&](const float* src, float* hi, long long n_lo, int rows,
                 int cols, long long ld, bool transpose) {
    a.seg[n++] = WgSplitSeg{src, hi, hi + n_lo, rows, cols, ld, transpose};
  };
  seg(w.wq, sl->qkv, 3 * cc, C, C, C, false);
  seg(w.wk, sl->qkv + cc, 3 * cc, C, C, C, false);
  seg(w.wv, sl->qkv + 2 * cc, 3 * cc, C, C, C, false);
  seg(w.wm, sl->m, cc, C, C, C, false);
  seg(w.wm, sl->mt, cc, C, C, C, true);
  seg(w.wk, sl->kvt, 2 * cc, C, C, 2 * C, true);
  seg(w.wv, sl->kvt + C, 2 * cc, C, C, 2 * C, true);
  if (F) {
    seg(w0, sl->w0, 2 * cf, F, 2 * C, 2 * C, false);
    seg(w2, sl->w2, cf, C, F, F, false);
    seg(w0, sl->w0t, 2 * cf, F, 2 * C, F, true);
  }
  return wg_split_weights(a, n, s);
}

// G's and H's bf16 recompute on the wgmma product: q from x and k, v from
// t in one launch (x and t bf16: two TF32 terms), the 3xTF32 attention
// keeping its row statistics, m = o Wm^T (the pre-LN message that LN1's
// backward reads) and, where msg is set, msg = LN1(m) in the same
// epilogue. qkv [R, 3C], o, m, msg [R, C] fp32; ws: the attention's
// key-split partials.
cudaError_t message_fwd_wg(const bf16* x, const bf16* t, const SplitLayer& sw,
                           const float* s1, const float* b1, Windows d,
                           float* qkv, float* o, float* m, float* msg,
                           float* stats, float eps, Workspace ws,
                           cudaStream_t s) {
  const int R = d.rows(), C = d.C, C3 = 3 * C;
  const long long wsb = (long long)d.T * C3;
  const WgSource os{o, C, C}, no{nullptr, 0, 0};
  cudaError_t err;
  EMIP_TRY((wg_linear<uint16_t, uint16_t, kWgEpiNone>(
      WgSource{x, C, C}, WgSource{t, C, C}, C, sw.qkv, R, C3, C, qkv, C3,
      WgEpilogue{}, s)));
  EMIP_TRY((cudaError_t)emip_attention_fwd(
      qkv, wsb, C3, qkv + C, wsb, C3, qkv + 2 * C, wsb, C3, d.mask, d.mask_nw,
      o, (long long)d.T * C, C, stats, ws.p, ws.n, d.windows, 1, d.T, d.T, C,
      1, s));
  if (!msg)
    return wg_linear<float, float, kWgEpiNone>(os, no, C, sw.m, R, C, C, m, C,
                                               WgEpilogue{}, s);
  WgEpilogue e{s1, b1, nullptr, 0, eps};
  e.aux = m;
  e.ldaux = C;
  return wg_linear<float, float, kWgEpiLnKeep>(os, no, C, sw.m, R, C, C, msg,
                                               C, e, s);
}

// An input grad's product on the wgmma product: out = (add +) dy (W^T)^T
// over K, fp32 or rounded to bf16 as its GradOut says.
cudaError_t input_grad_wg(const float* dy, long long ldy, int K,
                          const float* wt, int N, GradOut out, int R,
                          cudaStream_t s) {
  WgEpilogue e{};
  e.add = out.add;
  e.ldadd = out.ldadd;
  e.add_cols = N;
  e.add_bf16 = out.add_bf16;
  e.out_bf16 = out.bf16;
  return wg_linear<float, float, kWgEpiAdd>(
      WgSource{dy, ldy, K}, WgSource{nullptr, 0, 0}, N, wt, R, N,
      N % 128 ? 64 : 128, out.p, N, e, s);
}

// Backward of msg = LN1(m) (message_fwd_wg's buffers) for the gradient
// gmsg [R, C] (leading dimension ldg; fp32, or bf16 read as it lies): go =
// gm Wm on the wgmma product, the attention backward, the weight grads
// that are set (mma.sync, x and t exact: two terms), gx = (gx.add +) gq Wq
// (mma.sync) and gt = [gk | gv] [Wk; Wv] (wgmma) where set, each with its
// addend and rounding in the epilogue. gm, go [R, C] and gqkv [R, 3C] are
// scratch.
template <typename TG>
cudaError_t message_bwd_wg(const bf16* x, const bf16* t, LayerWeights w,
                           const SplitLayer& sw, const float* s1, Windows d,
                           const float* qkv, const float* o, const float* m,
                           const float* stats, const TG* gmsg, int ldg,
                           LayerGrads g, GradOut gx, GradOut gt, float* gm,
                           float* go, float* gqkv, float eps, Workspace ws,
                           cudaStream_t s) {
  const int R = d.rows(), C = d.C, C3 = 3 * C, C2 = 2 * C;
  const bool want_q = gx.p || g.gwq, want_kv = gt.p || g.gwk || g.gwv;
  cudaError_t err;
  EMIP_TRY(layernorm_bwd(m, C, reinterpret_cast<const GemmElem<TG>*>(gmsg),
                         ldg, s1, gm, C, false, g.gs1, g.gb1, R, C, eps, ws,
                         s));
  EMIP_TRY(weight_grad(gm, C, o, C, g.gwm, C, C, R, ws, s));
  if (!want_q && !want_kv) return cudaSuccess;
  EMIP_TRY(input_grad_wg(gm, C, C, sw.mt, C, GradOut{go, false, nullptr}, R,
                         s));
  EMIP_TRY(layer_attention_bwd(qkv, o, go, stats, want_q, want_kv, gqkv, d,
                               ws, s));
  EMIP_TRY(weight_grad_exact(gqkv, C3, x, C, g.gwq, C, C, R, ws, s));
  EMIP_TRY(weight_grad_exact(gqkv + C, C3, t, C, g.gwk, C, C, R, ws, s));
  EMIP_TRY(weight_grad_exact(gqkv + C2, C3, t, C, g.gwv, C, C, R, ws, s));
  if (gx.p) EMIP_TRY(input_grad_out(gqkv, C3, w.wq, C, C, gx, R, s));
  if (gt.p) EMIP_TRY(input_grad_wg(gqkv + C, C3, C2, sw.kvt, C, gt, R, s));
  return cudaSuccess;
}

#undef EMIP_TRY

}  // namespace
}  // namespace emip

#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;

// ------------------------------------------------------------ kernel G

// out = LN1(message(x, t)) (+ x). The backward reads qkv, o, m and stats
// ([2, windows, T], null when no gradient will be taken). ws: scratch for
// the attention's key-split partials (here and in H's and B's forward).
extern "C" int emip_window_layer(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* b1,
    const float* mask, int mask_nw, float* qkv, float* o, float* m,
    float* stats, float* out, float* ws, long long ws_floats, int windows,
    int T, int C, int add_residual, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  cudaError_t err;
  EMIP_TRY(message_fwd(x, C, t, LayerWeights{wq, wk, wv, wm}, d, qkv, o, m,
                       stats, Workspace{ws, ws_floats}, s));
  layernorm(m, C, add_residual ? x : nullptr, C, s1, b1, out, C, d.rows(), C,
            eps, s);
  return (int)cudaGetLastError();
}

// g is the [R, C] gradient of out. gx, gt and each weight grad are written
// only when their pointer is set; with add_residual gx = g + gq Wq, the
// residual added in the product's epilogue. ws holds the [R, 5C]
// activation-grad scratch and the transient workspace behind it.
extern "C" int emip_window_layer_bwd(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* mask,
    int mask_nw, const float* qkv, const float* o, const float* m,
    const float* stats, const float* g, float* gx, float* gt, float* gwq,
    float* gwk, float* gwv, float* gwm, float* gs1, float* gb1, float* ws,
    long long ws_floats, int windows, int T, int C, int add_residual,
    float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const long long rc = (long long)d.rows() * C;
  Workspace all{ws, ws_floats};
  float* gm = all.take(rc);
  float* go = all.take(rc);
  float* gqkv = all.take(3 * rc);
  if (!gm || !go || !gqkv) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  EMIP_TRY(message_bwd(x, C, t, LayerWeights{wq, wk, wv, wm}, s1, d, qkv, o,
                       m, stats, g, C,
                       LayerGrads{gwq, gwk, gwv, gwm, gs1, gb1},
                       GradOut{gx, false, add_residual ? g : nullptr}, false,
                       GradOut{gt, false, nullptr}, false, gm, go, gqkv, eps,
                       all, s));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ kernel H

// out = x + LN2(gelu([x, msg] W0^T) W2^T), msg = LN1(message(x, t)).
// Inference passes one buffer for m and z, and no h or stats.
extern "C" int emip_window_ffn_layer(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* b1,
    const float* w0, const float* w2, const float* s2, const float* b2,
    const float* mask, int mask_nw, float* qkv, float* o, float* m,
    float* stats, float* cat, float* h, float* u, float* z, float* out,
    float* ws, long long ws_floats, int windows, int T, int C, int F,
    float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows(), C2 = 2 * C;
  cudaError_t err;
  EMIP_TRY(cudaMemcpy2DAsync(cat, C2 * sizeof(float), x, C * sizeof(float),
                             C * sizeof(float), R, cudaMemcpyDeviceToDevice,
                             s));
  EMIP_TRY(message_fwd(x, C, t, LayerWeights{wq, wk, wv, wm}, d, qkv, o, m,
                       stats, Workspace{ws, ws_floats}, s));
  layernorm(m, C, nullptr, 0, s1, b1, cat + C, C2, R, C, eps, s);
  EMIP_TRY(ffn_fwd(cat, w0, w2, s2, b2, h, u, z, out, R, C, F, eps, s));
  return (int)cudaGetLastError();
}

// Backward of the forward above (run with separate m and z, h and stats). ws
// holds the [R, 7C + F] activation-grad scratch and the transient
// workspace behind it.
extern "C" int emip_window_ffn_layer_bwd(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* w0,
    const float* w2, const float* s2, const float* mask, int mask_nw,
    const float* qkv, const float* o, const float* m, const float* stats,
    const float* cat, const float* h, const float* u, const float* z,
    const float* g, float* gx, float* gt, float* gwq, float* gwk,
    float* gwv, float* gwm, float* gs1, float* gb1, float* gw0, float* gw2,
    float* gs2, float* gb2,
    float* ws, long long ws_floats, int windows, int T, int C, int F,
    float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows();
  const long long rc = (long long)R * C;
  Workspace all{ws, ws_floats};
  float* gz = all.take(rc);
  float* gh = all.take((long long)R * F);
  float* gmsg = all.take(rc);
  float* gm = all.take(rc);
  float* go = all.take(rc);
  float* gqkv = all.take(3 * rc);
  if (!gz || !gh || !gmsg || !gm || !go || !gqkv)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  EMIP_TRY(ffn_bwd(cat, h, u, z, g, w0, w2, s2, gw0, gw2, gs2, gb2, gz, gh,
                   gx, gmsg, R, C, F, eps, all, s));
  EMIP_TRY(message_bwd(x, C, t, LayerWeights{wq, wk, wv, wm}, s1, d, qkv, o,
                       m, stats, gmsg, C,
                       LayerGrads{gwq, gwk, gwv, gwm, gs1, gb1},
                       GradOut{gx, false, nullptr}, true,
                       GradOut{gt, false, nullptr}, false, gm, go, gqkv, eps,
                       all, s));
  return (int)cudaGetLastError();
}

// ------------------------------------------------- kernels G and H, bf16

// G's bf16 forward in three launches: x, t, out [R, C] and the weights
// wq..wm bf16 (cast at use), s1, b1 fp32; mask and zero_tiles as
// emip_attention_fwd_bf16 takes them. Buffers: qkv [R, 3C] and o [R,
// C] bf16. [q | k | v] = bf16([x Wq^T | t Wk^T | t Wv^T]) in one launch of
// the bf16 wgmma product (column tiles of C over the three weights, the
// first reading x); the attention; out = bf16((x +) bf16(LN1(o Wm^T))) in
// the epilogue of the second product, whose column tile holds the row, so
// the fp32 m never reaches memory. No statistics are kept (the bf16
// backward recomputes).
extern "C" int emip_window_layer_bf16(
    const void* x, const void* t, const void* wq, const void* wk,
    const void* wv, const void* wm, const float* s1, const float* b1,
    const float* mask, int mask_sn, int mask_nw, const void* zero_tiles,
    void* qkv, void* o, void* out, int windows, int T, int C,
    int add_residual, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = windows * T, C3 = 3 * C;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  cudaError_t err;
  const bf16* const wqkv[3] = {static_cast<const bf16*>(wq),
                               static_cast<const bf16*>(wk),
                               static_cast<const bf16*>(wv)};
  EMIP_TRY(wg_linear_bf16<kWbEpiBf16>(xb, C, static_cast<const bf16*>(t), C,
                                      C, wqkv, 3, C, R, C3, C, C, qkvb, C3,
                                      nullptr, nullptr, 0.f, nullptr, 0, s));
  const long long wsb = (long long)T * C3;
  EMIP_TRY((cudaError_t)emip_attention_fwd_bf16(
      qkvb, wsb, C3, qkvb + C, wsb, C3, qkvb + 2 * C, wsb, C3, mask, mask_sn,
      mask_nw, zero_tiles, o, (long long)T * C, C, windows, T, T, C, C, 1,
      stream));
  const bf16* const wmb[1] = {static_cast<const bf16*>(wm)};
  EMIP_TRY(wg_linear_bf16<kWbEpiLnMsg>(
      static_cast<const bf16*>(o), C, nullptr, 0, C, wmb, 1, C, R, C, C, C,
      static_cast<bf16*>(out), C, s1, b1, eps, add_residual ? xb : nullptr, C,
      s));
  return (int)cudaGetLastError();
}

// H's bf16 forward: x, t, out [R, C] bf16, every parameter fp32; the
// weights' TF32 halves in wsplit [8 C^2 + 6 C F] and fp32 buffers qkv [R,
// 3C], o, msg [R, C], u [R, F] (cross_ffn_bf16). No statistics are kept (the
// bf16 backward recomputes).
extern "C" int emip_window_ffn_layer_bf16(
    const void* x, const void* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* b1,
    const float* w0, const float* w2, const float* s2, const float* b2,
    const float* mask, int mask_nw, float* wsplit, float* qkv, float* o,
    float* msg, float* u, void* out, float* ws, long long ws_floats,
    int windows, int T, int C, int F, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  EMIP_TRY(cross_ffn_bf16(
      static_cast<const bf16*>(x), static_cast<const bf16*>(t),
      LayerWeights{wq, wk, wv, wm}, s1, b1, w0, w2, s2, b2,
      Windows{windows, T, C, mask, mask_nw}, F, wsplit, qkv, o, msg, u,
      static_cast<bf16*>(out), eps, Workspace{ws, ws_floats}, s));
  return (int)cudaGetLastError();
}

// G's bf16 backward, as the JAX kernel (_bwd_kernel) computes it with a
// bf16 storage dtype: the layer recomputed in fp32 on the fp32 weights
// (the bf16 forward ran bf16 products, so its buffers are not this
// recompute's), G's backward, gx and gt rounded to bf16 once, the
// parameter grads fp32. x, t and g [R, C] bf16, read as they lie (LN1's
// backward reads g's bits); every parameter fp32. On the wgmma product
// (gemm_wgmma.cuh; the weights and their transposes split once, one
// launch): the recompute (message_fwd_wg), go = gm Wm and gt = bf16([gk |
// gv] [Wk; Wv]); the 3xTF32 attention forward (with its statistics) and
// backward of mma_tf32.cuh; on mma.sync (gemm_tf32.cuh) gx = bf16((g +) gq
// Wq), the addend and the rounding in the epilogue, and the weight grads,
// each written only when its pointer is set. ws: the split weights
// (split_layer_floats(C, 0)), fp32 scratch for the recompute (qkv [R, 3C],
// o, m [R, C]) and the activation grads (gm, go [R, C], gqkv [R, 3C]),
// stats [2, windows, T] (rounded up to 4 floats), then what the attention
// and the weight grads take.
extern "C" int emip_window_layer_bwd_bf16(
    const void* x, const void* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* mask,
    int mask_nw, const void* g, void* gx, void* gt, float* gwq, float* gwk,
    float* gwv, float* gwm, float* gs1, float* gb1, float* ws,
    long long ws_floats, int windows, int T, int C, int add_residual,
    float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows();
  const long long rc = (long long)R * C;
  Workspace all{ws, ws_floats};
  float* wsplit = all.take(split_layer_floats(C, 0));
  float* qkv = all.take(3 * rc);
  float* o = all.take(rc);
  float* m = all.take(rc);
  float* gm = all.take(rc);
  float* go = all.take(rc);
  float* gqkv = all.take(3 * rc);
  float* stats = all.take((2LL * R + 3) / 4 * 4);
  if (!wsplit || !qkv || !o || !m || !gm || !go || !gqkv || !stats)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* tb = static_cast<const bf16*>(t);
  const LayerWeights w{wq, wk, wv, wm};
  SplitLayer sw;
  cudaError_t err;
  EMIP_TRY(split_layer(w, nullptr, nullptr, C, 0, wsplit, &sw, s));
  EMIP_TRY(message_fwd_wg(xb, tb, sw, nullptr, nullptr, d, qkv, o, m,
                          nullptr, stats, eps, all, s));
  EMIP_TRY(message_bwd_wg(
      xb, tb, w, sw, s1, d, qkv, o, m, stats, static_cast<const bf16*>(g), C,
      LayerGrads{gwq, gwk, gwv, gwm, gs1, gb1},
      GradOut{gx, true, add_residual ? g : nullptr, true, C},
      GradOut{gt, true, nullptr}, gm, go, gqkv, eps, all, s));
  return (int)cudaGetLastError();
}

// H's bf16 backward, as the JAX kernel (_ffn_bwd_kernel) computes it with a
// bf16 storage dtype: the layer and its FFN recomputed in fp32 on the fp32
// weights, H's backward, gx and gt rounded once. As G's, on the wgmma
// product: the recompute (message_fwd_wg keeping m and msg; u =
// gelu(x W0[:, :C]^T + msg W0[:, C:]^T) in JAX's two halves, x's K tiles
// first with two terms, no concat, the pre-activation h kept; z = u W2^T),
// then LN2's backward reading g's bits, gh = (gz W2) gelu'(h) (mma.sync),
// [gx1 | gmsg] = [g + (gh W0)[:, :C] | (gh W0)[:, C:]] in one launch (g
// added from bf16), msg's backward with gx = bf16(gx1 + gq Wq). W0's
// weight grad is its two halves, gh^T x (x exact) and gh^T msg. ws: the
// split weights
// (split_layer_floats(C, F)), fp32 scratch for the recompute (qkv [R, 3C],
// o, m, msg, z [R, C], h, u [R, F]) and the activation grads (gz, gm, go
// [R, C], gh [R, F], gcat [R, 2C], gqkv [R, 3C]), stats as G's, then what
// the attention and the weight grads take.
extern "C" int emip_window_ffn_layer_bwd_bf16(
    const void* x, const void* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* b1,
    const float* w0, const float* w2, const float* s2, const float* b2,
    const float* mask, int mask_nw, const void* g, void* gx, void* gt,
    float* gwq, float* gwk, float* gwv, float* gwm, float* gs1, float* gb1,
    float* gw0, float* gw2, float* gs2, float* gb2, float* ws,
    long long ws_floats, int windows, int T, int C, int F, float eps,
    void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows(), C2 = 2 * C;
  const long long rc = (long long)R * C, rf = (long long)R * F;
  Workspace all{ws, ws_floats};
  float* wsplit = all.take(split_layer_floats(C, F));
  float* qkv = all.take(3 * rc);
  float* o = all.take(rc);
  float* m = all.take(rc);
  float* msg = all.take(rc);
  float* z = all.take(rc);
  float* h = all.take(rf);
  float* u = all.take(rf);
  float* gz = all.take(rc);
  float* gh = all.take(rf);
  float* gcat = all.take(2 * rc);
  float* gm = all.take(rc);
  float* go = all.take(rc);
  float* gqkv = all.take(3 * rc);
  float* stats = all.take((2LL * R + 3) / 4 * 4);
  if (!wsplit || !qkv || !o || !m || !msg || !z || !h || !u || !gz || !gh ||
      !gcat || !gm || !go || !gqkv || !stats)
    return (int)cudaErrorInvalidValue;
  (void)b2;  // the recompute stops at z: its output is not read
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const WgSource xs{xb, C, C}, no{nullptr, 0, 0};
  const LayerWeights w{wq, wk, wv, wm};
  SplitLayer sw;
  cudaError_t err;
  EMIP_TRY(split_layer(w, w0, w2, C, F, wsplit, &sw, s));
  EMIP_TRY(message_fwd_wg(xb, static_cast<const bf16*>(t), sw, s1, b1, d,
                          qkv, o, m, msg, stats, eps, all, s));
  WgEpilogue keep_h{};
  keep_h.aux = h;
  keep_h.ldaux = F;
  EMIP_TRY((wg_linear<uint16_t, float, kWgEpiGeluKeep>(
      xs, WgSource{msg, C, C}, F, sw.w0, R, F, 128, u, F, keep_h, s)));
  EMIP_TRY((wg_linear<float, float, kWgEpiNone>(
      WgSource{u, F, F}, no, C, sw.w2, R, C, C, z, C, WgEpilogue{}, s)));
  // out = x + LN2(z): g read as it lies
  EMIP_TRY(layernorm_bwd(z, C, reinterpret_cast<const uint16_t*>(gb), C, s2,
                         gz, C, false, gs2, gb2, R, C, eps, all, s));
  EMIP_TRY(weight_grad(gz, C, u, F, gw2, C, F, R, all, s));
  {
    GemmArgs a = gemm_args(gz, C, 1, w2, F, 1, gh, F, R, F, C);
    a.aux = h;
    a.ldaux = F;
    EMIP_TRY(gemm(a, kEpiGeluGrad, s));  // gh = (gz W2) * gelu'(h)
  }
  EMIP_TRY(weight_grad_exact(gh, F, xb, C, gw0, F, C, R, all, s, C2));
  EMIP_TRY(weight_grad(gh, F, msg, C, gw0 ? gw0 + C : nullptr, F, C, R, all,
                       s, C2));
  WgEpilogue res{};
  res.add = gb;
  res.ldadd = C;
  res.add_cols = C;
  res.add_bf16 = true;
  EMIP_TRY((wg_linear<float, float, kWgEpiAdd>(WgSource{gh, F, F}, no, C2,
                                               sw.w0t, R, C2, 128, gcat, C2,
                                               res, s)));
  EMIP_TRY(message_bwd_wg(xb, static_cast<const bf16*>(t), w, sw, s1, d, qkv,
                          o, m, stats, gcat + C, C2,
                          LayerGrads{gwq, gwk, gwv, gwm, gs1, gb1},
                          GradOut{gx, true, gcat, false, C2},
                          GradOut{gt, true, nullptr}, gm, go, gqkv, eps, all,
                          s));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ kernel B

// Forward. Inference passes one buffer for both layers' qkv / o / m and z
// (and no h or stats); a forward that keeps what the backward reads passes
// separate buffers, h and each layer's attention statistics [2, windows,
// T].
extern "C" int emip_window_block(
    const float* x, const float* t,
    const float* wq1, const float* wk1, const float* wv1, const float* wm1,
    const float* s1, const float* b1,
    const float* wq2, const float* wk2, const float* wv2, const float* wm2,
    const float* sa, const float* ba,
    const float* w0, const float* w2, const float* sb, const float* bb,
    const float* mask, int mask_nw,
    float* qkv1, float* qkv2, float* o1, float* o2, float* m1, float* m2,
    float* stats1, float* stats2, float* cat, float* h, float* u, float* z,
    float* out, float* ws, long long ws_floats, int windows, int T, int C,
    int F, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const Workspace w{ws, ws_floats};
  const int R = d.rows(), C2 = 2 * C;
  cudaError_t err;
  // self-attention layer: x1 = x + LN1s(message(x, x)) -> cat[:, :C]
  EMIP_TRY(message_fwd(x, C, x, LayerWeights{wq1, wk1, wv1, wm1}, d, qkv1, o1,
                       m1, stats1, w, s));
  layernorm(m1, C, x, C, s1, b1, cat, C2, R, C, eps, s);
  // cross-attention message: msg = LN1c(message(x1, t)) -> cat[:, C:]
  EMIP_TRY(message_fwd(cat, C2, t, LayerWeights{wq2, wk2, wv2, wm2}, d, qkv2,
                       o2, m2, stats2, w, s));
  layernorm(m2, C, nullptr, 0, sa, ba, cat + C, C2, R, C, eps, s);
  EMIP_TRY(ffn_fwd(cat, w0, w2, sb, bb, h, u, z, out, R, C, F, eps, s));
  return (int)cudaGetLastError();
}

// The bf16 forward (the bf16 band of short inference), as the JAX kernel
// (_block_kernel) computes it with a bf16 storage dtype: a mixed block.
// x, t [R, C] and out are bf16; the self layer's weights wq1..wm1 are
// bf16 (the JAX kernel casts them at use), every other parameter fp32.
//   self layer, in bf16: G's bf16 layer (emip_window_layer_bf16) with t =
//     x and the residual, x1 = bf16(x + bf16(LN1s(o Wm1))) into a bf16
//     buffer;
//   cross layer + FFN, in fp32 on x1 and t (the JAX kernel upcasts them):
//     H's bf16 layer, cross_ffn_bf16, which reads x1 and t as bf16 where
//     they lie; out = bf16(x1 + LN2c(z)), rounded once.
// Buffers: qkv1 [R, 3C], o1, x1 [R, C] bf16 and cross_ffn_bf16's wsplit,
// qkv2, o2, msg, u. No statistics are kept (the bf16 backward recomputes).
extern "C" int emip_window_block_bf16(
    const void* x, const void* t,
    const void* wq1, const void* wk1, const void* wv1, const void* wm1,
    const float* s1, const float* b1,
    const float* wq2, const float* wk2, const float* wv2, const float* wm2,
    const float* sa, const float* ba,
    const float* w0, const float* w2, const float* sb, const float* bb,
    const float* mask, int mask_nw, const float* mask_rows, int mask_sn,
    const void* zero_tiles, void* qkv1, void* o1, void* x1, float* wsplit,
    float* qkv2, float* o2, float* msg, float* u, void* out, float* ws,
    long long ws_floats, int windows, int T, int C, int F, float eps,
    void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  EMIP_TRY((cudaError_t)emip_window_layer_bf16(
      x, x, wq1, wk1, wv1, wm1, s1, b1, mask_rows, mask_sn, mask_nw,
      zero_tiles, qkv1, o1, x1, windows, T, C, 1, eps, stream));
  EMIP_TRY(cross_ffn_bf16(
      static_cast<const bf16*>(x1), static_cast<const bf16*>(t),
      LayerWeights{wq2, wk2, wv2, wm2}, sa, ba, w0, w2, sb, bb,
      Windows{windows, T, C, mask, mask_nw}, F, wsplit, qkv2, o2, msg, u,
      static_cast<bf16*>(out), eps, Workspace{ws, ws_floats}, s));
  return (int)cudaGetLastError();
}

// Backward of the forward above (run with separate buffers, h and stats). g
// is the [R, C] gradient of out; gx and gt are written; each weight grad
// only when its pointer is set. ws holds the [R, 8C + F] activation-grad
// scratch and the split-K / column-sum / attention workspace behind it.
extern "C" int emip_window_block_bwd(
    const float* x, const float* t,
    const float* wq1, const float* wk1, const float* wv1, const float* wm1,
    const float* s1,
    const float* wq2, const float* wk2, const float* wv2, const float* wm2,
    const float* sa,
    const float* w0, const float* w2, const float* sb,
    const float* mask, int mask_nw,
    const float* qkv1, const float* qkv2, const float* o1, const float* o2,
    const float* m1, const float* m2, const float* stats1,
    const float* stats2, const float* cat, const float* h, const float* u,
    const float* z, const float* g,
    float* gx, float* gt,
    float* gwq1, float* gwk1, float* gwv1, float* gwm1, float* gs1,
    float* gb1,
    float* gwq2, float* gwk2, float* gwv2, float* gwm2, float* gsa,
    float* gba,
    float* gw0, float* gw2, float* gsb, float* gbb,
    float* ws, long long ws_floats,
    int windows, int T, int C, int F, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  EMIP_TRY((block_bwd<float, float, float, float>(
      x, t, LayerWeights{wq1, wk1, wv1, wm1}, s1,
      LayerWeights{wq2, wk2, wv2, wm2}, sa, w0, w2, sb,
      Windows{windows, T, C, mask, mask_nw}, qkv1, qkv2, o1, o2, m1, m2,
      stats1, stats2, cat, h, u, z, g, GradOut{gx, false, nullptr},
      GradOut{gt, false, nullptr},
      LayerGrads{gwq1, gwk1, gwv1, gwm1, gs1, gb1},
      LayerGrads{gwq2, gwk2, gwv2, gwm2, gsa, gba}, gw0, gw2, gsb, gbb, F,
      eps, Workspace{ws, ws_floats}, s)));
  return (int)cudaGetLastError();
}

// The bf16 backward. x, t and g [R, C] bf16, every parameter fp32 (the
// self layer's too: the JAX backward recomputes with the weights upcast,
// not rounded); gx and gt bf16 and the parameter grads fp32, each written
// only when its pointer is set. ws: fp32 scratch for the recomputed
// forward (qkv1, qkv2 [R, 3C], o1, o2, m1, m2, z [R, C], cat [R, 2C], h, u
// [R, F], stats1, stats2 [2, windows, T]), then what the block backward
// takes (the fp32 backward's workspace).
extern "C" int emip_window_block_bwd_bf16(
    const void* x, const void* t,
    const float* wq1, const float* wk1, const float* wv1, const float* wm1,
    const float* s1, const float* b1,
    const float* wq2, const float* wk2, const float* wv2, const float* wm2,
    const float* sa, const float* ba,
    const float* w0, const float* w2, const float* sb,
    const float* mask, int mask_nw, const void* g,
    void* gx, void* gt,
    float* gwq1, float* gwk1, float* gwv1, float* gwm1, float* gs1,
    float* gb1,
    float* gwq2, float* gwk2, float* gwv2, float* gwm2, float* gsa,
    float* gba,
    float* gw0, float* gw2, float* gsb, float* gbb,
    float* ws, long long ws_floats,
    int windows, int T, int C, int F, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows(), C2 = 2 * C;
  const long long rc = (long long)R * C, rf = (long long)R * F;
  Workspace all{ws, ws_floats};
  float* qkv1 = all.take(3 * rc);
  float* qkv2 = all.take(3 * rc);
  float* o1 = all.take(rc);
  float* o2 = all.take(rc);
  float* m1 = all.take(rc);
  float* m2 = all.take(rc);
  float* stats1 = all.take(2LL * R);
  float* stats2 = all.take(2LL * R);
  float* cat = all.take(2 * rc);
  float* h = all.take(rf);
  float* u = all.take(rf);
  float* z = all.take(rc);
  if (!qkv1 || !qkv2 || !o1 || !o2 || !m1 || !m2 || !stats1 || !stats2 ||
      !cat || !h || !u || !z)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* tb = static_cast<const bf16*>(t);
  // x1 = cat[:, :C] holds bf16 values: an exact operand
  const ExactF32* x1 = reinterpret_cast<const ExactF32*>(cat);
  cudaError_t err;
  // self layer in fp32 on x read as bf16; x1 = bf16(x + bf16(LN1s(m1)))
  // -> cat[:, :C]
  EMIP_TRY(message_fwd(xb, C, xb, LayerWeights{wq1, wk1, wv1, wm1}, d, qkv1,
                       o1, m1, stats1, all, s));
  EMIP_TRY(layernorm_self_bf16(m1, xb, s1, b1, cat, C2, R, C, eps, s));
  // cross layer: msg = LN1c(message(x1, t)) -> cat[:, C:]; the FFN's h, u
  // and z (its output is not needed)
  EMIP_TRY(message_fwd(x1, C2, tb, LayerWeights{wq2, wk2, wv2, wm2}, d, qkv2,
                       o2, m2, stats2, all, s));
  layernorm(m2, C, nullptr, 0, sa, ba, cat + C, C2, R, C, eps, s);
  EMIP_TRY(linear(cat, C2, w0, nullptr, u, F, R, F, C2, true, s, h, F));
  EMIP_TRY(linear(u, F, w2, nullptr, z, C, R, C, F, false, s));
  EMIP_TRY((block_bwd<bf16, bf16, ExactF32, bf16>(
      xb, tb, LayerWeights{wq1, wk1, wv1, wm1}, s1,
      LayerWeights{wq2, wk2, wv2, wm2}, sa, w0, w2, sb, d, qkv1, qkv2, o1, o2,
      m1, m2, stats1, stats2, cat, h, u, z, static_cast<const bf16*>(g),
      GradOut{gx, true, nullptr}, GradOut{gt, true, nullptr},
      LayerGrads{gwq1, gwk1, gwv1, gwm1, gs1, gb1},
      LayerGrads{gwq2, gwk2, gwv2, gwm2, gsa, gba}, gw0, gw2, gsb, gbb, F,
      eps, all, s)));
  return (int)cudaGetLastError();
}
#undef EMIP_TRY
