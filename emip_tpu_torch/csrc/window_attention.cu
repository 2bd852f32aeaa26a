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
// What bounds them on the card: fp32 arithmetic. The projections and the
// FFN (256 -> 1024 -> 128) are ~85% of B's FLOPs and run as the shared
// tiled GEMM over all B*K*K*T rows at once; the attention runs as the
// shared flash-style kernel, one block per 32 query rows of one window,
// streaming the window's keys through shared memory in tiles of 32. That
// kernel takes any T: at T = 484 the last key tile is masked by -inf and
// the last query tile is bounds-checked, T = 1024 is a whole number of
// tiles; the mask (16 MiB at T = 1024) is read once, tile by tile. So the
// TPU's split into a whole-window form and a row-tiled form with the
// window's k / v in VMEM scratch has no counterpart: one q-tiled family
// serves every T. B is 12 launches, G 6 and H 9, instead of one grid cell
// per window; the TPU kernels fused them to save per-cell sequencing
// overhead, which does not exist in this form. x (B: x1) and msg are
// written side by side into one [R, 2C] buffer, so [x, msg] W0 is one GEMM
// against the reference's one [F, 2C] weight (the TPU kernel takes W0 in
// two halves).
//
// Backward: the TPU kernels recompute the whole layer per window. Here a
// forward that will be differentiated keeps every intermediate (q/k/v,
// attention output and pre-LN message of each layer, the concat, the FFN
// pre-activation h and u = gelu(h), and z = u W2^T; about 0.43 GB for B at
// R = 30,976 rows), so the backward recomputes only the attention
// probabilities. Order: LN2 -> W2 -> GELU' (fused into the W2 grad GEMM)
// -> the split W0 -> message (LN1 -> Wm -> attention backward, k and v
// from t giving gt) -> for B the residual and the self layer's message.
// The weight grads are split-K GEMMs and ordered column sums, each only
// when its pointer is set (GMFlow is frozen on the train path, so only gx
// and gt are asked for). The inference forward passes one buffer where the
// backward would need two.

#include "primitives.cuh"

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
// its LayerNorm. xq [R, C] with leading dimension ldxq; qkv [R, 3C].
cudaError_t message_fwd(const float* xq, int ldxq, const float* t,
                        LayerWeights w, Windows d, float* qkv, float* o,
                        float* m, cudaStream_t s) {
  const int R = d.rows(), C = d.C, C3 = 3 * C;
  const long long wsb = (long long)d.T * C3;  // window stride inside qkv
  cudaError_t err;
  EMIP_TRY(linear(xq, ldxq, w.wq, nullptr, qkv, C3, R, C, C, false, s));
  EMIP_TRY(linear(t, C, w.wk, nullptr, qkv + C, C3, R, C, C, false, s));
  EMIP_TRY(linear(t, C, w.wv, nullptr, qkv + 2 * C, C3, R, C, C, false, s));
  EMIP_TRY(attention(C, C, qkv, wsb, C3, qkv + C, wsb, C3, qkv + 2 * C, wsb,
                     C3, o, (long long)d.T * C, C, d.mask, d.mask_nw,
                     d.windows, 1, d.T, d.T, 1.0f / sqrtf((float)C), s));
  return linear(o, C, w.wm, nullptr, m, C, R, C, C, false, s);
}

// Backward of msg = LN1(m) with m from message_fwd. gmsg [R, C] (leading
// dimension ldg) is the gradient of msg. Writes the weight grads that are
// set, gxq (+)= gq Wq if gxq is set, and gt (+)= gk Wk + gv Wv if gt is
// set. gm, go [R, C] and gqkv [R, 3C] are scratch.
cudaError_t message_bwd(const float* xq, int ldxq, const float* t,
                        LayerWeights w, const float* s1, Windows d,
                        const float* qkv, const float* o, const float* m,
                        const float* gmsg, int ldg, LayerGrads g, float* gxq,
                        bool accumulate_xq, float* gt, bool accumulate_t,
                        float* gm, float* go, float* gqkv, float eps,
                        Workspace ws, cudaStream_t s) {
  const int R = d.rows(), C = d.C, C3 = 3 * C, C2 = 2 * C;
  const long long sb3 = (long long)d.T * C3, sb1 = (long long)d.T * C;
  cudaError_t err;
  EMIP_TRY(layernorm_bwd(m, C, gmsg, ldg, s1, gm, C, false, g.gs1, g.gb1, R,
                         C, eps, ws, s));
  EMIP_TRY(weight_grad(gm, C, o, C, g.gwm, C, C, R, ws, s));
  EMIP_TRY(input_grad(gm, C, w.wm, C, C, go, C, R, false, s));
  EMIP_TRY(attention_bwd(
      C, C, AttnOperand{qkv, sb3, C3}, AttnOperand{qkv + C, sb3, C3},
      AttnOperand{qkv + C2, sb3, C3}, AttnOperand{o, sb1, C},
      AttnOperand{go, sb1, C}, AttnGrad{gqkv, sb3, C3},
      AttnGrad{gqkv + C, sb3, C3}, AttnGrad{gqkv + C2, sb3, C3}, d.mask,
      d.mask_nw, d.windows, 1, d.T, d.T, 1.0f / sqrtf((float)C), ws, s));
  EMIP_TRY(weight_grad(gqkv, C3, xq, ldxq, g.gwq, C, C, R, ws, s));
  EMIP_TRY(weight_grad(gqkv + C, C3, t, C, g.gwk, C, C, R, ws, s));
  EMIP_TRY(weight_grad(gqkv + C2, C3, t, C, g.gwv, C, C, R, ws, s));
  if (gxq)
    EMIP_TRY(input_grad(gqkv, C3, w.wq, C, C, gxq, C, R, accumulate_xq, s));
  if (gt) {
    EMIP_TRY(input_grad(gqkv + C, C3, w.wk, C, C, gt, C, R, accumulate_t, s));
    EMIP_TRY(input_grad(gqkv + C2, C3, w.wv, C, C, gt, C, R, true, s));
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

// Backward of ffn_fwd for the gradient g [R, C] of out: gmsg [R, C], the
// weight grads that are set and, if gx is set, gx = g + (gh W0)[:, :C]
// (the residual and the x half of the concat). gz [R, C] and gh [R, F] are
// scratch.
cudaError_t ffn_bwd(const float* cat, const float* h, const float* u,
                    const float* z, const float* g, const float* w0,
                    const float* w2, const float* s2, float* gw0, float* gw2,
                    float* gs2, float* gb2, float* gz, float* gh, float* gx,
                    float* gmsg, int R, int C, int F, float eps, Workspace ws,
                    cudaStream_t s) {
  const int C2 = 2 * C;
  cudaError_t err;
  EMIP_TRY(layernorm_bwd(z, C, g, C, s2, gz, C, false, gs2, gb2, R, C, eps,
                         ws, s));
  EMIP_TRY(weight_grad(gz, C, u, F, gw2, C, F, R, ws, s));
  {
    GemmArgs a = gemm_args(gz, C, 1, w2, F, 1, gh, F, R, F, C);
    a.aux = const_cast<float*>(h);
    a.ldaux = F;
    EMIP_TRY(gemm(a, kEpiGeluGrad, s));  // gh = (gz W2) * gelu'(h)
  }
  EMIP_TRY(weight_grad(gh, F, cat, C2, gw0, F, C2, R, ws, s));
  if (gx) {
    EMIP_TRY(cudaMemcpyAsync(gx, g, (long long)R * C * sizeof(float),
                             cudaMemcpyDeviceToDevice, s));
    GemmArgs a = gemm_args(gh, F, 1, w0, C2, 1, gx, C, R, C, F);
    a.accumulate = true;
    EMIP_TRY(gemm(a, kEpiNone, s));
  }
  GemmArgs a = gemm_args(gh, F, 1, w0 + C, C2, 1, gmsg, C, R, C, F);
  return gemm(a, kEpiNone, s);
}

#undef EMIP_TRY

}  // namespace
}  // namespace emip

#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;

// ------------------------------------------------------------ kernel G

// out = LN1(message(x, t)) (+ x). The backward reads qkv, o and m.
extern "C" int emip_window_layer(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* b1,
    const float* mask, int mask_nw, float* qkv, float* o, float* m,
    float* out, int windows, int T, int C, int add_residual, float eps,
    void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  cudaError_t err;
  EMIP_TRY(message_fwd(x, C, t, LayerWeights{wq, wk, wv, wm}, d, qkv, o, m,
                       s));
  layernorm(m, C, add_residual ? x : nullptr, C, s1, b1, out, C, d.rows(), C,
            eps, s);
  return (int)cudaGetLastError();
}

// g is the [R, C] gradient of out. gx, gt and each weight grad are written
// only when their pointer is set. ws holds the [R, 5C] activation-grad
// scratch and the transient workspace behind it.
extern "C" int emip_window_layer_bwd(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* mask,
    int mask_nw, const float* qkv, const float* o, const float* m,
    const float* g, float* gx, float* gt, float* gwq, float* gwk, float* gwv,
    float* gwm, float* gs1, float* gb1, float* ws, long long ws_floats,
    int windows, int T, int C, int add_residual, float eps, void* stream) {
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
  if (gx && add_residual)
    EMIP_TRY(cudaMemcpyAsync(gx, g, rc * sizeof(float),
                             cudaMemcpyDeviceToDevice, s));
  EMIP_TRY(message_bwd(x, C, t, LayerWeights{wq, wk, wv, wm}, s1, d, qkv, o,
                       m, g, C, LayerGrads{gwq, gwk, gwv, gwm, gs1, gb1}, gx,
                       add_residual != 0, gt, false, gm, go, gqkv, eps, all,
                       s));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ kernel H

// out = x + LN2(gelu([x, msg] W0^T) W2^T), msg = LN1(message(x, t)).
// Inference passes one buffer for m and z and no h.
extern "C" int emip_window_ffn_layer(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* b1,
    const float* w0, const float* w2, const float* s2, const float* b2,
    const float* mask, int mask_nw, float* qkv, float* o, float* m,
    float* cat, float* h, float* u, float* z, float* out, int windows, int T,
    int C, int F, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows(), C2 = 2 * C;
  cudaError_t err;
  EMIP_TRY(cudaMemcpy2DAsync(cat, C2 * sizeof(float), x, C * sizeof(float),
                             C * sizeof(float), R, cudaMemcpyDeviceToDevice,
                             s));
  EMIP_TRY(message_fwd(x, C, t, LayerWeights{wq, wk, wv, wm}, d, qkv, o, m,
                       s));
  layernorm(m, C, nullptr, 0, s1, b1, cat + C, C2, R, C, eps, s);
  EMIP_TRY(ffn_fwd(cat, w0, w2, s2, b2, h, u, z, out, R, C, F, eps, s));
  return (int)cudaGetLastError();
}

// Backward of the forward above (run with separate m and z, and h). ws
// holds the [R, 7C + F] activation-grad scratch and the transient
// workspace behind it.
extern "C" int emip_window_ffn_layer_bwd(
    const float* x, const float* t, const float* wq, const float* wk,
    const float* wv, const float* wm, const float* s1, const float* w0,
    const float* w2, const float* s2, const float* mask, int mask_nw,
    const float* qkv, const float* o, const float* m, const float* cat,
    const float* h, const float* u, const float* z, const float* g,
    float* gx, float* gt, float* gwq, float* gwk, float* gwv, float* gwm,
    float* gs1, float* gb1, float* gw0, float* gw2, float* gs2, float* gb2,
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
                       m, gmsg, C, LayerGrads{gwq, gwk, gwv, gwm, gs1, gb1},
                       gx, true, gt, false, gm, go, gqkv, eps, all, s));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ kernel B

// Forward. Inference passes one buffer for both layers' qkv / o / m and z
// (and no h); a forward that keeps what the backward reads passes separate
// buffers and h.
extern "C" int emip_window_block(
    const float* x, const float* t,
    const float* wq1, const float* wk1, const float* wv1, const float* wm1,
    const float* s1, const float* b1,
    const float* wq2, const float* wk2, const float* wv2, const float* wm2,
    const float* sa, const float* ba,
    const float* w0, const float* w2, const float* sb, const float* bb,
    const float* mask, int mask_nw,
    float* qkv1, float* qkv2, float* o1, float* o2, float* m1, float* m2,
    float* cat, float* h, float* u, float* z, float* out,
    int windows, int T, int C, int F, float eps, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows(), C2 = 2 * C;
  cudaError_t err;
  // self-attention layer: x1 = x + LN1s(message(x, x)) -> cat[:, :C]
  EMIP_TRY(message_fwd(x, C, x, LayerWeights{wq1, wk1, wv1, wm1}, d, qkv1, o1,
                       m1, s));
  layernorm(m1, C, x, C, s1, b1, cat, C2, R, C, eps, s);
  // cross-attention message: msg = LN1c(message(x1, t)) -> cat[:, C:]
  EMIP_TRY(message_fwd(cat, C2, t, LayerWeights{wq2, wk2, wv2, wm2}, d, qkv2,
                       o2, m2, s));
  layernorm(m2, C, nullptr, 0, sa, ba, cat + C, C2, R, C, eps, s);
  EMIP_TRY(ffn_fwd(cat, w0, w2, sb, bb, h, u, z, out, R, C, F, eps, s));
  return (int)cudaGetLastError();
}

// Backward of the forward above (run with separate buffers and h). g is the
// [R, C] gradient of out; gx and gt are written; each weight grad only when
// its pointer is set. ws holds the [R, 8C + F] activation-grad scratch and
// the split-K / column-sum / attention workspace behind it.
extern "C" int emip_window_block_bwd(
    const float* x, const float* t,
    const float* wq1, const float* wk1, const float* wv1, const float* wm1,
    const float* s1,
    const float* wq2, const float* wk2, const float* wv2, const float* wm2,
    const float* sa,
    const float* w0, const float* w2, const float* sb,
    const float* mask, int mask_nw,
    const float* qkv1, const float* qkv2, const float* o1, const float* o2,
    const float* m1, const float* m2, const float* cat, const float* h,
    const float* u, const float* z, const float* g,
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
  const Windows d{windows, T, C, mask, mask_nw};
  const int R = d.rows(), C2 = 2 * C;
  const long long rc = (long long)R * C;
  Workspace all{ws, ws_floats};
  float* gz = all.take(rc);
  float* gh = all.take((long long)R * F);
  float* gx1 = all.take(rc);
  float* gmsg = all.take(rc);
  float* gm = all.take(rc);
  float* go = all.take(rc);
  float* gqkv = all.take(3 * rc);
  if (!gz || !gh || !gx1 || !gmsg || !gm || !go || !gqkv)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  // out = x1 + LN2c(gelu([x1, msg] W0^T) W2^T)
  EMIP_TRY(ffn_bwd(cat, h, u, z, g, w0, w2, sb, gw0, gw2, gsb, gbb, gz, gh,
                   gx1, gmsg, R, C, F, eps, all, s));
  // msg = LN1c(message(x1, t)): q from x1, k and v from t
  EMIP_TRY(message_bwd(cat, C2, t, LayerWeights{wq2, wk2, wv2, wm2}, sa, d,
                       qkv2, o2, m2, gmsg, C,
                       LayerGrads{gwq2, gwk2, gwv2, gwm2, gsa, gba}, gx1,
                       true, gt, false, gm, go, gqkv, eps, all, s));
  // x1 = x + LN1s(message(x, x)): q, k and v from x
  if (gx)
    EMIP_TRY(cudaMemcpyAsync(gx, gx1, rc * sizeof(float),
                             cudaMemcpyDeviceToDevice, s));
  EMIP_TRY(message_bwd(x, C, x, LayerWeights{wq1, wk1, wv1, wm1}, s1, d, qkv1,
                       o1, m1, gx1, C,
                       LayerGrads{gwq1, gwk1, gwv1, gwm1, gs1, gb1}, gx, true,
                       gx, true, gm, go, gqkv, eps, all, s));
  return (int)cudaGetLastError();
}
#undef EMIP_TRY
