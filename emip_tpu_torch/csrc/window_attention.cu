// Kernel B: one whole GMFlow swin TransformerBlock per window, forward and
// backward.
//
// Replaces emip_tpu/ops/pallas/window_attention.py:
// fused_window_attention_block (_block_kernel, _block_bwd_kernel). Per
// window of T tokens:
//   x1  = x + LN1s(softmax(x Wq1 (x Wk1)^T / sqrt(C) + mask) x Wv1 Wm1)
//   msg = LN1c(softmax(x1 Wq2 (t Wk2)^T / sqrt(C) + mask) t Wv2 Wm2)
//   out = x1 + LN2c(gelu_exact([x1, msg] W0) W2)
// The [K*K, T, T] shift mask (or none) applies to both attention layers.
//
// What bounds it on the card: fp32 arithmetic. The seven projections and
// the FFN (256 -> 1024 -> 128) are ~85% of the FLOPs and run as the shared
// tiled GEMM over all B*K*K*T rows at once; the two attentions run as the
// shared flash-style kernel, one block per 32 query rows of one window,
// streaming the window's keys through shared memory. T = 484 is not a
// power of two: the last key tile is masked by -inf and the last query
// tile is bounds-checked. The whole block is 12 launches instead of one
// grid cell per window; the TPU kernel fused them to save per-cell
// sequencing overhead, which does not exist in this form. x1 and msg are
// written side by side into one [R, 2C] buffer, so [x1, msg] W0 is one
// GEMM and x1 needs no copy to serve as the FFN's residual.
//
// Backward: the TPU kernel recomputes the whole block per window. Here the
// forward keeps every intermediate of both layers when a gradient will be
// taken (q/k/v, attention output and pre-LN message of each layer, the
// concat, the FFN pre-activation h and u = gelu(h), and z = u W2^T; about
// 0.43 GB per block at R = 30,976 rows), so the backward recomputes only
// the attention probabilities. Order: LN2 -> W2 -> GELU' (fused into the
// W2 grad GEMM) -> the split W0 -> cross message (LN1c -> Wm2 -> attention
// backward, k and v from t giving gt) -> the residual -> self message
// (attention backward with q, k and v from x). The weight grads are
// split-K GEMMs and ordered column sums, each only when its pointer is set
// (GMFlow is frozen on the train path, so only gx and gt are asked for).

#include "primitives.cuh"

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
  const int R = windows * T;
  const int C3 = 3 * C, C2 = 2 * C;
  const float scale = 1.0f / sqrtf((float)C);
  const long long wsb = (long long)T * C3;  // window stride inside qkv
  cudaError_t err;
#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;

  // ---- self-attention layer: x1 = x + LN1s(attn(x, x) Wm1) -> cat[:, :C]
  EMIP_TRY(linear(x, C, wq1, nullptr, qkv1, C3, R, C, C, false, s));
  EMIP_TRY(linear(x, C, wk1, nullptr, qkv1 + C, C3, R, C, C, false, s));
  EMIP_TRY(linear(x, C, wv1, nullptr, qkv1 + C2, C3, R, C, C, false, s));
  EMIP_TRY(attention(C, C, qkv1, wsb, C3, qkv1 + C, wsb, C3, qkv1 + C2, wsb,
                     C3, o1, (long long)T * C, C, mask, mask_nw, windows, 1,
                     T, T, scale, s));
  EMIP_TRY(linear(o1, C, wm1, nullptr, m1, C, R, C, C, false, s));
  layernorm(m1, C, x, C, s1, b1, cat, C2, R, C, eps, s);

  // ---- cross-attention message: msg = LN1c(attn(x1, t) Wm2) -> cat[:, C:]
  EMIP_TRY(linear(cat, C2, wq2, nullptr, qkv2, C3, R, C, C, false, s));
  EMIP_TRY(linear(t, C, wk2, nullptr, qkv2 + C, C3, R, C, C, false, s));
  EMIP_TRY(linear(t, C, wv2, nullptr, qkv2 + C2, C3, R, C, C, false, s));
  EMIP_TRY(attention(C, C, qkv2, wsb, C3, qkv2 + C, wsb, C3, qkv2 + C2, wsb,
                     C3, o2, (long long)T * C, C, mask, mask_nw, windows, 1,
                     T, T, scale, s));
  EMIP_TRY(linear(o2, C, wm2, nullptr, m2, C, R, C, C, false, s));
  layernorm(m2, C, nullptr, 0, sa, ba, cat + C, C2, R, C, eps, s);

  // ---- FFN: out = x1 + LN2c(gelu([x1, msg] W0^T) W2^T)
  EMIP_TRY(linear(cat, C2, w0, nullptr, u, F, R, F, C2, true, s, h, F));
  EMIP_TRY(linear(u, F, w2, nullptr, z, C, R, C, F, false, s));
  layernorm(z, C, cat, C2, sb, bb, out, C, R, C, eps, s);
#undef EMIP_TRY
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
  const int R = windows * T;
  const int C3 = 3 * C, C2 = 2 * C;
  const float scale = 1.0f / sqrtf((float)C);
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
  const Workspace w = all;  // what is left: transient workspace
  cudaError_t err;
#define EMIP_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err;

  // one attention layer's backward: go -> gq, gk, gv in gqkv
  auto attn_bwd = [&](const float* qkv, const float* o) {
    const long long sb3 = (long long)T * C3, sb1 = (long long)T * C;
    return attention_bwd(
        C, C, AttnOperand{qkv, sb3, C3}, AttnOperand{qkv + C, sb3, C3},
        AttnOperand{qkv + C2, sb3, C3}, AttnOperand{o, sb1, C},
        AttnOperand{go, sb1, C}, AttnGrad{gqkv, sb3, C3},
        AttnGrad{gqkv + C, sb3, C3}, AttnGrad{gqkv + C2, sb3, C3}, mask,
        mask_nw, windows, 1, T, T, scale, w, s);
  };

  // ---- out = x1 + LN2c(z), z = u W2^T, u = gelu(h), h = cat W0^T
  EMIP_TRY(layernorm_bwd(z, C, g, C, sb, gz, C, false, gsb, gbb, R, C, eps,
                         w, s));
  EMIP_TRY(weight_grad(gz, C, u, F, gw2, C, F, R, w, s));
  {
    GemmArgs a = gemm_args(gz, C, 1, w2, F, 1, gh, F, R, F, C);
    a.aux = const_cast<float*>(h);
    a.ldaux = F;
    EMIP_TRY(gemm(a, kEpiGeluGrad, s));  // gh = (gz W2) * gelu'(h)
  }
  EMIP_TRY(weight_grad(gh, F, cat, C2, gw0, F, C2, R, w, s));
  EMIP_TRY(cudaMemcpyAsync(gx1, g, rc * sizeof(float),
                           cudaMemcpyDeviceToDevice, s));
  {
    // gcat = gh W0, split into the x1 half (added to gx1) and the msg half
    GemmArgs a = gemm_args(gh, F, 1, w0, C2, 1, gx1, C, R, C, F);
    a.accumulate = true;
    EMIP_TRY(gemm(a, kEpiNone, s));
    a = gemm_args(gh, F, 1, w0 + C, C2, 1, gmsg, C, R, C, F);
    EMIP_TRY(gemm(a, kEpiNone, s));
  }

  // ---- cross message: msg = LN1c(o2 Wm2^T), o2 = attn(x1 Wq2, t Wk2, t Wv2)
  EMIP_TRY(layernorm_bwd(m2, C, gmsg, C, sa, gm, C, false, gsa, gba, R, C,
                         eps, w, s));
  EMIP_TRY(weight_grad(gm, C, o2, C, gwm2, C, C, R, w, s));
  EMIP_TRY(input_grad(gm, C, wm2, C, C, go, C, R, false, s));
  EMIP_TRY(attn_bwd(qkv2, o2));
  EMIP_TRY(weight_grad(gqkv, C3, cat, C2, gwq2, C, C, R, w, s));
  EMIP_TRY(weight_grad(gqkv + C, C3, t, C, gwk2, C, C, R, w, s));
  EMIP_TRY(weight_grad(gqkv + C2, C3, t, C, gwv2, C, C, R, w, s));
  EMIP_TRY(input_grad(gqkv, C3, wq2, C, C, gx1, C, R, true, s));
  if (gt) {
    EMIP_TRY(input_grad(gqkv + C, C3, wk2, C, C, gt, C, R, false, s));
    EMIP_TRY(input_grad(gqkv + C2, C3, wv2, C, C, gt, C, R, true, s));
  }

  // ---- x1 = x + LN1s(o1 Wm1^T), o1 = attn(x Wq1, x Wk1, x Wv1)
  EMIP_TRY(layernorm_bwd(m1, C, gx1, C, s1, gm, C, false, gs1, gb1, R, C,
                         eps, w, s));
  EMIP_TRY(weight_grad(gm, C, o1, C, gwm1, C, C, R, w, s));
  EMIP_TRY(input_grad(gm, C, wm1, C, C, go, C, R, false, s));
  EMIP_TRY(attn_bwd(qkv1, o1));
  EMIP_TRY(weight_grad(gqkv, C3, x, C, gwq1, C, C, R, w, s));
  EMIP_TRY(weight_grad(gqkv + C, C3, x, C, gwk1, C, C, R, w, s));
  EMIP_TRY(weight_grad(gqkv + C2, C3, x, C, gwv1, C, C, R, w, s));
  if (gx) {
    EMIP_TRY(cudaMemcpyAsync(gx, gx1, rc * sizeof(float),
                             cudaMemcpyDeviceToDevice, s));
    EMIP_TRY(input_grad(gqkv, C3, wq1, C, C, gx, C, R, true, s));
    EMIP_TRY(input_grad(gqkv + C, C3, wk1, C, C, gx, C, R, true, s));
    EMIP_TRY(input_grad(gqkv + C2, C3, wv1, C, C, gx, C, R, true, s));
  }
#undef EMIP_TRY
  return (int)cudaGetLastError();
}
