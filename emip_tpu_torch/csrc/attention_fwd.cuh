// The forward attention of kernels A (PVT heads of width 64 or 32) and B,
// G, H (GMFlow windows of width 128 or 64, with the shifted-window mask):
// attention_fwd_tc of mma_tf32.cuh, 3xTF32 on the tensor cores. Defined
// once, with its tilings, in attention.cu; sr_attention.cu and
// window_attention.cu call it inside their entry points, and
// kernels/attention.py calls it alone, for the checks.

#pragma once

// out = softmax(q_h k_h^T / sqrt(D) (+ mask)) v_h per head h of width D.
// q, out: [B, Nq, H * D]; k, v: [B, Nk, H * D]; each addressed by its batch
// and row strides (the last stride 1), so that A's q buffer and the two
// halves of its [k | v] buffer are read in place and o is written at the
// head's columns. windows != 0 takes the window kernels' instantiation (D
// 128 or 64, H 1, Nq == Nk, mask [mask_nw, Nq, Nk] or null with batch row
// b reading mask[b % mask_nw]), otherwise kernel A's (D 64 or 32, no
// mask). stats [2, B * H, Nq] (row max, then row sum) or null (no gradient
// will be taken). ws: ws_floats of scratch for the key-split partials, as
// many as emip_attention_fwd_workspace asks (fewer splits when it is
// short). Returns a cudaError_t.
extern "C" int emip_attention_fwd(const float* q, long long q_sb, int q_sn,
                                  const float* k, long long k_sb, int k_sn,
                                  const float* v, long long v_sb, int v_sn,
                                  const float* mask, int mask_nw, float* out,
                                  long long o_sb, int o_sn, float* stats,
                                  float* ws, long long ws_floats, int B,
                                  int H, int Nq, int Nk, int D, int windows,
                                  void* stream);

// Floats of ws that emip_attention_fwd splits its keys into at this shape:
// 0 where it takes one split, -1 for a width it does not serve.
extern "C" long long emip_attention_fwd_workspace(int B, int H, int Nq,
                                                  int Nk, int D, int windows);
