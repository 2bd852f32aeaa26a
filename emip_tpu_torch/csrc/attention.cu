// The forward attention of kernels A, B, G and H (declared in
// attention_fwd.cuh): attention_fwd_tc of mma_tf32.cuh at the tilings
// below, for A's heads (width 64 or 32, q and [k | v] read in place at the
// head's columns) and for the windows of B, G and H (width 128 or 64, the
// shifted-window mask). Every instantiation is compiled here once; the
// entry points of sr_attention.cu and window_attention.cu call it, and
// kernels/attention.py calls it alone so that it can be held against the
// fp64 product and timed beside torch's scaled_dot_product_attention.
//
// Tilings: warps, fragments of 16 resident rows per warp, streamed rows per
// stage. Both are kernel F's forward's: 8 warps of two fragments own 256
// query rows, so that every streamed fragment of k and v is loaded and
// split into its TF32 halves once for two mma; keys stream in tiles of 32
// through two cp.async stages (198 KiB at width 128, one block an SM).
// Measured against it (PERF.md): 8 warps of one fragment, 1.11-1.23x the
// time of the windows' attention; keys in tiles of 16, 1.02-1.12x; 4 warps
// for A, within the spread of its launch-bound shapes. Where the blocks
// leave the card idle (A's last stage: 64 image-head rows of 121 queries
// at 352^2; G and H at one clip of 512^2), tc_splits splits the keys and a
// further launch merges the partials in order.
//
// The shift mask (a window call without it skips its reads) sits in L2
// (3.7 MiB at T = 484, 16 MiB at T = 1024) and is read from there where it
// is added to the scores, a column pair at a time, at both widths. At width
// 128 there is no other choice: staged in shared memory it does not fit
// (198 KiB, and two mask stages add 80 KiB against the SM's 227), and read
// ahead of the products it takes 32 registers that the tiling does not have
// (80 bytes spilled, 1.04-1.05x). At width 64, where only the toy pvt_v2_b0
// configuration runs, staging it beside k and v took 0.80-0.82x the time
// at shapes no configuration produces; one way of reading it is kept.

#include "attention_fwd.cuh"

#include "mma_tf32.cuh"

namespace {

constexpr int kSrFwdWarps = 8;
constexpr int kSrFwdMt = 2;
constexpr int kSrFwdStr = 32;
constexpr int kWinFwdWarps = 8;
constexpr int kWinFwdMt = 2;
constexpr int kWinFwdStr = 32;

using namespace emip;

// A's heads: q, out [B, N, H * ch]; k, v [B, M, H * ch].
cudaError_t sr_attention_fwd(AttnOperand q, AttnOperand k, AttnOperand v,
                             AttnGrad out, float* stats, int B, int H, int N,
                             int M, int ch, Workspace ws, cudaStream_t s) {
  float* row_sum = stats ? stats + (long long)B * H * N : nullptr;
  const float scale = 1.0f / sqrtf((float)ch);
  if (ch == 64)
    return attention_fwd_tc<64, 64, kSrFwdWarps, kSrFwdMt, kSrFwdStr, false,
                            true>(q, k, v, nullptr, nullptr, 1, out, stats,
                                  row_sum, B, H, N, M, scale, ws, s);
  if (ch == 32)
    return attention_fwd_tc<32, 32, kSrFwdWarps, kSrFwdMt, kSrFwdStr, false,
                            true>(q, k, v, nullptr, nullptr, 1, out, stats,
                                  row_sum, B, H, N, M, scale, ws, s);
  return cudaErrorInvalidValue;
}

// The windows: q, k, v, out [windows, T, C]; mask [mask_nw, T, T] or null.
cudaError_t window_attention_fwd(AttnOperand q, AttnOperand k, AttnOperand v,
                                 const float* mask, int mask_nw, AttnGrad out,
                                 float* stats, int windows, int T, int C,
                                 Workspace ws, cudaStream_t s) {
  float* row_sum = stats ? stats + (long long)windows * T : nullptr;
  const float scale = 1.0f / sqrtf((float)C);
  if (C == 128)
    return attention_fwd_tc<128, 128, kWinFwdWarps, kWinFwdMt, kWinFwdStr,
                            true>(q, k, v, nullptr, mask, mask_nw, out, stats,
                                  row_sum, windows, 1, T, T, scale, ws, s);
  if (C == 64)
    return attention_fwd_tc<64, 64, kWinFwdWarps, kWinFwdMt, kWinFwdStr,
                            true>(q, k, v, nullptr, mask, mask_nw, out, stats,
                                  row_sum, windows, 1, T, T, scale, ws, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int emip_attention_fwd(const float* q, long long q_sb, int q_sn,
                                  const float* k, long long k_sb, int k_sn,
                                  const float* v, long long v_sb, int v_sn,
                                  const float* mask, int mask_nw, float* out,
                                  long long o_sb, int o_sn, float* stats,
                                  float* ws, long long ws_floats, int B,
                                  int H, int Nq, int Nk, int D, int windows,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AttnOperand qo{q, q_sb, q_sn}, ko{k, k_sb, k_sn}, vo{v, v_sb, v_sn};
  const AttnGrad oo{out, o_sb, o_sn};
  const Workspace w{ws, ws_floats};
  cudaError_t err;
  if (windows) {
    if (H != 1 || Nq != Nk) return (int)cudaErrorInvalidValue;
    err = window_attention_fwd(qo, ko, vo, mask, mask_nw, oo, stats, B, Nq, D,
                               w, s);
  } else {
    if (mask) return (int)cudaErrorInvalidValue;
    err = sr_attention_fwd(qo, ko, vo, oo, stats, B, H, Nq, Nk, D, w, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" long long emip_attention_fwd_workspace(int B, int H, int Nq,
                                                  int Nk, int D, int windows) {
  constexpr long long kAll = 1LL << 62;  // as much as the splits would take
  int per;
  long long floats = -1;
  if (windows && D == 128)
    attention_fwd_tc_splits<128, 128, kWinFwdWarps, kWinFwdMt, kWinFwdStr>(
        B * H, Nq, Nk, kAll, &per, &floats);
  else if (windows && D == 64)
    attention_fwd_tc_splits<64, 64, kWinFwdWarps, kWinFwdMt, kWinFwdStr>(
        B * H, Nq, Nk, kAll, &per, &floats);
  else if (!windows && D == 64)
    attention_fwd_tc_splits<64, 64, kSrFwdWarps, kSrFwdMt, kSrFwdStr>(
        B * H, Nq, Nk, kAll, &per, &floats);
  else if (!windows && D == 32)
    attention_fwd_tc_splits<32, 32, kSrFwdWarps, kSrFwdMt, kSrFwdStr>(
        B * H, Nq, Nk, kAll, &per, &floats);
  return floats;
}
