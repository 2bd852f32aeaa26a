// The 3xTF32 GEMM of gemm_tf32.cuh, the bf16 GEMM of gemm_bf16.cuh and the
// wgmma product of gemm_wgmma.cuh as entry points of their own, so that they
// can be held against torch.matmul and timed alone at the shapes kernels A,
// B, G and H give them (kernels/gemm.py). No model path calls them: there
// the products run inside those kernels' entry points.

#include "gemm_bf16.cuh"
#include "gemm_tf32.cuh"
#include "gemm_wgmma.cuh"

// C [M, N] (row stride ldc) = A . B (+ bias [N]), A(m, k) at A[m * sam + k
// * sak], B(k, n) at B[k * sbk + n * sbn]; one stride of each operand must
// be 1. split_k: K split across blocks as a weight gradient's is, the
// partials in ws summed in order (fewer splits when ws is short).
extern "C" int emip_gemm(const float* A, long long sam, long long sak,
                         const float* B, long long sbk, long long sbn,
                         const float* bias, float* C, long long ldc, int M,
                         int N, int K, int split_k, float* ws,
                         long long ws_floats, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs g = gemm_args(A, sam, sak, B, sbk, sbn, C, ldc, M, N, K);
  g.bias = bias;
  cudaError_t err;
  if (split_k) {
    if (bias) return (int)cudaErrorInvalidValue;
    err = gemm_splitk(g, Workspace{ws, ws_floats}, s);
  } else {
    err = gemm(g, kEpiNone, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The bf16 GEMM of gemm_bf16.cuh alone (kernel A in the bf16 band):
// C [M, N] (row stride ldc) = A [M, K] (row stride lda) . W^T (+ bias [N],
// fp32) for W [N, K] (row stride ldw), A and W bf16, C bf16 (out_bf16) or
// fp32.
extern "C" int emip_gemm_bf16(const void* A, long long lda, const void* W,
                              long long ldw, const float* bias, void* C,
                              long long ldc, int M, int N, int K,
                              int out_bf16, void* stream) {
  using namespace emip;
  cudaError_t err = linear_bf16(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(W), ldw,
      bias, C, ldc, M, N, K, out_bf16 != 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wgmma product of gemm_wgmma.cuh alone (B's and H's bf16 forwards):
// w [N, K] fp32 is split into wsplit [2N, K] (one launch), then out [M, N]
// (row stride ldo) = epi(a0 w^T) for epi 0 (none) or 2 (LayerNorm with
// gamma, beta: N = 64 or 128), fp32 a0; with a1 along K (k1 > 0), out =
// gelu(a0 w[:, :k0]^T + a1 w[:, k0:]^T) for bf16 a0 and fp32 a1 (epi 1);
// along N (n_switch < N), out = [a0 | a1 | ..] w^T, columns at or past
// n_switch from a1, both bf16 (epi 0). a0, a1 row-major with leading
// dimensions lda0, lda1 (elements).
extern "C" int emip_gemm_wgmma(const void* a0, long long lda0, int k0,
                               const void* a1, long long lda1, int k1,
                               int n_switch, int a_bf16, const float* w,
                               float* wsplit, int M, int N, int epi,
                               const float* gamma, const float* beta,
                               float* out, long long ldo, float eps,
                               void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nk = (long long)N * (k0 + k1);
  WgSplitArgs sa;
  sa.seg[0] = WgSplitSeg{w, wsplit, wsplit + nk, N, k0 + k1, k0 + k1, false};
  cudaError_t err = wg_split_weights(sa, 1, s);
  if (err != cudaSuccess) return (int)err;
  const WgSource s0{a0, lda0, k0}, s1{a1, lda1, k1};
  const WgEpilogue e{gamma, beta, nullptr, 0, eps};
  if (a_bf16 == 0 && !a1 && epi == kWgEpiNone)
    err = wg_linear<float, float, kWgEpiNone>(s0, s1, N, wsplit, M, N, 128,
                                              out, ldo, e, s);
  else if (a_bf16 == 0 && !a1 && epi == kWgEpiLn)
    err = wg_linear<float, float, kWgEpiLn>(s0, s1, N, wsplit, M, N, N, out,
                                            ldo, e, s);
  else if (a_bf16 == 1 && a1 && n_switch >= N && epi == kWgEpiGelu)
    err = wg_linear<uint16_t, float, kWgEpiGelu>(s0, s1, N, wsplit, M, N,
                                                 128, out, ldo, e, s);
  else if (a_bf16 == 3 && a1 && n_switch < N && epi == kWgEpiNone)
    err = wg_linear<uint16_t, uint16_t, kWgEpiNone>(
        s0, s1, n_switch, wsplit, M, N, n_switch % 128 ? 64 : 128, out, ldo,
        e, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// An input grad alone (G's and H's bf16 backwards): out [M, N] (row stride
// ldo) = epi(dy w) for dy [M, K] fp32 (row stride ldy) and an nn.Linear
// weight w [K, N] fp32; epi 6: times gelu'(aux [M, N], row stride ldo);
// epi 7: (add +) and out fp32 or rounded to bf16 (out_bf16), add [M, N]
// fp32 or bf16 (add_bf16, row stride ldo) or null. On the wgmma product
// (wgmma != 0) w is split transposed into wsplit [2N, K] (one launch) and
// the product is the K-major dy (w^T)^T; otherwise the 3xTF32 GEMM of
// gemm_tf32.cuh reads w in place, with the same epilogue (kEpiGeluGrad,
// kEpiAdd), so that the two can be compared at one shape.
extern "C" int emip_gemm_dyw(const float* dy, long long ldy, int K,
                             const float* w, float* wsplit, int M, int N,
                             int epi, float* aux, const void* add,
                             int add_bf16, int out_bf16, void* out,
                             long long ldo, int wgmma, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((epi != kWgEpiGeluGrad && epi != kWgEpiAdd) ||
      (epi == kWgEpiGeluGrad && (out_bf16 || add)))
    return (int)cudaErrorInvalidValue;
  if (!wgmma) {
    GemmArgs g = gemm_args(dy, ldy, 1, w, N, 1, static_cast<float*>(out), ldo,
                           M, N, K);
    g.aux = aux;
    g.ldaux = ldo;
    g.add = add;
    g.ldadd = ldo;
    g.add_bf16 = add_bf16 != 0;
    g.c_bf16 = out_bf16 != 0;
    err = gemm(g, epi == kWgEpiGeluGrad ? kEpiGeluGrad : kEpiNone, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const long long nk = (long long)N * K;
  WgSplitArgs sa;
  sa.seg[0] = WgSplitSeg{w, wsplit, wsplit + nk, K, N, K, true};
  if ((err = wg_split_weights(sa, 1, s)) != cudaSuccess) return (int)err;
  const WgSource a{dy, ldy, K}, no{nullptr, 0, 0};
  WgEpilogue e{};
  e.aux = aux;
  e.ldaux = ldo;
  e.add = add;
  e.ldadd = ldo;
  e.add_cols = N;
  e.add_bf16 = add_bf16 != 0;
  e.out_bf16 = out_bf16 != 0;
  const int bn = N % 128 ? 64 : 128;
  err = epi == kWgEpiGeluGrad
            ? wg_linear<float, float, kWgEpiGeluGrad>(a, no, N, wsplit, M, N,
                                                      bn, out, ldo, e, s)
            : wg_linear<float, float, kWgEpiAdd>(a, no, N, wsplit, M, N, bn,
                                                 out, ldo, e, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
