// The 3xTF32 GEMM of gemm_tf32.cuh as an entry point of its own, so that it
// can be held against torch.matmul and timed alone at the shapes kernels A,
// B, G and H give it (kernels/gemm.py). No model path calls it: there the
// GEMM runs inside those kernels' entry points.

#include "gemm_bf16.cuh"
#include "gemm_tf32.cuh"

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

// The bf16 GEMM of gemm_bf16.cuh alone (kernels A and B in the bf16 band):
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
