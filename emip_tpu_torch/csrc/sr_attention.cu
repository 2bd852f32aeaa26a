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
// The bf16 forward (the bf16 band), as the JAX kernel computes it with a
// bf16 storage dtype: x, kv_in and the three weights bf16, the biases fp32;
// q = bf16(x Wq^T + bq) and [k | v] = bf16(kv_in Wkv^T + bkv) (fp32 sums,
// the bias added before the one rounding), per head fp32 scores and
// softmax with P rounded to bf16 for P v, o rounded to bf16, out = bf16(o
// Wp^T + bp). What bounds it on the card: neither bytes nor products (a
// stage-3 call at 352^2 moves 6.4 MB and does 2.6 GFLOP, 2.6 us at the
// bf16 rate) but latency. The JAX kernel does an image per grid step with
// q, P and o in VMEM; as separate GEMM and attention launches (q, kv,
// attention, output) each launch would run 40-320 blocks and q and o would
// make round trips through device memory. Here it is two launches. The kv
// projection is the bf16 GEMM of gemm_bf16.cuh over all B * M rows (stage
// 3: 968 x 640 x 320), shared by every query tile of an image. Then
// one kernel: a thread-block cluster of `heads` blocks (1, 2, 5 or 8:
// within the portable size of 8) per (image, 64-row query tile), block h
// owning head h, 4 warps of 16 rows. Block h (a) sends its head's first key
// tile on its way and projects q_h from x, K = C in tiles of 32 through
// three cp.async stages, each tile two mma.sync.m16n8k16 steps into fp32
// accumulators: the GEMM's order, so its bits; the bias is added and q_h
// packed to bf16 straight into the A fragments of q k^T, never leaving the
// registers; (b) runs the key loop AbKeys of attention_bf16.cuh over the
// image's M keys of [k | v] and rounds o_h into its shared memory; (c) once
// the whole cluster is past its key loop (a cluster barrier; Wp's first
// tiles are on their way), writes its o
// tile into every block's [64, C] o through distributed shared memory
// (stores, which the block does not wait on, where loads would wait a
// round trip per head), and after a second barrier writes out[:, h] =
// bf16(o Wp[h]^T + bp[h]), K = C in the GEMM's order again. So every sum
// keeps the order of those separate launches and the output their bits.
// Blocks: 968, 496, 320, 128 at stages 1-4 at 352^2 (B = 8), 1,024, 512,
// 320, 128 at 512^2 (B = 4); shared memory at most 89 KB a block (C =
// 512: the cluster's o, 65 KB, Wp's stages and the block's o tile), four
// blocks an SM at C <= 128. Each block still reads its 64 rows of x, its
// head's weights and the image's keys itself: the x tile `heads` times a
// cluster, Wq and Wp once per query tile.
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

#include <cooperative_groups.h>

#include <algorithm>

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

namespace emip {
namespace {

// A's fused bf16 forward (see the head note): the projections' K tiles
constexpr int kSrKt = 32;         // K of a streamed tile
constexpr int kSrLd = kSrKt + 8;  // bf16 per shared row of a K tile
constexpr int kSrStages = 3;      // cp.async stages of the K tiles
constexpr int kSrMaxHeads = 8;    // the portable cluster size

// Shared memory of a block of head width CH, in two layouts over one
// region. (a) and (b): the key loop's two stages, beside the q
// projection's stages of x [kAbRows][kSrLd] and Wq [CH][kSrLd] (the first
// key tile lands while q is projected). (c): the cluster's o [kAbRows][C +
// 8], which the other blocks write into, the output projection's stages of
// Wp [CH][kSrLd], and the block's own o tile [kAbRows][CH + 8], which lies
// past the key loop's stages (it is written as the loop ends).
template <int CH>
struct SrPlan {
  using Keys = AbKeyPlan<CH, CH>;
  static constexpr int kLdO = CH + 8;
  static constexpr int kXTile = kAbRows * kSrLd;  // bf16 per stage
  static constexpr int kWTile = CH * kSrLd;       // bf16 per stage
  static constexpr size_t kOBytes = sizeof(bf16) * kAbRows * kLdO;
  static constexpr size_t kQBytes =
      sizeof(bf16) * kSrStages * (kXTile + kWTile);
  static constexpr size_t kWpBytes = sizeof(bf16) * kSrStages * kWTile;
  static size_t og_bytes(int C) {
    return sizeof(bf16) * (size_t)kAbRows * (C + 8);
  }
  static_assert(sizeof(bf16) * kAbRows * (CH + 8) + kWpBytes >= Keys::kBytes,
                "the o tile lies past the key loop's stages");
  static size_t bytes(int C) {
    return std::max(Keys::kBytes + kQBytes,
                    og_bytes(C) + kWpBytes + kOBytes);
  }
};

struct SrBf16Args {
  const bf16* x;   // [B, N, C]
  const bf16* wq;  // [C, C]
  const float* bq;
  const bf16* kv;  // [B, M, 2C]: [k | v], heads at columns h CH
  const bf16* wp;  // [C, C]
  const float* bp;
  bf16* out;  // [B, N, C]
  int N, M, C;
  float scale;
};

// The copies of one K tile (K = tile * kSrKt ..) into stage tile %
// kSrStages: the CH rows of W (row stride C) at ws and, where a_glob is
// set, the kAbRows rows of A (row stride C; rows past a_rows zeros) at as.
// One commit per call, empty past the last tile.
template <int CH>
__device__ __forceinline__ void sr_fill(int tile, int ktiles, const bf16* w,
                                        bf16* ws, const bf16* a_glob,
                                        int a_rows, bf16* as, int C) {
  using L = SrPlan<CH>;
  const int tid = threadIdx.x;
  if (tile < ktiles) {
    const int k0 = tile * kSrKt, s = tile % kSrStages;
    constexpr int kChunks = kSrKt / 8;  // 16-byte chunks of a tile row
    if (a_glob) {
      bf16* ad = as + s * L::kXTile;
      for (int e = tid; e < kAbRows * kChunks; e += kAbThreads) {
        const int r = e / kChunks, c = (e % kChunks) * 8;
        const bool ok = r < a_rows;
        cp_async<16>(ad + r * kSrLd + c,
                     ok ? a_glob + (long long)r * C + k0 + c : a_glob, ok);
      }
    }
    bf16* wd = ws + s * L::kWTile;
    for (int e = tid; e < CH * kChunks; e += kAbThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      cp_async<16>(wd + r * kSrLd + c, w + (long long)r * C + k0 + c, true);
    }
  }
  cp_async_commit();
}

// acc (this warp's 16 rows by CH columns, in the accumulator layout of
// mma_bf16) = A W^T over K = C, the K tiles of kSrKt in ascending order,
// each as two m16n8k16 steps from a zero accumulator: the order in which
// gemm_bf16_kernel sums an output, so the same bits. W's rows stream
// through the stages at ws, A's rows either resident (a_res, row stride
// lda) or streamed beside them (a_res null: the stages at as). The caller
// has issued sr_fill for tiles 0 .. kSrStages - 2. On return every copy
// has landed and the block is past its last read of the stages.
template <int CH>
__device__ __forceinline__ void sr_project(float (&acc)[CH / 8][4],
                                           const bf16* w, bf16* ws,
                                           const bf16* a_glob, int a_rows,
                                           bf16* as, const bf16* a_res,
                                           int lda, int C) {
  using L = SrPlan<CH>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ktiles = C / kSrKt;
#pragma unroll
  for (int n = 0; n < CH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int tile = 0; tile < ktiles; ++tile) {
    // this tile has landed, and every warp is done with the one before,
    // whose stage the copy of tile + 2 may now overwrite
    cp_async_wait<kSrStages - 2>();
    __syncthreads();
    sr_fill<CH>(tile + kSrStages - 1, ktiles, w, ws, a_glob, a_rows, as, C);
    const int s = tile % kSrStages;
    const bf16* at = a_res ? a_res + tile * kSrKt : as + s * L::kXTile;
    const int ld = a_res ? lda : kSrLd;
    const bf16* wt = ws + s * L::kWTile;
#pragma unroll
    for (int kk = 0; kk < kSrKt; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, at + (warp * 16 + lane % 16) * ld + kk + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < CH / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, wt + (16 * n2 + lane % 8 + (lane / 16) * 8) * kSrLd +
                           kk + ((lane / 8) % 2) * 8);
        mma_bf16(acc[2 * n2], a, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Grid (heads, query tiles, B) in clusters of (heads, 1, 1): block h of a
// cluster is head h of kAbRows query rows of image b.
template <int CH>
__global__ void __launch_bounds__(kAbThreads)
sr_attention_bf16_kernel(SrBf16Args a) {
  namespace cg = cooperative_groups;
  using L = SrPlan<CH>;
  using K = typename L::Keys;
  extern __shared__ __align__(16) unsigned char sr_smem[];
  const int C = a.C;
  bf16* Ks = reinterpret_cast<bf16*>(sr_smem);  // (a), (b)
  unsigned char* Vs = reinterpret_cast<unsigned char*>(Ks + 2 * K::kK);
  bf16* xs = reinterpret_cast<bf16*>(sr_smem + K::kBytes);
  bf16* wqs = xs + kSrStages * L::kXTile;
  const int ldg = C + 8;
  bf16* Og = reinterpret_cast<bf16*>(sr_smem);  // (c): [kAbRows][ldg]
  bf16* wps = Og + kAbRows * ldg;
  bf16* Os = wps + kSrStages * L::kWTile;  // [kAbRows][kLdO]

  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, heads = gridDim.x, b = blockIdx.z;
  const int n0 = blockIdx.y * kAbRows;
  const int row_a = n0 + warp * 16 + g;  // this thread's first row
  const int ktiles = C / kSrKt;
  const bf16* x = a.x + ((long long)b * a.N + n0) * C;

  // the head's keys and values, the first tile on its way at once
  const bf16* kp = a.kv + (long long)b * a.M * 2 * C + h * CH;
  const AbKeys<CH, CH, false> keys{kp, 2 * C, kp + C, 2 * C, a.M, Ks, Vs};
  keys.start();

  // (a) q_h = bf16(x Wq[h]^T + bq[h]) for the warp's 16 rows, packed from
  // the accumulators into the A fragments of q k^T (as the key loop packs
  // P): it never leaves the registers
  uint32_t qf[CH / 16][4];
  {
    const bf16* wq = a.wq + (long long)h * CH * C;
#pragma unroll
    for (int s = 0; s < kSrStages - 1; ++s)
      sr_fill<CH>(s, ktiles, wq, wqs, x, a.N - n0, xs, C);
    float acc[CH / 8][4];
    sr_project<CH>(acc, wq, wqs, x, a.N - n0, xs, nullptr, 0, C);
    const float* bq = a.bq + h * CH;
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;
      qf[kk][0] = pack_bf16(acc[2 * kk][0] + bq[c0], acc[2 * kk][1] + bq[c0 + 1]);
      qf[kk][1] = pack_bf16(acc[2 * kk][2] + bq[c0], acc[2 * kk][3] + bq[c0 + 1]);
      qf[kk][2] =
          pack_bf16(acc[2 * kk + 1][0] + bq[c1], acc[2 * kk + 1][1] + bq[c1 + 1]);
      qf[kk][3] =
          pack_bf16(acc[2 * kk + 1][2] + bq[c1], acc[2 * kk + 1][3] + bq[c1 + 1]);
    }
  }

  // (b) o_h = softmax(q_h k_h^T / sqrt(CH)) v_h over the image's M keys,
  // rounded to bf16 into the block's o tile
  {
    float o[K::kAccN][4], inv[2];
    keys.run(nullptr, a.N, a.scale, row_a, qf, o, inv, [] {});
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      bf16* dst = Os + (warp * 16 + g + 8 * hf) * L::kLdO + 2 * t;
#pragma unroll
      for (int c = 0; c < CH / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
            __floats2bfloat162_rn(o[c][2 * hf] * inv[hf],
                                  o[c][2 * hf + 1] * inv[hf]);
    }
  }

  // (c) out[:, h] = bf16(o Wp[h]^T + bp[h]) with o [kAbRows, C] from the
  // whole cluster: once every block is past its key loop (the first
  // barrier), each writes its o tile into every block's Og (stores to
  // distributed shared memory, none waited on), and the second barrier
  // makes them visible. Wp's first tiles are on their way meanwhile.
  const bf16* wp = a.wp + (long long)h * CH * C;
  __syncthreads();  // the o tile is whole and the key loop's stages free
#pragma unroll
  for (int s = 0; s < kSrStages - 1; ++s)
    sr_fill<CH>(s, ktiles, wp, wps, nullptr, 0, nullptr, C);
  cluster.sync();
  constexpr int kChunks = CH / 8;  // 16-byte chunks of an o row
  constexpr int kPer = kAbRows * kChunks / kAbThreads;  // a thread's
  uint4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kAbThreads;
    v[i] = *reinterpret_cast<const uint4*>(Os + (e / kChunks) * L::kLdO +
                                           (e % kChunks) * 8);
  }
  for (int r = 0; r < heads; ++r) {
    bf16* dst = cluster.map_shared_rank(Og, r) + h * CH;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kAbThreads;
      *reinterpret_cast<uint4*>(dst + (e / kChunks) * ldg +
                                (e % kChunks) * 8) = v[i];
    }
  }
  cluster.sync();
  float acc[CH / 8][4];
  sr_project<CH>(acc, wp, wps, nullptr, 0, nullptr, Og, ldg, C);
  const float* bp = a.bp + h * CH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int n = row_a + 8 * hf;
    if (n >= a.N) continue;
    bf16* dst = a.out + ((long long)b * a.N + n) * C + h * CH + 2 * t;
#pragma unroll
    for (int c = 0; c < CH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) = __floats2bfloat162_rn(
          acc[c][2 * hf] + bp[8 * c + 2 * t],
          acc[c][2 * hf + 1] + bp[8 * c + 2 * t + 1]);
  }
}

template <int CH>
cudaError_t sr_attention_bf16_launch(const SrBf16Args& a, int B, int heads,
                                     cudaStream_t stream) {
  const size_t bytes = SrPlan<CH>::bytes(a.C);
  // raised once per size, not per launch (one card per process)
  static size_t allowed = 0;
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        sr_attention_bf16_kernel<CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads, ceil_div(a.N, kAbRows), B);
  cfg.blockDim = dim3(kAbThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = heads;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sr_attention_bf16_kernel<CH>, a);
}

}  // namespace
}  // namespace emip

// The bf16 forward (the bf16 band): x, kv_in and the three weights bf16,
// the biases fp32; kv_buf [B, M, 2C] bf16 scratch, out [B, N, C] bf16. Two
// launches: the kv projection (the bf16 GEMM), then the fused kernel.
extern "C" int emip_sr_attention_bf16(const void* x, const void* kv_in,
                                      const void* wq, const float* bq,
                                      const void* wkv, const float* bkv,
                                      const void* wp, const float* bp,
                                      void* kv_buf, void* out, int B, int N,
                                      int M, int C, int heads, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || M <= 0 || heads <= 0 || heads > kSrMaxHeads ||
      C % heads || !aligned16_ptr(x) || !aligned16_ptr(wq) ||
      !aligned16_ptr(wp) || !aligned16_ptr(kv_buf))
    return (int)cudaErrorInvalidValue;
  const int ch = C / heads;
  bf16* kvb = static_cast<bf16*>(kv_buf);
  cudaError_t err;
  if ((err = linear_bf16(static_cast<const bf16*>(kv_in), C,
                         static_cast<const bf16*>(wkv), C, bkv, kvb, 2 * C,
                         B * M, 2 * C, C, true, s)))
    return err;
  SrBf16Args a;
  a.x = static_cast<const bf16*>(x);
  a.wq = static_cast<const bf16*>(wq);
  a.bq = bq;
  a.kv = kvb;
  a.wp = static_cast<const bf16*>(wp);
  a.bp = bp;
  a.out = static_cast<bf16*>(out);
  a.N = N; a.M = M; a.C = C;
  a.scale = 1.0f / sqrtf((float)ch);
  if (ch == 64)
    err = sr_attention_bf16_launch<64>(a, B, heads, s);
  else if (ch == 32)
    err = sr_attention_bf16_launch<32>(a, B, heads, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
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
