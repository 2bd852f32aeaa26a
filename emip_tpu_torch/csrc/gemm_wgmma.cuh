// The product of kernels B's and H's bf16 forwards and of G's and H's bf16
// backwards on Hopper's warpgroup tensor cores: y = epilogue(sum_s A_s
// W_s^T) as 3xTF32, the products of _block_kernel (after its self layer),
// _ffn_kernel, _bwd_kernel and _ffn_bwd_kernel of
// emip_tpu/ops/pallas/window_attention.py: the q, k, v projections and the
// merge Wm, the FFN's [x, msg] W0 and u W2, and the input grads dy W.
//
//   wg_linear       A_s [M, K_s] row-major (leading dimension of its own;
//                   fp32, or bf16 read as it lies), W an nn.Linear weight
//                   [N, K] split once per call into its TF32 halves
//                   (wg_split_weights: [2N, K], hi rows then lo rows).
//                   Two sources either follow each other along K (W0:
//                   x or x1 over W0's first C columns, then msg over the
//                   last C, summed in the order of the K tiles, no concat
//                   buffer) or share K and split the columns (q from x, k
//                   and v from t: one launch over the stacked [Wq; Wk; Wv]).
//                   Epilogues: none; exact GELU (W0), also keeping the
//                   pre-activation h (the backwards' recompute); a row
//                   LayerNorm where one block's column tile holds the whole
//                   row (N = C: Wm into msg), also keeping the pre-LN m; the
//                   same LayerNorm plus a bf16 residual and one rounding to
//                   bf16 (W2: out = bf16(x + LN2(z))); the GELU derivative
//                   at h (gh = (gz W2) gelu'(h)); an fp32 or bf16 addend
//                   over the first columns and an output in fp32 or
//                   rounded to bf16 once (gx = bf16(g + gq Wq)).
//                   An input grad dy W (W [N, K]) is the K-major dy (W^T)^T:
//                   wg_split_weights writes W^T's halves (a transposing
//                   segment), once per call.
//
// What bounds it: operations, 2 M N K per product, taken as three TF32
// products (a.lo b.hi + a.hi b.lo + a.hi b.hi, the small terms first, as
// mma_3xtf32 of mma_tf32.cuh), two where A is exact in TF32 (a bf16 value
// is: its low half is zero, so a.lo b.hi adds +0 and is left out, as
// A_EXACT leaves it out there). Only wgmma reaches the card's full
// tensor-core rate, and TF32 wgmma takes both operands K-major; the
// forward's x W^T is K-major on both sides (A rows along K, W rows along
// K), so it is here; so is an input grad dy W on the transposed weight,
// split once per call (a weight is at most 1024 x 256). The weight grads
// dY^T X read both operands M- or N-major and stay on mma.sync in
// gemm_tf32.cuh.
//
// Design. A block is one producer warp and WG consumer warpgroups (WG = 2:
// 128 rows; 1: 64 rows, where 128-row tiles would leave SMs idle) over a
// BN-column tile (BN = 128, or 64 where C = 64). The producer keeps a ring
// of four stages filled by TMA (cp.async.bulk.tensor, one mbarrier per
// stage for the bytes and one for the consumers' release): each stage
// holds a K tile of 32 of A (fp32 rows of 128 bytes, 128-byte swizzle;
// bf16 rows of 64 bytes, 64-byte swizzle, half the bytes) and of W_hi and
// W_lo (128-byte swizzle, the layout the wgmma descriptors read). A
// consumer warpgroup reads its 64 rows of A from shared memory into the
// wgmma register fragments (the swizzles put the eight rows of a fragment
// on different banks), splits fp32 values into their TF32 halves with
// tf32_split, widens bf16 by a shift, and issues wgmma.m64nBNk8.tf32 with
// A from registers and W from shared memory. The tensor core truncates as
// it accumulates, so each K tile's products go to an accumulator of their
// own (scale-d 0 on the tile's first product), which an fp32 add folds into
// the running sum, as gemm_tf32.cuh does: the error of a sum over K = 1024
// stays at fp32 grade. A thread holds 2 x BN / 2 accumulators: the
// LayerNorm of a row is a sum over a thread's values and two shuffles in
// its quad. Each k-step's products are a wgmma group of their own, so that
// the next k-step's fragments are read while they run and only two
// fragment sets are live: with two consumer warpgroups and the producer
// warp (nine warps, three on some sub-partition) a thread has 168
// registers, which the fp32 LayerNorm instantiations overrun by 4 bytes of
// spill (raising the consumers to 232 by setmaxnreg removed the spill and
// left the time as it was, so the simpler form stays). Ragged M, N and K
// tiles are zero-filled by TMA and the stores are masked. Rows must start
// 16-byte aligned (leading dimensions of 4 floats or 8 bf16): the wrapper
// refuses others, there is no other path. No atomics: a second call gives
// the same bits.
//
// Below it, the bf16 form (wg_linear_bf16, G's bf16 forward: two bf16
// operands, one wgmma.m64nNk16.bf16 product summed in fp32) and the pieces
// the bf16 attention of attention_bf16.cu shares with it: the bf16 wgmma
// from shared memory or with A from registers and an MN-major B. Every
// form loads its boxes through one TMA map builder (wg_map) and one load
// (tma_load_3d).

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "bf16.cuh"

namespace emip {
namespace {

constexpr int kWgBK = 32;  // K tile: 32 fp32, 128 bytes
constexpr int kWgStages = 4;

// each epilogue is an instantiation of its own, so that the others keep
// their registers
enum {
  kWgEpiNone = 0,
  kWgEpiGelu = 1,
  kWgEpiLn = 2,
  kWgEpiLnOut = 3,
  kWgEpiGeluKeep = 4,  // GELU, the pre-activation into aux
  kWgEpiLnKeep = 5,    // LayerNorm, the pre-LN row into aux
  kWgEpiGeluGrad = 6,  // times gelu'(aux)
  kWgEpiAdd = 7,       // (add +), fp32 or bf16 out
};

// One launch's operands and epilogue: TMA maps of the two A sources and of
// the split weight [2N, k0 + k1] (lo rows from w_lo = N); columns at or past
// n_switch read a[1] over k0 (k1 = 0), else k1 > 0 puts a[1] after a[0]
// along K. out [M, N] (leading dimension ldo): fp32, or bf16 for
// kWgEpiLnOut and out_bf16; gamma, beta [N] for the LayerNorms; res [M, N]
// bf16 (ldres) for kWgEpiLnOut; aux [M, N] fp32 (ldaux) kept or read by the
// Keep and GeluGrad epilogues; add [M, add_cols] fp32 or bf16 (ldadd) or
// null for kWgEpiAdd.
struct WgArgs {
  CUtensorMap a[2];
  CUtensorMap w;
  int M, N, k0, k1, n_switch, w_lo;
  void* out;
  long long ldo;
  const float* gamma;
  const float* beta;
  float eps;
  const __nv_bfloat16* res;
  long long ldres;
  float* aux;
  long long ldaux;
  const void* add;
  long long ldadd;
  int add_cols;
  bool add_bf16, out_bf16;
};

template <int BN, int WG>
struct WgPlan {
  static constexpr int kBM = 64 * WG;
  static constexpr int kABytes = kBM * kWgBK * 4;  // fp32; bf16 uses half
  static constexpr int kWBytes = BN * kWgBK * 4;   // one of W_hi, W_lo
  static constexpr int kStage = kABytes + 2 * kWBytes;
  static constexpr int kThreads = 128 * WG + 32;  // and one producer warp
  // the tiles, the barriers, and room to align the ring to 1024 bytes
  static constexpr size_t kBytes =
      (size_t)kWgStages * kStage + 2 * kWgStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed; a wait of 2^35 clocks
// (over 15 s) traps: a lost arrival faults the launch instead of hanging it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// a box of a 3D map at (inner c0, row c1, batch c2) into dst, its bytes
// reported to bar; elements past the map's bounds arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major tile of 8-row groups 1024 bytes apart, rows
// of 128 bytes in the 128-byte swizzle (the TMA layout of W_hi, W_lo); a
// k-step of 8 TF32 values starts 32 bytes further (+2 in 16-byte units).
__device__ __forceinline__ uint64_t wg_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define EMIP_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define EMIP_D16(i) EMIP_D4(i), EMIP_D4(i + 4), EMIP_D4(i + 8), EMIP_D4(i + 12)

// d[64, BN] (+)= a[64, 8] . B[BN, 8]^T, tf32 in, fp32 accumulators; a from
// registers in mma.m16n8k8's A layout per warp (rows 16 w + g, + 8; k t,
// t + 4), B by descriptor; scale_d 0 overwrites d. Accumulator j of
// thread (warp w, g, t): row 16 w + g + 8 ((j / 2) % 2), column 8 (j / 4)
// + 2 t + j % 2.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}"
      : EMIP_D16(0), EMIP_D16(16), EMIP_D16(32), EMIP_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}"
      : EMIP_D16(0), EMIP_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

#undef EMIP_D16
#undef EMIP_D4

// Element (r, k) of a staged A tile: fp32 rows of 32 in the 128-byte
// swizzle (16-byte chunk k / 4 moved to (k / 4) ^ (r % 8)), bf16 rows of 32
// in the 64-byte swizzle (chunk k / 8 to (k / 8) ^ ((r / 2) % 4)).
template <typename T>
__device__ __forceinline__ int wg_a_index(int r, int k) {
  if constexpr (kBf16<T>)
    return r * kWgBK + ((((k >> 3) ^ (r >> 1)) & 3) << 3) + (k & 7);
  else
    return r * kWgBK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

// One K tile of a consumer warpgroup: part = the tile's products (scale-d 0
// on its first), three TF32 terms a fragment pair, two for an exact A. Each
// k-step's products are a group of their own: the fragments of k-step s + 1
// are read and split while group s runs, and a fragment set is reused once
// its group is done (wait_group 1), so two sets are live.
template <typename TA, int BN>
__device__ __forceinline__ void wg_tile(float (&part)[BN / 2],
                                        const unsigned char* a_stage,
                                        const unsigned char* w_hi,
                                        const unsigned char* w_lo, int warp,
                                        int g, int t) {
  constexpr bool kExactA = kBf16<TA>;
  const TA* A = reinterpret_cast<const TA*>(a_stage);
  const int r0 = 16 * warp + g;
  const uint64_t dh = wg_desc(w_hi), dl = wg_desc(w_lo);
  wg_fence_regs(part);
#pragma unroll
  for (int ks = 0; ks < kWgBK / 8; ++ks) {
    const int k = 8 * ks + t;
    uint32_t hi[4], lo[4];
    split_as(A[wg_a_index<TA>(r0, k)], hi[0], lo[0]);
    split_as(A[wg_a_index<TA>(r0 + 8, k)], hi[1], lo[1]);
    split_as(A[wg_a_index<TA>(r0, k + 4)], hi[2], lo[2]);
    split_as(A[wg_a_index<TA>(r0 + 8, k + 4)], hi[3], lo[3]);
    wgmma_fence();
    if constexpr (!kExactA) wgmma_tf32<BN>(part, lo, dh + 2 * ks, ks);
    wgmma_tf32<BN>(part, hi, dl + 2 * ks, kExactA ? ks : 1);
    wgmma_tf32<BN>(part, hi, dh + 2 * ks, 1);
    wgmma_commit();
    if (ks > 0) wgmma_wait<1>();
  }
  wgmma_wait<0>();
  wg_fence_regs(part);
}

template <typename TA0, typename TA1, int BN, int WG, int EPI>
__global__ void __launch_bounds__(WgPlan<BN, WG>::kThreads, 1)
wg_gemm_kernel(const __grid_constant__ WgArgs g) {
  using P = WgPlan<BN, WG>;
  static_assert(std::is_same_v<TA0, float> || kBf16<TA0>, "fp32 or bf16");
  static_assert(std::is_same_v<TA1, float> || kBf16<TA1>, "fp32 or bf16");
  extern __shared__ unsigned char wg_smem_raw[];
  const uint32_t raw = smem_u32(wg_smem_raw);
  unsigned char* ring = wg_smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * P::kStage);
  uint64_t* empty = full + kWgStages;

  const int row0 = blockIdx.y * P::kBM, col0 = blockIdx.x * BN;
  // along N a column tile reads one source over k0; along K source 0's
  // tiles come first, then source 1's
  const bool along_k = g.k1 > 0;
  const int src_n = (!along_k && col0 >= g.n_switch) ? 1 : 0;
  const int tiles0 = (g.k0 + kWgBK - 1) / kWgBK;
  const int tiles1 = along_k ? (g.k1 + kWgBK - 1) / kWgBK : 0;
  const int tiles = tiles0 + tiles1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * WG) {  // the producer warp
    if (threadIdx.x != 128 * WG) return;
    for (int kt = 0; kt < tiles; ++kt) {
      const int s = kt % kWgStages;
      if (kt >= kWgStages)
        mbar_wait(&empty[s], ((kt / kWgStages) + 1) & 1);
      const bool second = kt >= tiles0;
      const int src = along_k ? (second ? 1 : 0) : src_n;
      const bool a16 = src ? kBf16<TA1> : kBf16<TA0>;
      const int ka = (second ? kt - tiles0 : kt) * kWgBK;  // in the source
      const int kw = kt * kWgBK;  // in W (tiles0 whole tiles: k0 % 32 == 0)
      unsigned char* st = ring + s * P::kStage;
      mbar_expect_tx(&full[s], (a16 ? P::kABytes / 2 : P::kABytes) +
                                   2 * P::kWBytes);
      tma_load_3d(st, &g.a[src], &full[s], ka, row0, 0);
      tma_load_3d(st + P::kABytes, &g.w, &full[s], kw, col0, 0);
      tma_load_3d(st + P::kABytes + P::kWBytes, &g.w, &full[s], kw,
                  g.w_lo + col0, 0);
    }
    return;
  }

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, gq = lane / 4, tq = lane % 4;
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  auto consume = [&](auto tag, int kt) {
    using TA = decltype(tag);
    const int s = kt % kWgStages;
    mbar_wait(&full[s], (kt / kWgStages) & 1);
    const unsigned char* st = ring + s * P::kStage;
    wg_tile<TA, BN>(part, st + wg * 64 * kWgBK * sizeof(TA),
                    st + P::kABytes, st + P::kABytes + P::kWBytes, warp, gq,
                    tq);
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  };
  if (src_n == 0) {
    for (int kt = 0; kt < tiles0; ++kt) consume(TA0{}, kt);
  } else {
    for (int kt = 0; kt < tiles0; ++kt) consume(TA1{}, kt);
  }
  for (int kt = tiles0; kt < tiles; ++kt) consume(TA1{}, kt);

  // rows r0 (h = 0) and r0 + 8 (h = 1); columns col0 + 8 j + 2 tq, + 1
  constexpr bool kLn =
      EPI == kWgEpiLn || EPI == kWgEpiLnOut || EPI == kWgEpiLnKeep;
  const int r0 = row0 + 64 * wg + 16 * warp + gq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    float mu = 0.f, inv = 0.f;
    if constexpr (kLn) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        s += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      mu = s / BN;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dlt = acc[4 * j + 2 * h + c] - mu;
          v += dlt * dlt;
        }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      inv = rsqrtf(v / BN + g.eps);
    }
    if (r >= g.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * tq;
      if (col >= g.N) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const long long at = (long long)r * g.ldaux + col;
      if constexpr (EPI == kWgEpiGeluKeep || EPI == kWgEpiLnKeep)
        *reinterpret_cast<float2*>(g.aux + at) = make_float2(v0, v1);
      if constexpr (EPI == kWgEpiGelu || EPI == kWgEpiGeluKeep) {
        v0 = gelu_exact(v0);
        v1 = gelu_exact(v1);
      } else if constexpr (kLn) {
        v0 = (v0 - mu) * inv * g.gamma[col] + g.beta[col];
        v1 = (v1 - mu) * inv * g.gamma[col + 1] + g.beta[col + 1];
      } else if constexpr (EPI == kWgEpiGeluGrad) {
        const float2 pre = *reinterpret_cast<const float2*>(g.aux + at);
        v0 *= gelu_grad(pre.x);
        v1 *= gelu_grad(pre.y);
      } else if constexpr (EPI == kWgEpiAdd) {
        if (g.add && col < g.add_cols) {
          const long long ad = (long long)r * g.ldadd + col;
          if (g.add_bf16) {
            const __nv_bfloat162 a2 = *reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const __nv_bfloat16*>(g.add) + ad);
            v0 = __low2float(a2) + v0;
            v1 = __high2float(a2) + v1;
          } else {
            const float2 a2 = *reinterpret_cast<const float2*>(
                static_cast<const float*>(g.add) + ad);
            v0 = a2.x + v0;
            v1 = a2.y + v1;
          }
        }
      }
      if constexpr (EPI == kWgEpiAdd) {
        if (g.out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(g.out) + (long long)r * g.ldo +
              col) = __floats2bfloat162_rn(v0, v1);
          continue;
        }
      }
      if constexpr (EPI == kWgEpiLnOut) {
        const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(
            g.res + (long long)r * g.ldres + col);
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(g.out) + (long long)r * g.ldo + col) =
            __floats2bfloat162_rn(__low2float(x2) + v0,
                                  __high2float(x2) + v1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(g.out) +
                                   (long long)r * g.ldo + col) =
            make_float2(v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the library links no libcuda)
using WgEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline WgEncodeFn wg_encoder() {
  static const WgEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<WgEncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A [batches, rows, inner] operand (row and batch strides in elements, the
// inner one 1) in boxes of [box_rows, box_inner], swizzled by the box's
// row bytes (box_inner elements: 64 or 128 bytes); a box reaching past
// rows or inner of its batch gets zeros there. Strides must be multiples
// of 16 bytes. wg_linear reads rows of 32 (fp32 in the 128-byte swizzle,
// bf16 in the 64-byte one), wg_linear_bf16 and the attention rows of 64
// bf16 or 32 fp32 (128 bytes); a 2D operand is one batch.
inline cudaError_t wg_map(CUtensorMap* map, const void* p, bool bf16,
                          long long inner, long long rows, long long batches,
                          long long row_stride, long long batch_stride,
                          int box_inner, int box_rows) {
  const WgEncodeFn encode = wg_encoder();
  const int elem = bf16 ? 2 : 4, row_bytes = box_inner * elem;
  if (!encode) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(p) % 16 || (row_stride * elem) % 16 ||
      (batch_stride * elem) % 16 || inner < 1 || rows < 1 || batches < 1 ||
      row_stride < inner || batch_stride < 1 ||
      (row_bytes != 64 && row_bytes != 128))
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)(row_stride * elem),
                                 (cuuint64_t)(batch_stride * elem)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// An A source: p [M, k] row-major with leading dimension ld (elements).
struct WgSource {
  const void* p;
  long long ld;
  int k;
};

// What the epilogue reads or keeps besides out (null where it reads
// nothing); see WgArgs.
struct WgEpilogue {
  const float* gamma;
  const float* beta;
  const __nv_bfloat16* res;
  long long ldres;
  float eps;
  float* aux;
  long long ldaux;
  const void* add;
  long long ldadd;
  int add_cols;
  bool add_bf16, out_bf16;
};

// Splits up to ten fp32 weights into their TF32 halves: element (r, c)
// of seg i's src [rows, cols] (row-major) goes to hi (tf32 rounded) and lo
// (the fp32 rest, which the tensor core truncates), as tf32_split splits a
// fragment, at r * ld + c, or transposed at c * ld + r (the W^T of an
// input grad; a stacked weight's blocks side by side through ld).
constexpr int kWgSplitSegs = 10;
struct WgSplitSeg {
  const float* src;
  float* hi;
  float* lo;
  int rows, cols;
  long long ld;
  bool transpose;
};
struct WgSplitArgs {
  WgSplitSeg seg[kWgSplitSegs];
};

__global__ void wg_split_kernel(WgSplitArgs a) {
  const WgSplitSeg s = a.seg[blockIdx.y];
  const long long n = (long long)s.rows * s.cols;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / s.cols, c = i % s.cols;
    const long long at = s.transpose ? c * s.ld + r : r * s.ld + c;
    uint32_t hi, lo;
    tf32_split(s.src[i], hi, lo);
    s.hi[at] = __uint_as_float(hi);
    s.lo[at] = __uint_as_float(lo);
  }
}

inline cudaError_t wg_split_weights(const WgSplitArgs& a, int count,
                                    cudaStream_t stream) {
  long long most = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = (long long)a.seg[i].rows * a.seg[i].cols;
    most = n > most ? n : most;
  }
  if (count < 1 || count > kWgSplitSegs || most == 0)
    return cudaErrorInvalidValue;
  const int blocks = (int)(most < 256LL * 256 ? (most + 255) / 256 : 256);
  wg_split_kernel<<<dim3(blocks, count), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TA0, typename TA1, int BN, int WG, int EPI>
cudaError_t wg_launch(const WgArgs& g, cudaStream_t stream) {
  using P = WgPlan<BN, WG>;
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg_gemm_kernel<TA0, TA1, BN, WG, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ceil_div(g.N, BN), ceil_div(g.M, P::kBM));
  wg_gemm_kernel<TA0, TA1, BN, WG, EPI>
      <<<grid, P::kThreads, P::kBytes, stream>>>(g);
  return cudaGetLastError();
}

// out = epilogue(a0 W^T) over N columns, or with a1: along N (n_switch <
// N) columns at or past n_switch from a1 over the same k0 (a1.k unread),
// else along K out = epilogue(a0 W[:, :k0]^T + a1 W[:, k0:]^T). TA0,
// TA1: float, or uint16_t for bf16 bits. wsplit: W [N, K] split by
// wg_split_weights into [2N, K] (K = k0 + a1.k). bn: 128, or 64 (the
// LayerNorm epilogues need bn = N, the split along N n_switch % bn = 0).
// A single source passes n_switch >= N.
template <typename TA0, typename TA1, int EPI>
cudaError_t wg_linear(WgSource a0, WgSource a1, int n_switch,
                      const float* wsplit, int M, int N, int bn, void* out,
                      long long ldo, WgEpilogue e, cudaStream_t stream) {
  const bool along_k = a1.p && n_switch >= N;
  const int kw = a0.k + (along_k ? a1.k : 0);
  constexpr bool kAux = EPI == kWgEpiGeluKeep || EPI == kWgEpiLnKeep ||
                        EPI == kWgEpiGeluGrad;
  constexpr bool kLn =
      EPI == kWgEpiLn || EPI == kWgEpiLnOut || EPI == kWgEpiLnKeep;
  if (M == 0 || N == 0) return cudaSuccess;
  if ((bn != 64 && bn != 128) || a0.k < 1 ||
      (along_k && (a0.k % kWgBK || a1.k < 1)) ||
      (a1.p && !along_k && n_switch % bn) || (!a1.p && n_switch < N) ||
      ldo % 2 || N % 2 || kw % 4 ||
      reinterpret_cast<uintptr_t>(out) % 8 ||
      (kLn && N != bn) || (EPI == kWgEpiLnOut && (!e.res || e.ldres % 2)) ||
      (kLn && (!e.gamma || !e.beta)) ||
      (kAux && (!e.aux || e.ldaux % 2 ||
                reinterpret_cast<uintptr_t>(e.aux) % 8)) ||
      (EPI == kWgEpiAdd && e.add &&
       (e.ldadd % 2 || e.add_cols % 2 ||
        reinterpret_cast<uintptr_t>(e.add) % (e.add_bf16 ? 4 : 8))))
    return cudaErrorInvalidValue;
  // two warpgroups (128 rows) where that fills the card, else one
  const bool two = (long long)ceil_div(M, 128) * ceil_div(N, bn) >= kSmCount;
  const int bm = two ? 128 : 64;
  WgArgs g;
  cudaError_t err;
  if ((err = wg_map(&g.a[0], a0.p, kBf16<TA0>, a0.k, M, 1, a0.ld, a0.ld,
                    kWgBK, bm)) != cudaSuccess)
    return err;
  if (a1.p) {
    if ((err = wg_map(&g.a[1], a1.p, kBf16<TA1>, along_k ? a1.k : a0.k, M,
                      1, a1.ld, a1.ld, kWgBK, bm)) != cudaSuccess)
      return err;
  } else {
    g.a[1] = g.a[0];
  }
  if ((err = wg_map(&g.w, wsplit, false, kw, 2LL * N, 1, kw, kw, kWgBK,
                    bn)) != cudaSuccess)
    return err;
  g.M = M;
  g.N = N;
  g.k0 = a0.k;
  g.k1 = along_k ? a1.k : 0;
  g.n_switch = a1.p && !along_k ? n_switch : N;
  g.w_lo = N;
  g.out = out;
  g.ldo = ldo;
  g.gamma = e.gamma;
  g.beta = e.beta;
  g.eps = e.eps;
  g.res = e.res;
  g.ldres = e.ldres;
  g.aux = e.aux;
  g.ldaux = e.ldaux;
  g.add = e.add;
  g.ldadd = e.ldadd;
  g.add_cols = e.add_cols;
  g.add_bf16 = e.add_bf16;
  g.out_bf16 = EPI == kWgEpiAdd && e.out_bf16;
  if (bn == 128)
    return two ? wg_launch<TA0, TA1, 128, 2, EPI>(g, stream)
               : wg_launch<TA0, TA1, 128, 1, EPI>(g, stream);
  return two ? wg_launch<TA0, TA1, 64, 2, EPI>(g, stream)
             : wg_launch<TA0, TA1, 64, 1, EPI>(g, stream);
}

// ------------------------------------------------------- the bf16 form
//
// Products of two bf16 operands on wgmma.m64nNk16.f32.bf16.bf16, the sums
// in fp32: G's bf16 forward (q, k, v and o Wm^T, wg_linear_bf16 below) and
// the bf16 attention of attention_bf16.cu. Operands come by TMA in boxes
// of 64 bf16 a row (128 bytes, the 128-byte swizzle), K-major as they lie,
// or MN-major for the B operand of P V (the values [keys, D], read
// transposed: 16-bit wgmma takes imm-trans-b).

// The descriptor of an MN-major tile of 16-bit values: K rows of 128 bytes
// (64 values along N) in the 128-byte swizzle, 8-row groups 1024 bytes
// apart. With N = 64 (one swizzle atom along N) the only stride read is
// that of the 8-row groups, so both offset fields hold it.
__device__ __forceinline__ uint64_t wg_desc_mn(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

#define EMIP_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define EMIP_D16(i) EMIP_D4(i), EMIP_D4(i + 4), EMIP_D4(i + 8), EMIP_D4(i + 12)

// d[64, N] (+)= A[64, 16] . B[N, 16]^T, bf16 in, fp32 accumulators, A and
// B by descriptor, both K-major; scale_d 0 overwrites d. Accumulator j of
// thread (warp w, g, t) as wgmma_tf32's.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}"
      : EMIP_D16(0), EMIP_D16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}"
      : EMIP_D16(0), EMIP_D16(16), EMIP_D16(32), EMIP_D16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64, 64] += a[64, 16] . B[16, 64], A from registers in mma.m16n8k16's
// bf16 A layout per warp (rows 16 w + g, + 8; k 2 t, 2 t + 1, + 8), B by
// an MN-major descriptor (imm-trans-b 1).
__device__ __forceinline__ void wgmma_bf16_rt(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}"
      : EMIP_D16(0), EMIP_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64, 32] (+)= a[64, 16] . B[32, 16]^T, A from registers in mma.m16n8k16's
// bf16 A layout per warp, B by a K-major descriptor; scale_d 0 overwrites d
// (F's q k^T with q held in registers).
__device__ __forceinline__ void wgmma_bf16_ra32(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}"
      : EMIP_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef EMIP_D16
#undef EMIP_D4

// the softmax of the bf16 attention (attention_bf16.cu) and of F's bf16
// forward (memory_attention.cu) takes e^x as 2^(x log2 e) on the MUFU
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from reusing A-operand registers that an asynchronous
// product may still read
template <int N>
__device__ __forceinline__ void wg_fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---------------------------------------------- wg_linear_bf16 (kernel G)
//
// out = bf16(epilogue(A W^T)) with A [M, K] and W [N, K] bf16 (the
// weights cast at use), the products summed in fp32 on the tensor core
// across K. A block is one producer warp and one consumer warpgroup (64
// rows) over a BN-column tile; the producer keeps a ring of stages filled
// by TMA, each a K tile of 64 of A and of W (128-byte rows in the 128-byte
// swizzle, the layout the descriptors read). Column tiles at or past
// n_switch read A's second source; column tile col0 reads weight col0 /
// w_rows from its row col0 % w_rows, so q, k and v come from x and t over
// Wq, Wk, Wv in one launch with no stacked copy. K is the model's width
// (128, or 64 at b0), so the ring has two stages: four blocks an SM, one
// block's epilogue overlapping another's loads; the epilogue's bf16 tile
// leaves through shared memory in coalesced 16-byte stores (N and the
// leading dimension multiples of 8). Epilogues: the bf16
// rounding (q, k, v); G's merge, msg = bf16(LN1(o Wm^T)) over the row that
// one column tile holds (N = BN), then out = bf16(x + msg) with the
// residual, else msg.

enum { kWbEpiBf16 = 0, kWbEpiLnMsg = 1 };
constexpr int kWbBK = 64;  // K tile: 64 bf16, 128 bytes
constexpr int kWbStages = 2;
constexpr int kWbBM = 64;
constexpr int kWbThreads = 128 + 32;

template <int BN>
struct WbPlan {
  static constexpr int kABytes = kWbBM * 128;
  static constexpr int kWBytes = BN * 128;
  static constexpr int kStage = kABytes + kWBytes;
  static constexpr size_t kBytes =
      (size_t)kWbStages * kStage + 2 * kWbStages * 8 + 1024;
};

struct WbArgs {
  CUtensorMap a[2];
  CUtensorMap w[3];
  int M, N, K, n_switch, w_rows;
  __nv_bfloat16* out;
  long long ldo;
  const float* gamma;
  const float* beta;
  float eps;
  const __nv_bfloat16* res;
  long long ldres;
};

// Grid (column tiles, row tiles of 64); four blocks an SM.
template <int BN, int EPI>
__global__ void __launch_bounds__(kWbThreads, 4)
wg_bf16_kernel(const __grid_constant__ WbArgs g) {
  using P = WbPlan<BN>;
  extern __shared__ unsigned char wb_smem_raw[];
  const uint32_t raw = smem_u32(wb_smem_raw);
  unsigned char* ring = wb_smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWbStages * P::kStage);
  uint64_t* empty = full + kWbStages;

  const int row0 = blockIdx.y * kWbBM, col0 = blockIdx.x * BN;
  const int src = col0 >= g.n_switch ? 1 : 0;
  const int wi = col0 / g.w_rows, wrow = col0 % g.w_rows;
  const int tiles = (g.K + kWbBK - 1) / kWbBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWbStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x != 128) return;
    for (int kt = 0; kt < tiles; ++kt) {
      const int s = kt % kWbStages;
      if (kt >= kWbStages)
        mbar_wait(&empty[s], ((kt / kWbStages) + 1) & 1);
      unsigned char* st = ring + s * P::kStage;
      mbar_expect_tx(&full[s], P::kStage);
      tma_load_3d(st, &g.a[src], &full[s], kt * kWbBK, row0, 0);
      tma_load_3d(st + P::kABytes, &g.w[wi], &full[s], kt * kWbBK, wrow, 0);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  float acc[BN / 2];
  for (int kt = 0; kt < tiles; ++kt) {
    const int s = kt % kWbStages;
    mbar_wait(&full[s], (kt / kWbStages) & 1);
    const unsigned char* st = ring + s * P::kStage;
    const uint64_t da = wg_desc(st);
    const uint64_t dw = wg_desc(st + P::kABytes);
    wg_fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWbBK / 16; ++kk)
      wgmma_bf16<BN>(acc, da + 2 * kk, dw + 2 * kk, kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wg_fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // The tile's bf16 values (msg) go through shared memory (the ring is
  // free: every K tile is consumed), rows of BN + 8 bf16 so that a warp's
  // stores fall on 32 banks, and leave in coalesced 16-byte stores, the
  // residual added there from 16-byte loads. Rows r (h = 0) and r + 8 (h =
  // 1) of the tile; columns 8 j + 2 tq, + 1.
  constexpr int kLd = BN + 8;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(ring);
  const int r = 16 * warp + gq;
  float mu[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  if constexpr (EPI == kWbEpiLnMsg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        sum += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      mu[h] = sum / BN;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dlt = acc[4 * j + 2 * h + c] - mu[h];
          v += dlt * dlt;
        }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      inv[h] = rsqrtf(v / BN + g.eps);
    }
  }
  // column pair by column pair, both rows: one pair of gamma, beta live
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * tq, col = col0 + cl;
    float2 gm = make_float2(1.f, 1.f), bt = make_float2(0.f, 0.f);
    if constexpr (EPI == kWbEpiLnMsg) {
      if (col < g.N) {
        gm = *reinterpret_cast<const float2*>(g.gamma + col);
        bt = *reinterpret_cast<const float2*>(g.beta + col);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (EPI == kWbEpiLnMsg) {
        v0 = (v0 - mu[h]) * inv[h] * gm.x + bt.x;
        v1 = (v1 - mu[h]) * inv[h] * gm.y + bt.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(stage + (r + 8 * h) * kLd + cl) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  asm volatile("bar.sync 1, 128;" ::: "memory");  // the consumer warpgroup
  constexpr int kChunks = BN / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < kWbBM * kChunks; i += 128) {
    const int rr = i / kChunks, c8 = (i % kChunks) * 8;
    const int gr = row0 + rr, col = col0 + c8;
    if (gr >= g.M || col >= g.N) continue;
    uint4 v = *reinterpret_cast<const uint4*>(stage + rr * kLd + c8);
    if (EPI == kWbEpiLnMsg && g.res) {  // out = bf16(x + msg), msg bf16
      const uint4 x = *reinterpret_cast<const uint4*>(
          g.res + (long long)gr * g.ldres + col);
      __nv_bfloat162* m2 = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m2[e] = __floats2bfloat162_rn(
            __low2float(x2[e]) + __low2float(m2[e]),
            __high2float(x2[e]) + __high2float(m2[e]));
    }
    *reinterpret_cast<uint4*>(g.out + (long long)gr * g.ldo + col) = v;
  }
}

template <int BN, int EPI>
cudaError_t wb_launch(const WbArgs& g, cudaStream_t stream) {
  using P = WbPlan<BN>;
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg_bf16_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)P::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ceil_div(g.N, BN), ceil_div(g.M, kWbBM));
  wg_bf16_kernel<BN, EPI><<<grid, kWbThreads, P::kBytes, stream>>>(g);
  return cudaGetLastError();
}

// out [M, N] (leading dimension ldo) = bf16(epilogue(A W^T)): A a0 [M, K]
// (leading dimension lda0), and from column n_switch on a1 (lda1; a1 null
// with n_switch >= N); w[i] [w_rows, K] bf16 for columns i w_rows .. (i +
// 1) w_rows (at most three). bn: 128 or 64, dividing w_rows and n_switch;
// kWbEpiLnMsg needs N = bn and gamma, beta, and takes res [M, N] bf16
// (ldres) or null.
template <int EPI>
cudaError_t wg_linear_bf16(const __nv_bfloat16* a0, long long lda0,
                           const __nv_bfloat16* a1, long long lda1,
                           int n_switch, const __nv_bfloat16* const* w,
                           int w_count, int w_rows, int M, int N, int K,
                           int bn, __nv_bfloat16* out, long long ldo,
                           const float* gamma, const float* beta, float eps,
                           const __nv_bfloat16* res, long long ldres,
                           cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if ((bn != 64 && bn != 128) || K < 1 || w_count < 1 || w_count > 3 ||
      w_rows % bn || (n_switch < N && (!a1 || n_switch % bn)) ||
      N > w_count * w_rows || N % 8 || ldo % 8 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      (EPI == kWbEpiLnMsg &&
       (N != bn || !gamma || !beta ||
        reinterpret_cast<uintptr_t>(gamma) % 8 ||
        reinterpret_cast<uintptr_t>(beta) % 8 ||
        (res && (ldres % 8 || reinterpret_cast<uintptr_t>(res) % 16)))))
    return cudaErrorInvalidValue;
  WbArgs g;
  cudaError_t err;
  if ((err = wg_map(&g.a[0], a0, true, K, M, 1, lda0, lda0, kWbBK,
                    kWbBM)) != cudaSuccess)
    return err;
  if (n_switch < N) {
    if ((err = wg_map(&g.a[1], a1, true, K, M, 1, lda1, lda1, kWbBK,
                      kWbBM)) != cudaSuccess)
      return err;
  } else {
    g.a[1] = g.a[0];
  }
  for (int i = 0; i < 3; ++i) {
    if (i < w_count) {
      if ((err = wg_map(&g.w[i], w[i], true, K, w_rows, 1, K, K, kWbBK,
                        bn)) != cudaSuccess)
        return err;
    } else {
      g.w[i] = g.w[0];
    }
  }
  g.M = M;
  g.N = N;
  g.K = K;
  g.n_switch = n_switch < N ? n_switch : N;
  g.w_rows = w_rows;
  g.out = out;
  g.ldo = ldo;
  g.gamma = gamma;
  g.beta = beta;
  g.eps = eps;
  g.res = res;
  g.ldres = ldres;
  return bn == 128 ? wb_launch<128, EPI>(g, stream)
                   : wb_launch<64, EPI>(g, stream);
}

}  // namespace
}  // namespace emip
