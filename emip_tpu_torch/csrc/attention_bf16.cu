// The bf16 forward attention of kernels B, C and G (declared in
// attention_bf16.cuh) on Hopper's warpgroup tensor cores, fed by TMA.
// A's fused bf16 forward (sr_attention.cu) keeps its own key loop, AbKeys
// of attention_bf16.cuh.
//
// Replaces, in the bf16 band, the attention inside
// emip_tpu/ops/pallas/corr_softmax.py:_flow_attention_kernel (C, through
// _flow_attention_fwd_impl) and window_attention.py:_kernel /
// _kernel_rows (G, through _forward_pallas and _forward_pallas_rows) and
// _block_self_forward (B's self layer). The JAX kernels take bf16 q and k,
// accumulate q k^T in fp32 and run the softmax in fp32; G and B round the
// normalised P to bf16 for P v (fp32 accumulation) and round o to bf16; C
// keeps P in fp32 and upcasts its 2-wide v. Here the softmax is online: P
// = e^(s - m_running), unnormalised, is rounded to bf16 for the tensor-core
// P v and the fp32 sum is divided out at the end (o = bf16(O / l)), the
// same function within the bf16 band; C's 2-wide P v stays in fp32 on the
// CUDA cores. e^x is taken as 2^(x log2 e), the scale folded into the
// scores.
//
// What bounds it on the card:
//   - the products: q k^T, and with DV = D P v, 2 Nq Nk D operations each
//     per batch row at the bf16 tensor-core rate (989 TFLOP/s): 0.0155 ms
//     for C's [16, 1936, 128], 0.0178 ms for G's [32, 1024, 128];
//   - the exponentials on the MUFU (16 a clock an SM): Nq Nk per batch
//     row, C's 60 M take about as long as its q k^T;
//   - the bytes: q, k, v and out once, and the shift mask of B and G
//     (fp32 [K^2, T, T]) once per batch row that reads it, 134 MB from L2
//     at [32, 1024, 1024]; the [Nq, Nk] scores never reach memory.
// What the design does about each. A block owns 128 query rows of one batch
// row: two consumer warpgroups of 64 rows and a producer warpgroup, whose
// registers setmaxnreg hands to the consumers (40 and 232 a thread). One
// producer thread loads the block's q tile once by TMA, then keeps a ring of
// six stages of key tiles of 64 full (k, v and the mask's [128, 64] tile; three
// stages with the mask at D = 128; C: five of 128 keys, no O to hold beside
// their scores), each a TMA box in the 128-byte swizzle, one mbarrier per stage
// for the bytes and one for the consumers' release; C's 2-wide fp32 v tile (1
// KiB) is copied into its stage by the producer warpgroup's 128 threads, one
// key each, so Nk has no bound. Boxes reach past the batch row's tokens as
// zeros, so a ragged last query or key tile needs no copy; keys past Nk are set
// to -inf and C's v there to 0. A consumer warpgroup runs S = q k^T on
// wgmma.m64n64k16 with both operands from shared memory, K-major as they lie,
// then the online softmax on the accumulators in registers (a row lives in the
// four lanes of a quad). The next tile's q k^T is issued before this tile's
// softmax, so the MUFU and the FMA pipes run while the tensor core does. With
// DV = D, P is packed to bf16 straight from the accumulators as wgmma's A
// operand from registers, and v, [keys, D] as it lies, is its MN-major B
// operand (imm-trans-b), one m64n64k16 per 64 columns of D, so no transpose is
// staged. With DV = 2 the warpgroup sums P v in fp32 from v's tile. The mask
// tile is read from shared memory, one float2 a score pair, the swizzle keeping
// the eight rows of a read on different banks; a tile that the caller's table
// marks all zero (the shift mask: 37.5% of them at T = 1024, 33.6% at 484) is
// neither loaded nor added, which gives the same bits; without a mask the scale
// is folded into the exponent's FMA. 256 blocks at every shape of the model
// ([16, 1936], [8, 4096], [32, 1024], [64, 484]), one an SM: 1.94 waves. Each
// of a batch row's query blocks reads its k and v tiles (and mask tiles) from
// L2 again: 134 MB at [32, 1024, 128], 268 MB with the mask. Sharing k and v
// between the two blocks of a cluster by TMA multicast halves those reads, and
// was slower on an H100: the blocks then release each stage in lockstep. No
// atomics: a second call gives the same bits.

#include "attention_bf16.cuh"
#include "gemm_wgmma.cuh"

namespace emip {
namespace {

constexpr int kFaWg = 2;                       // consumer warpgroups
constexpr int kFaRows = 64 * kFaWg;            // query rows of a block
constexpr int kFaThreads = 128 * kFaWg + 128;  // and a producer warpgroup
constexpr int kFaSmem = 232448;                // a block's shared memory

template <int D, int DV, bool MASKED>
struct FaPlan {
  static_assert(D % 64 == 0 && (DV == 2 || DV == D), "widths");
  static_assert(DV == D || !MASKED, "C takes no mask");
  static constexpr bool kWide = DV != 2;
  static constexpr int kChunks = D / 64;  // 128-byte column chunks of a row
  // keys of a tile: 64 with DV = D (the scores, P and O in registers), 128
  // for C (no O to hold: fewer, longer softmax steps)
  static constexpr int kKt = kWide ? 64 : 128;
  static_assert(kWide || kKt == 128, "C's v: one key a producer thread");
  static constexpr int kQBytes = kFaRows * D * 2;
  static constexpr int kKBytes = kKt * D * 2;
  // v's tile: bf16 [keys, DV] by TMA, or C's fp32 [keys, 2] copied by the
  // producer warpgroup
  static constexpr int kVBytes = kWide ? kKt * DV * 2 : kKt * 8;
  static constexpr int kMBytes = MASKED ? kFaRows * kKt * 4 : 0;
  // a stage: k, then v, then the mask; each box 1024-byte aligned
  static constexpr int kStageBytes =
      (kKBytes + kVBytes + kMBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kTx = kKBytes + (kWide ? kVBytes : 0) + kMBytes;
  static constexpr int kFit = (kFaSmem - 1024 - 128 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  // a tile's q k^T is issued while the tile two before it still holds
  // its stage (released once its P v is done)
  static_assert(kStages >= 3, "three stages at least");
  // then the barriers
  static constexpr size_t kBytes = 1024 + kQBytes +
                                   (size_t)kStages * kStageBytes +
                                   (2 * kStages + 1) * 8;
};

struct FaArgs {
  CUtensorMap q, k, v, mask;  // v with DV = D, mask where masked
  const float* vf;            // DV = 2: v [B, Nk, 2] fp32
  long long v_sb;
  int v_sn;
  void* out;
  long long o_sb;
  int o_sn;
  int Nq, Nk, mask_nw;
  float scale;  // log2(e) / sqrt(D)
  // masked: 1 where the mask's tile of a block by a key tile is all zero
  // ([mask_nw, query blocks, key tiles]), or null
  const unsigned char* zero_tiles;
};

// Grid (query tiles of 128, B). Batch row b's row n of q and k lies at
// p[b sb + n sn], of v and out at the same with their strides; the mask of
// batch row b is mask[b % mask_nw].
template <int D, int DV, bool MASKED>
__global__ void __launch_bounds__(kFaThreads, 1)
attention_wgmma_kernel(const __grid_constant__ FaArgs a) {
  using P = FaPlan<D, DV, MASKED>;
  extern __shared__ unsigned char fa_smem_raw[];
  const uint32_t raw = smem_u32(fa_smem_raw);
  unsigned char* Qs = fa_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* ring = Qs + P::kQBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + P::kStages * P::kStageBytes);
  uint64_t* empty = full + P::kStages;
  uint64_t* qbar = empty + P::kStages;

  const int b = blockIdx.y, q0 = blockIdx.x * kFaRows;
  const int tiles = (a.Nk + P::kKt - 1) / P::kKt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      // the TMA bytes, and with DV = 2 the producer threads' copies of v
      mbar_init(&full[s], P::kWide ? 1 : 128);
      mbar_init(&empty[s], 4 * kFaWg);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);  // q's bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kFaWg) {
    // the producer warpgroup: its registers go to the consumers, and one
    // thread issues the copies (with DV = 2 all 128 copy v's tile, one key
    // each, beside them)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pt = threadIdx.x - 128 * kFaWg;
    if (P::kWide && pt != 0) return;
    if (pt == 0) {
      mbar_expect_tx(qbar, P::kQBytes);
      for (int c = 0; c < P::kChunks; ++c)
        tma_load_3d(Qs + c * (kFaRows * 128), &a.q, qbar, 64 * c, q0, b);
    }
    const int mw = MASKED ? b % a.mask_nw : 0;
    const unsigned char* zt =
        MASKED && a.zero_tiles
            ? a.zero_tiles + ((long long)mw * gridDim.x + blockIdx.x) * tiles
            : nullptr;
    for (int kt = 0; kt < tiles; ++kt) {
      const int s = kt % P::kStages, k0 = kt * P::kKt;
      if (kt >= P::kStages)
        mbar_wait(&empty[s], ((kt / P::kStages) + 1) & 1);
      unsigned char* st = ring + s * P::kStageBytes;
      if constexpr (!P::kWide) {
        // C's v, zeros past Nk; each thread's arrival releases its copy
        const int key = k0 + pt;
        reinterpret_cast<float2*>(st + P::kKBytes)[pt] =
            key < a.Nk ? *reinterpret_cast<const float2*>(
                             a.vf + b * a.v_sb + (long long)key * a.v_sn)
                       : make_float2(0.f, 0.f);
        if (pt != 0) {
          mbar_arrive(&full[s]);
          continue;
        }
      }
      // an all-zero mask tile is not loaded (its consumers skip the add)
      const bool mask_tile = MASKED && !(zt && zt[kt]);
      mbar_expect_tx(&full[s], mask_tile ? P::kTx : P::kTx - P::kMBytes);
      for (int c = 0; c < P::kChunks; ++c)
        tma_load_3d(st + c * (P::kKt * 128), &a.k, &full[s], 64 * c, k0, b);
      if constexpr (P::kWide)
        for (int c = 0; c < DV / 64; ++c)
          tma_load_3d(st + P::kKBytes + c * (P::kKt * 128), &a.v, &full[s],
                      64 * c, k0, b);
      if (mask_tile)
        for (int h = 0; h < P::kKt / 32; ++h)
          tma_load_3d(st + P::kKBytes + P::kVBytes + h * (kFaRows * 128),
                      &a.mask, &full[s], k0 + 32 * h, q0, mw);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int rl = 64 * wg + 16 * warp + g;  // this thread's first row, + 8
  const unsigned char* q_wg = Qs + wg * (64 * 128);
  const unsigned char* zt =
      MASKED && a.zero_tiles
          ? a.zero_tiles +
                ((long long)(b % a.mask_nw) * gridDim.x + blockIdx.x) * tiles
          : nullptr;

  // the running max (the same in the four lanes of a row, log2 units) and
  // this lane's part of the running sum, of rows rl and rl + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // accumulator i of a 64-column product holds row rl + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 t + i % 2: sn the scores q k^T lands in, cur the
  // tile's scores, then its P, in the softmax
  constexpr int kS = P::kKt / 2;  // score accumulators of a thread
  float sn[kS], cur[kS];
  float o[P::kWide ? DV / 64 : 1][32];  // DV = D: O, 64 columns an array
  float oc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // DV = 2: this lane's part
  uint32_t pa[P::kKt / 16][4];                 // P in bf16, wgmma's A
  if constexpr (P::kWide) {
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  }

  // S = q k^T of tile kt into sc, one wgmma group
  auto issue_s = [&](float (&sc)[kS], int kt) {
    const int s = kt % P::kStages;
    mbar_wait(&full[s], (kt / P::kStages) & 1);
    const unsigned char* kst = ring + s * P::kStageBytes;
    wg_fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16<P::kKt>(
          sc, wg_desc(q_wg + (kk / 4) * (kFaRows * 128) + (kk % 4) * 32),
          wg_desc(kst + (kk / 4) * (P::kKt * 128) + (kk % 4) * 32), kk > 0);
    wgmma_commit();
  };

  // the scores of tile kt in sc replaced by P = 2^(x - m_new) in fp32, x =
  // s log2(e) / sqrt(D) (+ mask log2(e)); m and l moved on, alpha = 2^(m_old
  // - m_new). Without a mask the tile's max is taken on the raw scores
  // (the scale is positive) and the scale folded into the exponent's FMA.
  auto softmax = [&](float (&sc)[kS], int kt, float (&alpha)[2]) {
    const int k0 = kt * P::kKt;
    const unsigned char* mt = ring + (kt % P::kStages) * P::kStageBytes +
                              P::kKBytes + P::kVBytes;
    const bool ragged = k0 + P::kKt > a.Nk;
    const bool mask_tile = MASKED && !(zt && zt[kt]);  // else all zero
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < P::kKt / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x0 = sc[4 * j + 2 * hf], x1 = sc[4 * j + 2 * hf + 1];
        if constexpr (MASKED) {
          // element (r, key) of the mask tile: boxes of 32 keys, rows of
          // 128 bytes, 16-byte chunk key / 4 at (key / 4) ^ (r % 8)
          const int r = rl + 8 * hf, key = 8 * j + 2 * t;
          const float2 mk =
              mask_tile ? *reinterpret_cast<const float2*>(
                              mt + (key / 32) * (kFaRows * 128) + r * 128 +
                              ((((key % 32) / 4) ^ (r % 8)) * 16) +
                              (key % 4) * 4)
                        : make_float2(0.f, 0.f);
          x0 = fmaf(mk.x, kLog2e, x0 * a.scale);
          x1 = fmaf(mk.y, kLog2e, x1 * a.scale);
        }
        if (ragged) {
          const int col = k0 + 8 * j + 2 * t;
          if (col >= a.Nk) x0 = -INFINITY;
          if (col + 1 >= a.Nk) x1 = -INFINITY;
        }
        sc[4 * j + 2 * hf] = x0;
        sc[4 * j + 2 * hf + 1] = x1;
        mx[hf] = fmaxf(mx[hf], fmaxf(x0, x1));
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float mnew = fmaxf(m[hf], MASKED ? mx[hf] : mx[hf] * a.scale);
      alpha[hf] = fast_exp2(m[hf] - mnew);  // 0 on the first tile
      m[hf] = mnew;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int hf = (i / 2) % 2;
      const float p = fast_exp2(MASKED ? sc[i] - m[hf]
                                       : fmaf(sc[i], a.scale, -m[hf]));
      sc[i] = p;
      l[hf] += p;
    }
  };

  // One tile, kt: with `next` the next tile's q k^T is issued first, so
  // that it runs during this tile's softmax, then O = alpha O (+)= P v.
  // Every wgmma issue and wait is on the straight path of the loop body
  // (the last tile is a body of its own), so the compiler can follow the
  // groups in flight and keeps them asynchronous: at a body's start P v of
  // the tile before may be in flight, at its end P v of this one.
  auto step = [&](auto next, int kt) {
    constexpr bool kNext = decltype(next)::value;
    if constexpr (kNext) issue_s(sn, kt + 1);
    float alpha[2];
    softmax(cur, kt, alpha);
    if constexpr (P::kWide) {
      // P v of the tile before has read its v and pa, and written o
      wgmma_wait<kNext ? 1 : 0>();
#pragma unroll
      for (int c = 0; c < DV / 64; ++c) wg_fence_regs(o[c]);
#pragma unroll
      for (int kk = 0; kk < P::kKt / 16; ++kk) wg_fence_regs(pa[kk]);
      __syncwarp();
      if (kt > 0 && lane == 0)
        mbar_arrive(&empty[(kt - 1) % P::kStages]);
#pragma unroll
      for (int c = 0; c < DV / 64; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i / 2) % 2];
#pragma unroll
      for (int kk = 0; kk < P::kKt / 16; ++kk) {
        pa[kk][0] = pack_bf16(cur[8 * kk], cur[8 * kk + 1]);
        pa[kk][1] = pack_bf16(cur[8 * kk + 2], cur[8 * kk + 3]);
        pa[kk][2] = pack_bf16(cur[8 * kk + 4], cur[8 * kk + 5]);
        pa[kk][3] = pack_bf16(cur[8 * kk + 6], cur[8 * kk + 7]);
      }
      const unsigned char* vst =
          ring + (kt % P::kStages) * P::kStageBytes + P::kKBytes;
#pragma unroll
      for (int c = 0; c < DV / 64; ++c) wg_fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::kKt / 16; ++kk)
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          wgmma_bf16_rt(o[c], pa[kk],
                        wg_desc_mn(vst + c * (P::kKt * 128) + kk * 2048));
      wgmma_commit();
      // the next tile's scores have landed; this P v stays in flight
      wgmma_wait<kNext ? 1 : 0>();
    } else {
      const float2* vt = reinterpret_cast<const float2*>(
          ring + (kt % P::kStages) * P::kStageBytes + P::kKBytes);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        oc[hf][0] *= alpha[hf];
        oc[hf][1] *= alpha[hf];
      }
#pragma unroll
      for (int j = 0; j < P::kKt / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float2 v = vt[8 * j + 2 * t + c];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float p = cur[4 * j + 2 * hf + c];
            oc[hf][0] = fmaf(p, v.x, oc[hf][0]);
            oc[hf][1] = fmaf(p, v.y, oc[hf][1]);
          }
        }
      // this tile's k is read (its q k^T is done)
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[kt % P::kStages]);
      wgmma_wait<0>();
    }
    if constexpr (kNext) {
      wg_fence_regs(sn);
#pragma unroll
      for (int i = 0; i < kS; ++i) cur[i] = sn[i];
    }
  };

  mbar_wait(qbar, 0);
  issue_s(sn, 0);
  wgmma_wait<0>();
  wg_fence_regs(sn);
#pragma unroll
  for (int i = 0; i < kS; ++i) cur[i] = sn[i];
  for (int kt = 0; kt + 1 < tiles; ++kt)
    step(std::true_type{}, kt);
  step(std::false_type{}, tiles - 1);
  if constexpr (P::kWide) {
#pragma unroll
    for (int c = 0; c < DV / 64; ++c) wg_fence_regs(o[c]);
  }

  // the four lanes of a row hold parts of its sum (and, with DV = 2, of
  // its two outputs)
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[hf] = 1.0f / sum;
    if constexpr (!P::kWide) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = oc[hf][c];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int n = q0 + rl + 8 * hf;
    if (n >= a.Nq) continue;
    if constexpr (P::kWide) {
      bf16* dst = static_cast<bf16*>(a.out) + b * a.o_sb +
                  (long long)n * a.o_sn;
#pragma unroll
      for (int c = 0; c < DV / 64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * c + 8 * j + 2 * t) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * hf] * inv[hf],
                                    o[c][4 * j + 2 * hf + 1] * inv[hf]);
    } else if (t == 0) {
      float* dst = static_cast<float*>(a.out) + b * a.o_sb +
                   (long long)n * a.o_sn;
      *reinterpret_cast<float2*>(dst) =
          make_float2(oc[hf][0] * inv[hf], oc[hf][1] * inv[hf]);
    }
  }
}

template <int D, int DV, bool MASKED>
cudaError_t attention_wgmma_launch(const FaArgs& a, int B,
                                   cudaStream_t stream) {
  using P = FaPlan<D, DV, MASKED>;
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_wgmma_kernel<D, DV, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kFaSmem);
  if (attr != cudaSuccess) return attr;
  static_assert(P::kBytes <= kFaSmem, "shared memory");
  const dim3 grid(ceil_div(a.Nq, kFaRows), B);
  attention_wgmma_kernel<D, DV, MASKED>
      <<<grid, kFaThreads, P::kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace emip

extern "C" int emip_attention_fwd_bf16(const void* q, long long q_sb,
                                       int q_sn, const void* k,
                                       long long k_sb, int k_sn,
                                       const void* v, long long v_sb,
                                       int v_sn, const float* mask,
                                       int mask_sn, int mask_nw,
                                       const void* zero_tiles,
                                       void* out, long long o_sb, int o_sn,
                                       int B, int Nq, int Nk, int D, int DV,
                                       int windows, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Nq <= 0 || Nk <= 0 || B <= 0 || B > 65535 || (D != 128 && D != 64) ||
      (mask && (!windows || mask_sn < Nk || mask_sn % 4)))
    return (int)cudaErrorInvalidValue;
  FaArgs a;
  cudaError_t err;
  if ((err = wg_map(&a.q, q, true, D, Nq, B, q_sn, q_sb, 64,
                         kFaRows)) != cudaSuccess ||
      (err = wg_map(&a.k, k, true, D, Nk, B, k_sn, k_sb, 64,
                         DV == 2 ? 128 : 64)) != cudaSuccess)
    return (int)err;
  a.vf = static_cast<const float*>(v);
  a.v_sb = v_sb;
  a.v_sn = v_sn;
  a.out = out;
  a.o_sb = o_sb;
  a.o_sn = o_sn;
  a.Nq = Nq;
  a.Nk = Nk;
  a.mask_nw = mask_nw > 0 ? mask_nw : 1;
  a.scale = kLog2e / sqrtf((float)D);
  a.zero_tiles =
      mask ? static_cast<const unsigned char*>(zero_tiles) : nullptr;
  a.v = a.k;
  a.mask = a.k;
  if (DV == 2) {  // kernel C: fp32 v and out
    if (windows || mask || v_sn % 2 || v_sb % 2 ||
        reinterpret_cast<uintptr_t>(v) % 8)
      return (int)cudaErrorInvalidValue;
    err = D == 128 ? attention_wgmma_launch<128, 2, false>(a, B, s)
                   : attention_wgmma_launch<64, 2, false>(a, B, s);
  } else {
    if (DV != D || !windows || Nq != Nk)  // the windows of B and G
      return (int)cudaErrorInvalidValue;
    if ((err = wg_map(&a.v, v, true, DV, Nk, B, v_sn, v_sb, 64, 64)) !=
        cudaSuccess)
      return (int)err;
    if (mask &&
        (err = wg_map(&a.mask, mask, false, Nk, Nq, a.mask_nw, mask_sn,
                           (long long)Nq * mask_sn, 32, kFaRows)) !=
            cudaSuccess)
      return (int)err;
    if (D == 128)
      err = mask ? attention_wgmma_launch<128, 128, true>(a, B, s)
                 : attention_wgmma_launch<128, 128, false>(a, B, s);
    else
      err = mask ? attention_wgmma_launch<64, 64, true>(a, B, s)
                 : attention_wgmma_launch<64, 64, false>(a, B, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
