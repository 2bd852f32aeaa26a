// Kernel F: the long-term memory read, forward and backward.
//
//   out = softmax(q k^T / sqrt(C) + bias, over the N keys) v
//
// Replaces emip_tpu/ops/pallas/memory_attention.py:masked_memory_attention
// (_fwd_kernel, _bwd_kernel). q [B, M, C] is the query frame's key map,
// k and v [B, N, C] the ring of memory keys and values flattened slot-major
// (N = slots * M), bias [B, N] is 0 on the keys of a written slot and -1e9
// on those of an empty one; out [B, M, C]. C is GMFlow's feature width, at
// which EMIPLong builds its memory: 128 (pvt_v2_b5's configuration) or 64
// (b0's). At 352^2 inputs M = 1936 and N = 9680, at 512^2 M = 4096 and
// N = 20480.
//
// Forward. What bounds it on the card: the two products, 4 * M * N * C
// operations per batch row (9.6 GFLOP at 352^2); the operands are ~12 MB.
// The TPU kernel keeps all N keys and a [tile, N] block of scores in VMEM;
// here neither fits in shared memory. The first version ran both products
// on the CUDA cores out of 64 x 64 tiles with 4 x 4 register patches,
// transposed k and q into shared memory by scalar loads with no overlap of
// loads and arithmetic, and sent P through shared memory (three barriers per
// tile): 4.7x its fp32 bound, 1.34x the library's fused attention. This one
// (attention_fwd_tc of mma_tf32.cuh) runs both on the tensor cores as
// 3xTF32: 8 warps of two 16-row fragments own 256 query rows, kept in shared
// memory (132 KiB), so that each streamed fragment is loaded and split once
// for two mma; the keys and values stream in tiles of 32 through two
// cp.async stages (66 KiB), one block on an SM. The online max and sum run
// on the score fragments in registers, P stays there as the A operand of
// P v, and the bias (0 or -1e9 per key) is staged beside each tile and added
// before the running max. Keys past N are masked to -inf. With few query
// tiles (1 clip: 8 blocks; 4 clips: 32; 512^2: 16) the keys are split across
// blocks so that the last wave is full, and an ordered pass merges the
// partial outputs by their max and sum. All-masked tiles are
// not skipped: with every slot empty all scores are equal and the result is
// the plain mean of the values, as on the TPU.
//
// Backward. What bounds it: five M x N x C products per batch row when all
// three grads are asked for (the scores, dO v^T, dS k, dS^T q, P^T dO),
// 24 GFLOP at 352^2; at the fp32 rate of the CUDA cores that is the bound
// the records state. The first version ran them there out of 64 x 64 tiles
// with 4 x 4 register patches, a shared load for every two to three
// multiply-adds and no overlap of loads with arithmetic. This one
// (attention_bwd_tc of mma_tf32.cuh) runs all five on the tensor cores as
// 3xTF32 (fp32-grade: the long train step's grad check leaves no room for a
// single TF32 product): 8 warps own 128 rows of one side, kept in shared
// memory with their dO or v rows (132 KiB), and stream the other side in
// tiles of 32 rows through two cp.async stages (66 KiB), one block on an
// SM. The TPU kernel accumulates dk and dv over a sequential grid of query
// tiles. Blocks run in no order here, so a query-tiled pass writes dq (keys
// split across blocks when there are few query tiles, partials summed in
// order) and a key-tiled pass streams the queries and writes dk and dv; both
// recompute P = exp(S - m) / l from the row max m and sum l the forward kept
// (kept apart, not as m + log l: with every slot empty m is -1e9, where
// fp32 has no room for log l), so the scores and dO v^T are computed twice.
// dq alone runs the first pass only. No atomics: every run gives the same
// bits.
//
// The bf16 band (the long model in bf16): q bf16, the ring's k and v and
// the bias fp32, out fp32, as the JAX kernel takes them in a bf16 model
// (its ring stays fp32). The JAX forward accumulates q k^T in fp32,
// rounds P = exp(S - m_rowmax) to bf16 for P v against the fp32 v (fp32
// sums) and divides by the fp32 sum of the unrounded P. The forward here
// runs on Hopper's warpgroup tensor cores in bf16 (the design of
// attention_bf16.cu, which B, C and G share). What bounds it: the two
// products, whose fp32 side (the ring) a bf16 product cannot take as it is.
// Each fp32 value x of k and v is split into three bf16 parts, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to
// nearest; their sum is x exactly (24 = 3 x 8 bits of significand) for |x|
// >= 2^-110, where lo stays a normal bf16 value (below, lo drops bits under
// 2^-133), and q
// and the bf16 P are bf16, so q k^T = sum_i q k_i^T and P v = sum_i P v_i
// are the same function as q k^T and P v against the fp32 ring, every
// partial product exact and summed in fp32, only in another order: three
// bf16 products at 989 TFLOP/s, 0.75x the time of the two TF32 products
// (495) that the fp32 ring with a bf16 q or P needs. A first launch writes
// the parts of k and v once a call ([B, 3, N, C] bf16 each, 1.5x the ring's
// bytes, in workspace; at about the memory's rate). Splitting fp32 tiles in
// each block instead (the producer warpgroup loading, splitting and storing
// them in the swizzled layout) repeats the split for every query block of a
// batch row; it ran slower on an H100 (its producer spilled at C = 128),
// with the same bits. Then a block owns 128 query rows of one batch row:
// two consumer warpgroups of 64 rows and a producer warpgroup, whose
// registers setmaxnreg hands to the consumers (40 and 232 a thread). One
// producer thread loads the block's q tile once by TMA and keeps a ring of
// stages full (key tiles of 32: the three parts of k and of v, 48 KiB at C
// = 128, take four stages beside the 32 KiB q tile), each part a TMA box in
// the 128-byte swizzle; 32 producer threads copy the tile's bias beside it,
// one key each. A consumer warpgroup reads its q rows once into registers
// (wgmma's A layout; from shared memory, q's 2 KiB a product would make the
// shared reads the limit at 32 keys), runs S = q k^T as wgmma.m64n32k16
// over the parts lo, mid, hi into one fp32 accumulator (the small terms
// first), each part K-major from shared memory as it lies; adds the bias
// (0, or -1e9 on an empty slot) before the running max, so that a ring
// with every slot empty reads the plain mean of the values; sets keys past
// N to -inf; and runs the online softmax on the accumulators in registers
// (a row in the four lanes of a quad), P = e^(x - m_running) rounded to
// bf16 from the accumulators as wgmma's A operand, against v's parts, [keys,
// C] as they lie, MN-major (imm-trans-b), with the rescale of the fp32
// accumulators as the running max grows: the same function within the bf16
// band, the choice attention_bf16.cu makes (the JAX kernel rounds e^(S -
// m_rowmax)). The next tile's q k^T is issued before this tile's softmax.
// With few query tiles (16 blocks at 1 clip, 64 at 4, 32 at 512^2) the keys
// are split across blocks until the last wave is full (8, 2 and 4 splits),
// and the fp32 forward's ordered merge combines the partials by their max
// and sum. The row statistics it keeps for the backward are the row max
// and the sum of the unrounded P (natural units), from that same merge. No
// atomics: a second call gives the same bits. The bf16 backward is the JAX
// kernel's: P recomputed in fp32 from the kept statistics, delta = rowsum(dO
// o out) from the bf16 forward's output, dq rounded to bf16 once; dk and dv
// stay fp32. It is the backward above instantiated for a bf16 q (Q16 of
// attention_bwd_tc), with the fp32 one's tiling, splits and sums: q's rows
// are copied as bf16 where they lie (the query-tiled pass keeps them
// resident, the key-tiled pass streams them through its cp.async stages,
// three now that the q tiles take half the bytes) and widened as the
// fragments are built. q is exact in TF32, so the products it enters, q k^T
// in both passes and dS^T q, take two TF32 products instead of three; the
// term left out adds +0, so the grads have the bits of the fp32 backward on
// the upcast q. dO v^T, dS k and P^T dO keep three (P is recomputed in fp32).
// dq is rounded in the epilogue that finishes it: the unsplit pass's, or the
// ordered sum of the split partials. No upcast scratch and no conversion
// launches.

#include <climits>

#include "gemm_wgmma.cuh"

// the tilings: warps, fragments of 16 resident rows per warp, streamed rows
// per stage
constexpr int kMemFwdWarps = 8;
constexpr int kMemFwdMt = 2;
constexpr int kMemFwdStr = 32;
constexpr int kMemBwdWarps = 8;
constexpr int kMemBwdMt = 1;
constexpr int kMemBwdStr = 32;

namespace emip {
namespace {

// ------------------------------------------------- the bf16 forward

constexpr int kMfWg = 2;                       // consumer warpgroups
constexpr int kMfRows = 64 * kMfWg;            // query rows of a block
constexpr int kMfThreads = 128 * kMfWg + 128;  // and a producer warpgroup
constexpr int kMfKt = 32;                      // keys of a tile
constexpr int kMfSmem = 232448;                // a block's shared memory

// A block's shared memory: its q tile [128, D] bf16, then the ring's
// stages, each k's three parts then v's ([32, D] bf16 each, in boxes of 64
// columns: 128-byte rows in the 128-byte swizzle), then a bias tile [32]
// fp32 per stage, then the barriers.
template <int D>
struct MfPlan {
  static_assert(D == 64 || D == 128, "widths");
  static constexpr int kChunks = D / 64;  // 128-byte column chunks of a row
  static constexpr int kQBytes = kMfRows * D * 2;
  static constexpr int kPartBytes = kMfKt * D * 2;  // a part of a k or v tile
  static constexpr int kKBytes = 3 * kPartBytes;    // k's parts (v's after)
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kBiasBytes = kMfKt * 4;
  static constexpr int kFit =
      (kMfSmem - 1024 - kQBytes - 256) / (kStageBytes + kBiasBytes);
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  // a tile's q k^T is issued while the tile two before it still holds its
  // stage (released once its P v is done)
  static_assert(kStages >= 3, "three stages at least");
  static constexpr size_t kBytes =
      1024 + kQBytes + (size_t)kStages * (kStageBytes + kBiasBytes) +
      (2 * kStages + 1) * 8;
};

struct MfArgs {
  CUtensorMap q;     // [B, M, D] bf16
  CUtensorMap k, v;  // parts [B, 3, N, D] bf16: batch 3 b + part
  const float* bias;
  float* out;  // [B, M, D], written with one split
  float* row_max;
  float* row_sum;  // [B, M] each, or null
  // with splits: part_o [splits, B, M, D], part_stats [2, splits, B, M]
  float* part_o;
  float* part_stats;
  int M, N, tiles_per_split;
  float scale;  // 1 / sqrt(D)
};

// The ring's parts: k and v [B, N, C] fp32 (groups = B N C / 8 runs of
// eight values each) into kp and vp [B, 3, N, C] bf16, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even; x -
// hi and x - hi - mid are exact in fp32, and so is lo in bf16 where it is
// a normal value, so hi + mid + lo = x for |x| >= 2^-110 (3 x 8 bits of
// significand).
__global__ void __launch_bounds__(256)
ring_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  __nv_bfloat16* __restrict__ kp,
                  __nv_bfloat16* __restrict__ vp, long long per_b,
                  long long groups) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * groups) return;
  const bool is_v = idx >= groups;
  const long long e = (is_v ? idx - groups : idx) * 8;
  const float4* src = reinterpret_cast<const float4*>((is_v ? v : k) + e);
  __nv_bfloat16* dst = (is_v ? vp : kp) + (e / per_b) * 3 * per_b + e % per_b;
  const float4 x0 = __ldg(src), x1 = __ldg(src + 1);
  const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  uint32_t hi[4], mid[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    const float r0 = x[2 * i] - hf.x, r1 = x[2 * i + 1] - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m);
    const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    mid[i] = *reinterpret_cast<const uint32_t*>(&m);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + per_b) =
      make_uint4(mid[0], mid[1], mid[2], mid[3]);
  *reinterpret_cast<uint4*>(dst + 2 * per_b) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Grid (query tiles of 128, key splits, B). Split s of batch row b takes the
// key tiles [s * tiles_per_split, ...); with one split a block writes out
// (and the row statistics where they are kept), else its normalised partial
// output and that partial's max and sum, which attention_merge_kernel (the
// fp32 forward's) merges in order.
template <int D>
__global__ void __launch_bounds__(kMfThreads, 1)
memory_attention_bf16_kernel(const __grid_constant__ MfArgs a) {
  using P = MfPlan<D>;
  extern __shared__ unsigned char mf_smem_raw[];
  const uint32_t raw = smem_u32(mf_smem_raw);
  unsigned char* Qs = mf_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* ring = Qs + P::kQBytes;
  float* bias_ring =
      reinterpret_cast<float*>(ring + P::kStages * P::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_ring + P::kStages * kMfKt);
  uint64_t* empty = full + P::kStages;
  uint64_t* qbar = empty + P::kStages;

  const int b = blockIdx.z, q0 = blockIdx.x * kMfRows;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tiles = (a.N + kMfKt - 1) / kMfKt;
  const int t_beg = split * a.tiles_per_split;
  // at least one tile: the splits are evened out so that none is empty
  const int count = min(tiles, t_beg + a.tiles_per_split) - t_beg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      // the TMA bytes with thread 0's arrival, and the other bias copies
      mbar_init(&full[s], kMfKt);
      mbar_init(&empty[s], 4 * kMfWg);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);  // q's bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kMfWg) {
    // the producer warpgroup: its registers go to the consumers; one
    // thread issues the copies, 32 copy the tile's bias, one key each
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pt = threadIdx.x - 128 * kMfWg;
    if (pt >= kMfKt) return;
    if (pt == 0) {
      mbar_expect_tx(qbar, P::kQBytes);
      for (int c = 0; c < P::kChunks; ++c)
        tma_load_3d(Qs + c * (kMfRows * 128), &a.q, qbar, 64 * c, q0, b);
    }
    const float* bias = a.bias + (long long)b * a.N;
    for (int i = 0; i < count; ++i) {
      const int s = i % P::kStages, k0 = (t_beg + i) * kMfKt;
      if (i >= P::kStages) mbar_wait(&empty[s], ((i / P::kStages) + 1) & 1);
      const int key = k0 + pt;
      bias_ring[s * kMfKt + pt] = key < a.N ? bias[key] : 0.f;
      if (pt != 0) {
        mbar_arrive(&full[s]);
        continue;
      }
      mbar_expect_tx(&full[s], P::kStageBytes);
      unsigned char* st = ring + s * P::kStageBytes;
      for (int p = 0; p < 3; ++p)
        for (int c = 0; c < P::kChunks; ++c) {
          const int off = p * P::kPartBytes + c * (kMfKt * 128);
          tma_load_3d(st + off, &a.k, &full[s], 64 * c, k0, 3 * b + p);
          tma_load_3d(st + P::kKBytes + off, &a.v, &full[s], 64 * c, k0,
                      3 * b + p);
        }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int rl = 64 * wg + 16 * warp + g;  // this thread's first row, + 8

  // the running max (natural units, the same in the four lanes of a row)
  // and this lane's part of the running sum, of rows rl and rl + 8;
  // accumulator i of a product holds row rl + 8 ((i / 2) % 2), column 8 (i
  // / 4) + 2 t + i % 2: sn the scores q k^T lands in, cur the tile's
  // scores, then its P, in the softmax; O 64 columns an array
  constexpr int kS = kMfKt / 2;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sn[kS], cur[kS], o[P::kChunks][32];
  uint32_t pa[kMfKt / 16][4];  // P in bf16, wgmma's A
  // q in wgmma's A layout, a k-step of 16 channels an array: rows rl and rl
  // + 8, channels 2 t, 2 t + 1 and those + 8 (read once: from registers,
  // q k^T reads only k's parts from shared memory, which q's tile from
  // there would make the limit at 32 keys)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int c = 0; c < P::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  // S = q k^T of tile i of the split into sc, one wgmma group: the parts lo,
  // mid, hi in turn (the small terms first) into one fp32 accumulator
  auto issue_s = [&](float (&sc)[kS], int i) {
    const int s = i % P::kStages;
    mbar_wait(&full[s], (i / P::kStages) & 1);
    const unsigned char* kst = ring + s * P::kStageBytes;
    wg_fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int p = 2; p >= 0; --p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ra32(sc, qa[kk],
                        wg_desc(kst + p * P::kPartBytes +
                                (kk / 4) * (kMfKt * 128) + (kk % 4) * 32),
                        p < 2 || kk > 0);
    wgmma_commit();
  };

  // the scores of tile i in sc replaced by P = e^(x - m_new) in fp32, x = s
  // / sqrt(D) + bias (keys past N at -inf), the bias added before the max;
  // m and l moved on, alpha = e^(m_old - m_new). e^y is 2^(y log2 e), y
  // taken first, so that equal scores (every slot empty: all -1e9) give 1.
  auto softmax = [&](float (&sc)[kS], int i, float (&alpha)[2]) {
    const int k0 = (t_beg + i) * kMfKt;
    const float* bs = bias_ring + (i % P::kStages) * kMfKt;
    const bool ragged = k0 + kMfKt > a.N;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kMfKt / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x0 = fmaf(sc[4 * j + 2 * hf], a.scale, bj.x);
        float x1 = fmaf(sc[4 * j + 2 * hf + 1], a.scale, bj.y);
        if (ragged) {
          const int col = k0 + 8 * j + 2 * t;
          if (col >= a.N) x0 = -INFINITY;
          if (col + 1 >= a.N) x1 = -INFINITY;
        }
        sc[4 * j + 2 * hf] = x0;
        sc[4 * j + 2 * hf + 1] = x1;
        mx[hf] = fmaxf(mx[hf], fmaxf(x0, x1));
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float mnew = fmaxf(m[hf], mx[hf]);
      alpha[hf] = fast_exp2((m[hf] - mnew) * kLog2e);  // 0 on the first tile
      m[hf] = mnew;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int hf = (i / 2) % 2;
      const float p = fast_exp2((sc[i] - m[hf]) * kLog2e);
      sc[i] = p;
      l[hf] += p;
    }
  };

  // One tile, i: with `next` the next tile's q k^T is issued first, so that
  // it runs during this tile's softmax, then O = alpha O + P v, P rounded
  // to bf16 (wgmma's A from registers) against v's parts lo, mid, hi in
  // turn (MN-major B, imm-trans-b). Every wgmma issue and wait is on the
  // straight path of the loop body (the last tile is a body of its own):
  // at a body's start P v of the tile before may be in flight, at its end
  // P v of this one.
  auto step = [&](auto next, int i) {
    constexpr bool kNext = decltype(next)::value;
    if constexpr (kNext) issue_s(sn, i + 1);
    float alpha[2];
    softmax(cur, i, alpha);
    // P v of the tile before has read its v and pa, and written o
    wgmma_wait<kNext ? 1 : 0>();
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c) wg_fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < kMfKt / 16; ++kk) wg_fence_regs(pa[kk]);
    __syncwarp();
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % P::kStages]);
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < kMfKt / 16; ++kk) {
      pa[kk][0] = pack_bf16(cur[8 * kk], cur[8 * kk + 1]);
      pa[kk][1] = pack_bf16(cur[8 * kk + 2], cur[8 * kk + 3]);
      pa[kk][2] = pack_bf16(cur[8 * kk + 4], cur[8 * kk + 5]);
      pa[kk][3] = pack_bf16(cur[8 * kk + 6], cur[8 * kk + 7]);
    }
    const unsigned char* vst =
        ring + (i % P::kStages) * P::kStageBytes + P::kKBytes;
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c) wg_fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int p = 2; p >= 0; --p)
#pragma unroll
      for (int kk = 0; kk < kMfKt / 16; ++kk)
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          wgmma_bf16_rt(o[c], pa[kk],
                        wg_desc_mn(vst + p * P::kPartBytes +
                                   c * (kMfKt * 128) + kk * 2048));
    wgmma_commit();
    // the next tile's scores have landed; this P v stays in flight
    wgmma_wait<kNext ? 1 : 0>();
    if constexpr (kNext) {
      wg_fence_regs(sn);
#pragma unroll
      for (int e = 0; e < kS; ++e) cur[e] = sn[e];
    }
  };

  mbar_wait(qbar, 0);
  // element (r, ch) of q's tile: box ch / 64, 128-byte row r, its 16-byte
  // chunk (ch % 64) / 8 at ((ch % 64) / 8) ^ (r % 8) (the 128-byte swizzle)
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rl + 8 * (e % 2), chunk = 2 * (kk % 4) + e / 2;
      qa[kk][e] = *reinterpret_cast<const uint32_t*>(
          Qs + (kk / 4) * (kMfRows * 128) + r * 128 +
          ((chunk ^ (r % 8)) * 16) + 4 * t);
    }
  issue_s(sn, 0);
  wgmma_wait<0>();
  wg_fence_regs(sn);
#pragma unroll
  for (int e = 0; e < kS; ++e) cur[e] = sn[e];
  for (int i = 0; i + 1 < count; ++i) step(std::true_type{}, i);
  step(std::false_type{}, count - 1);
#pragma unroll
  for (int c = 0; c < P::kChunks; ++c) wg_fence_regs(o[c]);

  const bool whole = splits == 1;
  const long long rows = (long long)gridDim.z * a.M;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    // the four lanes of a row hold parts of its sum
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int n = q0 + rl + 8 * hf;
    if (n >= a.M) continue;
    const float inv = 1.0f / sum;
    const long long r = (whole ? 0 : (long long)split * rows) +
                        (long long)b * a.M + n;
    float* dst = (whole ? a.out : a.part_o) + r * D;
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 64 * c + 8 * j + 2 * t) =
            make_float2(o[c][4 * j + 2 * hf] * inv,
                        o[c][4 * j + 2 * hf + 1] * inv);
    if (t != 0) continue;
    if (!whole) {
      a.part_stats[r] = m[hf];
      a.part_stats[r + splits * rows] = sum;
    } else if (a.row_max) {
      a.row_max[r] = m[hf];
      a.row_sum[r] = sum;
    }
  }
}

template <int D>
cudaError_t memory_attention_bf16_launch(const MfArgs& a, dim3 grid,
                                         cudaStream_t stream) {
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      memory_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMfSmem);
  if (attr != cudaSuccess) return attr;
  static_assert(MfPlan<D>::kBytes <= kMfSmem, "shared memory");
  memory_attention_bf16_kernel<D>
      <<<grid, kMfThreads, MfPlan<D>::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The key splits of a call (tiles_per_split in *per), given ws_floats of
// workspace for their partials: the fewest that fill the card's last wave,
// as the fp32 forward takes them (tc_splits), one block an SM.
template <int D>
int mf_splits(int B, int M, int N, long long ws_floats, int* per) {
  return tc_splits((long long)ceil_div(M, kMfRows) * B, kSmCount,
                   ceil_div(N, kMfKt), (long long)B * M * (D + 2), ws_floats,
                   per);
}

// floats of workspace the ring's parts take: 3 x [B, N, C] bf16 for k and
// for v
inline long long mf_part_floats(int B, int N, int C) {
  return 3LL * B * N * C;
}

}  // namespace
}  // namespace emip

// stats [2, B, M] (row max, row sum) may be null (no gradient will be
// taken). ws: scratch for the key-split partials.
extern "C" int emip_memory_attention(const float* q, const float* k,
                                     const float* v, const float* bias,
                                     float* out, float* stats, float* ws,
                                     long long ws_floats, int B, int M, int N,
                                     int C, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)M * C, ksb = (long long)N * C;
  const AttnOperand qo{q, qsb, C}, ko{k, ksb, C}, vo{v, ksb, C};
  const AttnGrad oo{out, qsb, C};
  float* row_sum = stats ? stats + (long long)B * M : nullptr;
  const Workspace w{ws, ws_floats};
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128)
    err = attention_fwd_tc<128, 128, kMemFwdWarps, kMemFwdMt, kMemFwdStr>(
        qo, ko, vo, bias, nullptr, 1, oo, stats, row_sum, B, 1, M, N, scale,
        w, s);
  else if (C == 64)
    err = attention_fwd_tc<64, 64, kMemFwdWarps, kMemFwdMt, kMemFwdStr>(
        qo, ko, vo, bias, nullptr, 1, oo, stats, row_sum, B, 1, M, N, scale,
        w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// g: [B, M, C] gradient of out; out and stats are the forward's. dq, dk, dv
// may each be null (not computed); the bias gets no gradient. ws: scratch
// for delta and the partials of a split pass.
extern "C" int emip_memory_attention_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const float* out, const float* stats, const float* g, float* dq, float* dk,
    float* dv, float* ws, long long ws_floats, int B, int M, int N, int C,
    void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)M * C, ksb = (long long)N * C;
  const AttnOperand qo{q, qsb, C}, ko{k, ksb, C}, vo{v, ksb, C};
  const AttnOperand oo{out, qsb, C}, go{g, qsb, C};
  const AttnGrad dqg{dq, qsb, C}, dkg{dk, ksb, C}, dvg{dv, ksb, C};
  const float* row_sum = stats + (long long)B * M;
  const Workspace w{ws, ws_floats};
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128)
    err = attention_bwd_tc<128, 128, kMemBwdWarps, kMemBwdMt, kMemBwdStr>(
        qo, ko, vo, oo, go, bias, nullptr, 1, stats, row_sum, dqg, dkg, dvg,
        B, 1, M, N, scale, w, s);
  else if (C == 64)
    err = attention_bwd_tc<64, 64, kMemBwdWarps, kMemBwdMt, kMemBwdStr>(
        qo, ko, vo, oo, go, bias, nullptr, 1, stats, row_sum, dqg, dkg, dvg,
        B, 1, M, N, scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The bf16 forward: q [B, M, C] bf16, k, v [B, N, C], bias [B, N] and out
// [B, M, C] fp32; stats as the fp32 forward's (of the unrounded scores). ws:
// emip_memory_attention_bf16_workspace floats (the ring's parts, and the
// partials of the key splits).
extern "C" long long emip_memory_attention_bf16_workspace(int B, int M, int N,
                                                         int C) {
  using namespace emip;
  int per;
  const long long rows = (long long)B * M;
  const int splits = C == 64 ? mf_splits<64>(B, M, N, LLONG_MAX / 4, &per)
                             : mf_splits<128>(B, M, N, LLONG_MAX / 4, &per);
  return mf_part_floats(B, N, C) + (splits > 1 ? splits * rows * (C + 2) : 0);
}

extern "C" int emip_memory_attention_bf16(const void* q, const float* k,
                                          const float* v, const float* bias,
                                          float* out, float* stats, float* ws,
                                          long long ws_floats, int B, int M,
                                          int N, int C, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long parts = mf_part_floats(B, N, C);
  if ((C != 128 && C != 64) || B <= 0 || B > 65535 || M <= 0 || N <= 0 ||
      !ws || ws_floats < parts || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  // k's parts, then v's: [B, 3, N, C] bf16 each
  bf16* kp = reinterpret_cast<bf16*>(ws);
  bf16* vp = kp + 3LL * B * N * C;
  MfArgs a;
  a.bias = bias;
  a.out = out;
  a.row_max = stats;
  a.row_sum = stats ? stats + (long long)B * M : nullptr;
  a.part_o = a.part_stats = nullptr;
  a.M = M;
  a.N = N;
  a.scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if ((err = wg_map(&a.q, q, true, C, M, B, C, (long long)M * C, 64,
                    kMfRows)) != cudaSuccess ||
      (err = wg_map(&a.k, kp, true, C, N, 3LL * B, C, (long long)N * C, 64,
                    kMfKt)) != cudaSuccess ||
      (err = wg_map(&a.v, vp, true, C, N, 3LL * B, C, (long long)N * C, 64,
                    kMfKt)) != cudaSuccess)
    return (int)err;
  const long long rows = (long long)B * M;
  const int splits =
      C == 128 ? mf_splits<128>(B, M, N, ws_floats - parts, &a.tiles_per_split)
               : mf_splits<64>(B, M, N, ws_floats - parts, &a.tiles_per_split);
  if (splits > 1) {
    a.part_o = ws + parts;
    a.part_stats = a.part_o + splits * rows * C;
  }
  const long long groups = (long long)B * N * C / 8;
  ring_split_kernel<<<ceil_div(2 * groups, 256), 256, 0, s>>>(
      k, v, kp, vp, (long long)N * C, groups);
  const dim3 grid(ceil_div(M, kMfRows), splits, B);
  err = C == 128 ? memory_attention_bf16_launch<128>(a, grid, s)
                 : memory_attention_bf16_launch<64>(a, grid, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const AttnGrad merged{out, (long long)M * C, C};
  if (C == 128)
    attention_merge_kernel<128><<<ceil_div(rows * C, 256), 256, 0, s>>>(
        a.part_o, a.part_stats, splits, 1, M, rows, merged, a.row_max,
        a.row_sum);
  else
    attention_merge_kernel<64><<<ceil_div(rows * C, 256), 256, 0, s>>>(
        a.part_o, a.part_stats, splits, 1, M, rows, merged, a.row_max,
        a.row_sum);
  return (int)cudaGetLastError();
}

// The bf16 backward: q and dq bf16, every other tensor fp32; out and stats
// the bf16 forward's. dq, dk, dv may each be null. ws: as the fp32
// backward's (delta and the partials of a split pass).
extern "C" int emip_memory_attention_bwd_bf16(
    const void* q, const float* k, const float* v, const float* bias,
    const float* out, const float* stats, const float* g, void* dq,
    float* dk, float* dv, float* ws, long long ws_floats, int B, int M,
    int N, int C, void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qsb = (long long)M * C, ksb = (long long)N * C;
  // bf16 bits behind float pointers (Q16 of attention_bwd_tc)
  const AttnOperand qo{static_cast<const float*>(q), qsb, C};
  const AttnOperand ko{k, ksb, C}, vo{v, ksb, C};
  const AttnOperand oo{out, qsb, C}, go{g, qsb, C};
  const AttnGrad dqg{static_cast<float*>(dq), qsb, C}, dkg{dk, ksb, C},
      dvg{dv, ksb, C};
  const float* row_sum = stats + (long long)B * M;
  const Workspace w{ws, ws_floats};
  const float scale = 1.0f / sqrtf((float)C);
  cudaError_t err;
  if (C == 128)
    err = attention_bwd_tc<128, 128, kMemBwdWarps, kMemBwdMt, kMemBwdStr,
                           false, true, false>(
        qo, ko, vo, oo, go, bias, nullptr, 1, stats, row_sum, dqg, dkg, dvg,
        B, 1, M, N, scale, w, s);
  else if (C == 64)
    err = attention_bwd_tc<64, 64, kMemBwdWarps, kMemBwdMt, kMemBwdStr, false,
                           true, false>(
        qo, ko, vo, oo, go, bias, nullptr, 1, stats, row_sum, dqg, dkg, dvg,
        B, 1, M, N, scale, w, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
