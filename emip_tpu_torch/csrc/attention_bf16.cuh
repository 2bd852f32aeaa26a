// The bf16 forward attention of kernels A, B, C and G (the bf16 band). The
// entry point declared here is the wgmma attention of attention_bf16.cu,
// which window_attention.cu (B's self layer, G) and flow_attention.cu (C)
// call inside their bf16 entry points. The key loop defined here, AbKeys
// (mma.sync, key tiles of 32 behind two cp.async stages), is A's: its
// fused forward of sr_attention.cu runs it.

#pragma once

#include "bf16.cuh"

// out = softmax(q k^T / sqrt(D) (+ mask)) v per batch row, q and k bf16,
// every score and the softmax in fp32. q: [B, Nq, D]; k: [B, Nk, D]; each
// addressed by its batch and row strides in elements (the last stride 1),
// so that B's qkv buffer is read in place. DV == D: v [B, Nk, D] bf16, P
// rounded to bf16 for P v on the tensor cores, out bf16 (the windows of B
// and G: D 128 or 64, Nq == Nk, windows != 0, mask [mask_nw, Nq, Nk] fp32
// or null with batch row b reading mask[b % mask_nw], Nk a multiple of 4
// with the mask; zero_tiles, uint8 [mask_nw, ceil(Nq / 128), ceil(Nk /
// 64)] or null, marks the mask's tiles that are all zero, which are then
// neither loaded nor added: the same bits). DV == 2: v [B, Nk, 2] fp32, P v in fp32 on the CUDA
// cores, out [B, Nq, 2] fp32 (C: D 128 or 64, no mask). Row strides of q,
// k and a wide v are multiples of 8 elements, their pointers 16-byte
// aligned. Returns a cudaError_t (cudaErrorInvalidValue for a launch it
// cannot take).
extern "C" int emip_attention_fwd_bf16(const void* q, long long q_sb,
                                       int q_sn, const void* k,
                                       long long k_sb, int k_sn,
                                       const void* v, long long v_sb,
                                       int v_sn, const float* mask,
                                       int mask_sn, int mask_nw,
                                       const void* zero_tiles,
                                       void* out, long long o_sb, int o_sn,
                                       int B, int Nq, int Nk, int D, int DV,
                                       int windows, void* stream);

namespace emip {
namespace {

constexpr int kAbWarps = 4;
constexpr int kAbRows = 16 * kAbWarps;  // query rows of a block
constexpr int kAbKt = 32;               // keys of a streamed tile
constexpr int kAbThreads = 32 * kAbWarps;

// The key loop's shared memory: two stages of a key tile [kAbKt][D + 8]
// bf16, then two of a value tile ([kAbKt][DV + 8] bf16, or [kAbKt][2] fp32
// with DV = 2).
template <int D, int DV>
struct AbKeyPlan {
  static_assert(D % 16 == 0 && (DV == 2 || DV == D), "widths");
  static constexpr bool kWide = DV != 2;
  static constexpr int kLd = D + 8;  // bf16 per shared row of q and k
  static constexpr int kLdV = kWide ? DV + 8 : 2;
  static constexpr int kK = kAbKt * kLd;  // bf16 per stage
  static constexpr size_t kVBytes =
      kWide ? sizeof(bf16) * kAbKt * kLdV : sizeof(float) * kAbKt * 2;
  static constexpr size_t kBytes = 2 * (sizeof(bf16) * kK + kVBytes);
  // output accumulators of a lane (with DV = 2, o[0][2 hf + c] holds this
  // lane's part of column c of row hf)
  static constexpr int kAccN = kWide ? DV / 8 : 1;
};

// One batch row's key loop, run by all kAbWarps warps of a block: the block
// streams the keys and values in tiles of kAbKt through the two stages at
// Ks and Vs (kp, vp: the head's columns of key and value row 0; rows k_sn
// and v_sn elements apart), and each warp runs the online softmax for its
// 16 query rows. start() sends the first tile on its way (copies the caller
// issued before are committed with it); run() then walks every tile, one
// commit per tile.
template <int D, int DV, bool MASKED>
struct AbKeys {
  using L = AbKeyPlan<D, DV>;
  const bf16* kp;
  long long k_sn;
  const void* vp;
  long long v_sn;
  int Nk;
  bf16* Ks;
  unsigned char* Vs;

  // the copies of key tile `tile` into stage tile % 2; one commit, empty
  // past the last tile
  __device__ __forceinline__ void fill(int tile) const {
    const int tid = threadIdx.x;
    if (tile * kAbKt < Nk) {
      const int k0 = tile * kAbKt, s = tile % 2;
      constexpr int kChunks = D / 8;  // 16-byte chunks of a k row
      bf16* ks = Ks + s * L::kK;
      for (int e = tid; e < kAbKt * kChunks; e += kAbThreads) {
        const int r = e / kChunks, c = (e % kChunks) * 8;
        const bool ok = k0 + r < Nk;
        cp_async<16>(ks + r * L::kLd + c,
                     ok ? kp + (long long)(k0 + r) * k_sn + c : kp, ok);
      }
      if constexpr (L::kWide) {
        const bf16* vb = static_cast<const bf16*>(vp);
        bf16* vs = reinterpret_cast<bf16*>(Vs + s * L::kVBytes);
        constexpr int kVChunks = DV / 8;
        for (int e = tid; e < kAbKt * kVChunks; e += kAbThreads) {
          const int r = e / kVChunks, c = (e % kVChunks) * 8;
          const bool ok = k0 + r < Nk;
          cp_async<16>(vs + r * L::kLdV + c,
                       ok ? vb + (long long)(k0 + r) * v_sn + c : vb, ok);
        }
      } else {
        const float* vf = static_cast<const float*>(vp);
        float* vs = reinterpret_cast<float*>(Vs + s * L::kVBytes);
        for (int r = tid; r < kAbKt; r += kAbThreads) {
          const bool ok = k0 + r < Nk;
          cp_async<8>(vs + 2 * r, ok ? vf + (long long)(k0 + r) * v_sn : vf,
                      ok);
        }
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void start() const { fill(0); }

  // The online softmax of this thread's rows row_a and row_a + 8 (mask:
  // this batch row's [Nq, Nk] or null). qf holds their q fragments, or
  // load_q() loads them once the first tile has landed. The scores stay in
  // the accumulator fragments: the online max and sum run on them in
  // registers (a row lives in the four lanes of a quad), and P is packed to
  // bf16 straight from them as the A operand of P v (two 8-key accumulator
  // tiles make one 16-key A fragment); with DV = 2, P v runs in fp32 on the
  // CUDA cores. Keys past Nk are masked to -inf. On return o holds this
  // lane's unnormalised output of its two rows (with DV = 2 summed over
  // the quad) and inv their 1 / row sum; every copy has landed and every
  // warp is past its last read of Ks and Vs once the block next
  // synchronises.
  template <typename LoadQ>
  __device__ __forceinline__ void run(const float* mask, int Nq, float scale,
                                      int row_a, uint32_t (&qf)[D / 16][4],
                                      float (&o)[L::kAccN][4],
                                      float (&inv)[2],
                                      LoadQ&& load_q) const {
    const int lane = threadIdx.x % 32, t = lane % 4;

    // the running max (the same in the four lanes of a row) and this
    // lane's part of the running sum
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < L::kAccN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    const int tiles = (Nk + kAbKt - 1) / kAbKt;
    for (int tile = 0; tile < tiles; ++tile) {
      const int s = tile % 2;
      // this tile has landed, and every warp is done with the one before,
      // whose stage the next tile's copy may now overwrite
      cp_async_wait<0>();
      __syncthreads();
      fill(tile + 1);
      if (tile == 0) load_q();
      const bf16* ks = Ks + s * L::kK;
      const int k0 = tile * kAbKt;

      float sc[kAbKt / 8][4];
#pragma unroll
      for (int j = 0; j < kAbKt / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < kAbKt / 16; ++n2) {
          uint32_t r[4];
          ldmatrix_x4(r, ks + (16 * n2 + lane % 8 + (lane / 16) * 8) *
                                  L::kLd +
                             kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(sc[2 * n2], qf[kk], r[0], r[1]);
          mma_bf16(sc[2 * n2 + 1], qf[kk], r[2], r[3]);
        }

      // scaled (masked) scores; keys past the end at -inf
      float mnew[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kAbKt / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + 8 * j + 2 * t + c;
          const bool ok = col < Nk;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float x = sc[j][2 * hf + c] * scale;
            if constexpr (MASKED)
              if (mask)
                x += __ldg(mask +
                           (long long)min(row_a + 8 * hf, Nq - 1) * Nk +
                           min(col, Nk - 1));
            x = ok ? x : -INFINITY;
            sc[j][2 * hf + c] = x;
            mnew[hf] = fmaxf(mnew[hf], x);
          }
        }
      // the row max over the quad, the rescale of what came before
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = mnew[hf];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, mrow[hf]);
        const float alpha = __expf(mrow[hf] - mx);  // 0 on the first tile
        mrow[hf] = mnew[hf] = mx;
        lrow[hf] *= alpha;
#pragma unroll
        for (int n = 0; n < L::kAccN; ++n) {
          o[n][2 * hf] *= alpha;
          o[n][2 * hf + 1] *= alpha;
        }
      }
      // P in place of S; with DV = 2 also O += P v here, in fp32
      const float* vsf = reinterpret_cast<const float*>(Vs + s * L::kVBytes);
#pragma unroll
      for (int j = 0; j < kAbKt / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v0 = 0.f, v1 = 0.f;
          if constexpr (!L::kWide) {
            const int col = 8 * j + 2 * t + c;
            v0 = vsf[2 * col];
            v1 = vsf[2 * col + 1];
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float p = __expf(sc[j][2 * hf + c] - mnew[hf]);
            sc[j][2 * hf + c] = p;
            lrow[hf] += p;
            if constexpr (!L::kWide) {
              o[0][2 * hf] = fmaf(p, v0, o[0][2 * hf]);
              o[0][2 * hf + 1] = fmaf(p, v1, o[0][2 * hf + 1]);
            }
          }
        }
      if constexpr (L::kWide) {
        const bf16* vs = reinterpret_cast<const bf16*>(Vs + s * L::kVBytes);
#pragma unroll
        for (int kk = 0; kk < kAbKt / 16; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
          for (int n2 = 0; n2 < DV / 16; ++n2) {
            uint32_t r[4];
            ldmatrix_x4_trans(
                r, vs + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) *
                            L::kLdV +
                       16 * n2 + (lane / 16) * 8);
            mma_bf16(o[2 * n2], pa, r[0], r[1]);
            mma_bf16(o[2 * n2 + 1], pa, r[2], r[3]);
          }
        }
      }
    }

    // the four lanes of a row hold parts of its sum (and, with DV = 2, of
    // its two outputs)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = lrow[hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if constexpr (!L::kWide) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = o[0][2 * hf + c];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
        }
      }
      inv[hf] = 1.0f / l;
    }
  }
};

}  // namespace
}  // namespace emip
