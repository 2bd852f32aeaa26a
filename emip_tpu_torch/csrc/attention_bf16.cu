// The bf16 forward attention of kernels A, B and C (declared in
// attention_bf16.cuh), beside the 3xTF32 attention_fwd_tc of mma_tf32.cuh
// that their fp32 entry points run.
//
// Replaces, in the bf16 band, the attention inside
// emip_tpu/ops/pallas/sr_attention.py:_fwd_kernel (A), window_attention.py:
// _block_self_forward (B's self layer) and corr_softmax.py:
// _flow_attention_kernel (C). The JAX kernels take bf16 q and k, accumulate
// q k^T in fp32 and run the softmax in fp32; A and B round the normalised P
// to bf16 for P v (fp32 accumulation) and round o to bf16; C keeps P in
// fp32 and upcasts its 2-wide v. Here the softmax is online: P = exp(s -
// m_running) is rounded to bf16 for the tensor-core P v and the sum is
// divided out at the end, the same function within the bf16 band; C's 2-wide
// P v stays on the CUDA cores in fp32.
//
// What bounds it: the q k^T product (and with DV = D the P v product), 2 Nq
// Nk D operations each per batch row, at the bf16 tensor-core rate. A block
// of 4 warps owns 64 query rows of one batch row (a warp 16 rows, its q
// fragments in registers for the whole key loop); keys and values stream
// in tiles of 32 through two cp.async stages, fragments read with ldmatrix
// (v transposed by ldmatrix.trans). The scores stay in the accumulator
// fragments: the online max and sum run on them in registers (a row lives
// in the four lanes of a quad), and P is packed to bf16 straight from them
// as the A operand of P v (two 8-key accumulator tiles make one 16-key A
// fragment). Keys past Nk are masked to -inf; the shifted-window mask of B
// (3.7 MiB at T = 484) is read from L2 where it is added. The [Nq, Nk]
// scores never reach device memory. One split of the keys: a first, simple
// instantiation; B's 64 windows of 484 tokens make 512 blocks, A's last
// stage 128.

#include "attention_bf16.cuh"

#include "bf16.cuh"

namespace emip {
namespace {

constexpr int kAbWarps = 4;
constexpr int kAbRows = 16 * kAbWarps;  // query rows of a block
constexpr int kAbKt = 32;               // keys of a streamed tile
constexpr int kAbThreads = 32 * kAbWarps;

struct AttnBf16Args {
  const bf16* q;
  long long q_sb;
  int q_sn;
  const bf16* k;
  long long k_sb;
  int k_sn;
  const void* v;
  long long v_sb;
  int v_sn;
  const float* mask;
  int mask_nw;
  void* out;
  long long o_sb;
  int o_sn;
  int H, Nq, Nk;
  float scale;
};

template <int D, int DV>
struct AbPlan {
  static_assert(D % 16 == 0 && (DV == 2 || DV == D), "widths");
  static constexpr bool kWide = DV != 2;
  static constexpr int kLd = D + 8;  // bf16 per shared row of q and k
  static constexpr int kLdV = kWide ? DV + 8 : 2;
  static constexpr int kQ = kAbRows * kLd;             // bf16
  static constexpr int kK = kAbKt * kLd;               // bf16 per stage
  static constexpr size_t kVBytes =
      kWide ? sizeof(bf16) * kAbKt * kLdV : sizeof(float) * kAbKt * 2;
  static constexpr size_t kBytes =
      sizeof(bf16) * (kQ + 2 * kK) + 2 * kVBytes;
};

// Grid (query tiles, B * H). Batch row z = b H + h is head h of batch b:
// its row n of q and k lies at p[b sb + n sn + h D], of v and out at ... +
// h DV.
template <int D, int DV, bool MASKED>
__global__ void __launch_bounds__(kAbThreads)
attention_bf16_kernel(AttnBf16Args a) {
  using L = AbPlan<D, DV>;
  extern __shared__ __align__(16) unsigned char ab_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(ab_smem);  // [kAbRows][kLd]
  bf16* Ks = Qs + L::kQ;                        // [2][kAbKt][kLd]
  unsigned char* Vs = reinterpret_cast<unsigned char*>(Ks + 2 * L::kK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int z = blockIdx.y, b = z / a.H, h = z % a.H;
  const int q0 = blockIdx.x * kAbRows;
  const bf16* qp = a.q + b * a.q_sb + (long long)h * D;
  const bf16* kp = a.k + b * a.k_sb + (long long)h * D;
  const float* mask =
      MASKED && a.mask ? a.mask + (long long)(b % a.mask_nw) * a.Nq * a.Nk
                       : nullptr;

  constexpr int kChunks = D / 8;  // 16-byte chunks of a q or k row
  for (int e = tid; e < kAbRows * kChunks; e += kAbThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = q0 + r < a.Nq;
    cp_async<16>(Qs + r * L::kLd + c,
                     ok ? qp + (long long)(q0 + r) * a.q_sn + c : qp, ok);
  }

  auto fill = [&](int tile, int s) {
    const int k0 = tile * kAbKt;
    bf16* ks = Ks + s * L::kK;
    for (int e = tid; e < kAbKt * kChunks; e += kAbThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const bool ok = k0 + r < a.Nk;
      cp_async<16>(ks + r * L::kLd + c,
                       ok ? kp + (long long)(k0 + r) * a.k_sn + c : kp, ok);
    }
    if constexpr (L::kWide) {
      const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb +
                       (long long)h * DV;
      bf16* vs = reinterpret_cast<bf16*>(Vs + s * L::kVBytes);
      constexpr int kVChunks = DV / 8;
      for (int e = tid; e < kAbKt * kVChunks; e += kAbThreads) {
        const int r = e / kVChunks, c = (e % kVChunks) * 8;
        const bool ok = k0 + r < a.Nk;
        cp_async<16>(vs + r * L::kLdV + c,
                         ok ? vp + (long long)(k0 + r) * a.v_sn + c : vp, ok);
      }
    } else {
      const float* vp = static_cast<const float*>(a.v) + b * a.v_sb;
      float* vs = reinterpret_cast<float*>(Vs + s * L::kVBytes);
      for (int r = tid; r < kAbKt; r += kAbThreads) {
        const bool ok = k0 + r < a.Nk;
        cp_async<8>(vs + 2 * r,
                        ok ? vp + (long long)(k0 + r) * a.v_sn : vp, ok);
      }
    }
    cp_async_commit();
  };

  // this thread's rows g and g + 8 of the warp's 16: the running max (the
  // same in the four lanes of a row), this lane's part of the running sum,
  // the output accumulators (with DV = 2, o[0][2 hf + c] holds this lane's
  // part of column c of row hf)
  constexpr int kAccN = L::kWide ? DV / 8 : 1;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  float o[kAccN][4];
#pragma unroll
  for (int n = 0; n < kAccN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qf[D / 16][4];

  const int row_a = q0 + warp * 16 + g;  // this thread's first row
  const int tiles = (a.Nk + kAbKt - 1) / kAbKt;
  fill(0, 0);  // also commits the q copies
  for (int tile = 0; tile < tiles; ++tile) {
    const int s = tile % 2;
    // this tile has landed, and every warp is done with the one before,
    // whose stage the next tile's copy may now overwrite
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < tiles) fill(tile + 1, s ^ 1);
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * L::kLd + kk * 16 +
                                (lane / 16) * 8);
    }
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
        ldmatrix_x4(r, ks + (16 * n2 + lane % 8 + (lane / 16) * 8) * L::kLd +
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
        const bool ok = col < a.Nk;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float x = sc[j][2 * hf + c] * a.scale;
          if constexpr (MASKED)
            if (mask)
              x += __ldg(mask +
                         (long long)min(row_a + 8 * hf, a.Nq - 1) * a.Nk +
                         min(col, a.Nk - 1));
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
      for (int n = 0; n < kAccN; ++n) {
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
              r, vs + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * L::kLdV +
                     16 * n2 + (lane / 16) * 8);
          mma_bf16(o[2 * n2], pa, r[0], r[1]);
          mma_bf16(o[2 * n2 + 1], pa, r[2], r[3]);
        }
      }
    }
  }

  // the four lanes of a row hold parts of its sum (and, with DV = 2, of its
  // two outputs)
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
    const int n = row_a + 8 * hf;
    if (n >= a.Nq) continue;
    const float inv = 1.0f / l;
    if constexpr (L::kWide) {
      bf16* dst = static_cast<bf16*>(a.out) + b * a.o_sb +
                  (long long)n * a.o_sn + (long long)h * DV;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c + 2 * t) =
            __floats2bfloat162_rn(o[c][2 * hf] * inv, o[c][2 * hf + 1] * inv);
    } else if (t == 0) {
      float* dst = static_cast<float*>(a.out) + b * a.o_sb +
                   (long long)n * a.o_sn;
      *reinterpret_cast<float2*>(dst) =
          make_float2(o[0][2 * hf] * inv, o[0][2 * hf + 1] * inv);
    }
  }
}

template <int D, int DV, bool MASKED>
cudaError_t attention_bf16_launch(const AttnBf16Args& a, int BH,
                                  cudaStream_t stream) {
  using L = AbPlan<D, DV>;
  // set once per instantiation, not per launch (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bf16_kernel<D, DV, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ceil_div(a.Nq, kAbRows), BH);
  attention_bf16_kernel<D, DV, MASKED>
      <<<grid, kAbThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace emip

extern "C" int emip_attention_fwd_bf16(const void* q, long long q_sb,
                                       int q_sn, const void* k,
                                       long long k_sb, int k_sn,
                                       const void* v, long long v_sb,
                                       int v_sn, const float* mask,
                                       int mask_nw, void* out, long long o_sb,
                                       int o_sn, int B, int H, int Nq, int Nk,
                                       int D, int DV, int windows,
                                       void* stream) {
  using namespace emip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Nq <= 0 || Nk <= 0 || B <= 0 || H <= 0 || q_sn % 8 || k_sn % 8 ||
      q_sb % 8 || k_sb % 8 || !aligned16_ptr(q) || !aligned16_ptr(k) ||
      (mask && !windows))
    return (int)cudaErrorInvalidValue;
  AttnBf16Args a;
  a.q = static_cast<const bf16*>(q); a.q_sb = q_sb; a.q_sn = q_sn;
  a.k = static_cast<const bf16*>(k); a.k_sb = k_sb; a.k_sn = k_sn;
  a.v = v; a.v_sb = v_sb; a.v_sn = v_sn;
  a.mask = mask; a.mask_nw = mask_nw > 0 ? mask_nw : 1;
  a.out = out; a.o_sb = o_sb; a.o_sn = o_sn;
  a.H = H; a.Nq = Nq; a.Nk = Nk;
  a.scale = 1.0f / sqrtf((float)D);
  const int BH = B * H;
  cudaError_t err;
  if (DV == 2) {  // kernel C: fp32 v and out
    if (H != 1 || windows || v_sn % 2 || v_sb % 2)
      return (int)cudaErrorInvalidValue;
    if (D == 128)
      err = attention_bf16_launch<128, 2, false>(a, BH, s);
    else if (D == 64)
      err = attention_bf16_launch<64, 2, false>(a, BH, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (DV != D || v_sn % 8 || v_sb % 8 || !aligned16_ptr(v)) {
    return (int)cudaErrorInvalidValue;
  } else if (windows) {  // kernel B's windows
    if (H != 1 || Nq != Nk) return (int)cudaErrorInvalidValue;
    if (D == 128)
      err = attention_bf16_launch<128, 128, true>(a, BH, s);
    else if (D == 64)
      err = attention_bf16_launch<64, 64, true>(a, BH, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {  // kernel A's heads
    if (D == 64)
      err = attention_bf16_launch<64, 64, false>(a, BH, s);
    else if (D == 32)
      err = attention_bf16_launch<32, 32, false>(a, BH, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
