// The bf16 forward attention of kernels A, B and C (the bf16 band of short
// inference): defined once, with its instantiations, in attention_bf16.cu;
// sr_attention.cu, window_attention.cu and flow_attention.cu call it inside
// their bf16 entry points.

#pragma once

// out = softmax(q_h k_h^T / sqrt(D) (+ mask)) v_h per head h of width D, q
// and k bf16, every score and the softmax in fp32. q: [B, Nq, H * D]; k:
// [B, Nk, H * D]; each addressed by its batch and row strides in elements
// (the last stride 1), so that A's q buffer and the two halves of its
// [k | v] buffer are read in place and o is written at the head's columns.
// DV == D: v [B, Nk, H * D] bf16, P rounded to bf16 for P v on the tensor
// cores, out bf16 (A's heads: D 64 or 32; with windows != 0 B's windows: D
// 128 or 64, H 1, Nq == Nk, mask [mask_nw, Nq, Nk] fp32 or null with batch
// row b reading mask[b % mask_nw]). DV == 2: v [B, Nk, 2] fp32, P v in
// fp32 on the CUDA cores, out [B, Nq, 2] fp32 (C: D 128 or 64, H 1, no
// mask). Returns a cudaError_t.
extern "C" int emip_attention_fwd_bf16(const void* q, long long q_sb,
                                       int q_sn, const void* k,
                                       long long k_sb, int k_sn,
                                       const void* v, long long v_sb,
                                       int v_sn, const float* mask,
                                       int mask_nw, void* out, long long o_sb,
                                       int o_sn, int B, int H, int Nq, int Nk,
                                       int D, int DV, int windows,
                                       void* stream);
