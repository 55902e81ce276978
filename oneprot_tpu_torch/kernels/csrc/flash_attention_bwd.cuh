// Device helpers shared by the two FlashAttention-2 backward passes
// (flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu): their parameters,
// the probability and segment-mask arithmetic, the dq pass's prologue (q
// pre-scaled once, delta) and the store of an accumulator's rows. The
// wgmma, TMA and mbarrier primitives are hopper.cuh's.

#pragma once

#include "flash_mha_common.cuh"

namespace fa_bwd {

using namespace flash;

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;     // [B, H, Lq, D] by the strides below: q in the dq
                              // pass, q_s (written by the dq pass) in dk/dv
  const __nv_bfloat16* k;     // [B, H, Lk, D]
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;  // [B, H, Lq, D]
  const __nv_bfloat16* out;   // [B, H, Lq, D], the forward's output (dq pass)
  const float* bias;          // [B, Lk] contiguous, natural-log units, or null
  const int* seg;             // [B, L] contiguous segment ids (Lq = Lk = L), or null
  const float* lse;           // [B, H, Lq] contiguous, base 2, from the forward
  float* delta;               // [B, H, Lq] contiguous, rowsum(dout * out): written
                              // by the dq pass, read by dk/dv
  __nv_bfloat16* qs;          // [B, H, Lq, D]: q_s = bf16(q * qscale), dq pass
  __nv_bfloat16* dq;          // [B, H, Lq, D]
  __nv_bfloat16* dk;          // [B, H, Lk, D]
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, do_sb, do_sh, do_sl, o_sb,
      o_sh, o_sl, qs_sb, qs_sh, qs_sl, dq_sb, dq_sh, dq_sl, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh,
      dv_sl;
  int H, Lq, Lk, D;
  float qscale;  // bf16(1 / sqrt(D)), as f32: q's pre-scale
  float scale;   // 1 / sqrt(D) in f32: dq's final factor
};

// p = exp2((s + bias) * log2(e) - lse), the product rounded before the
// subtraction as the plain version rounds it: fused into an fma, a key of a
// row whose keys are all masked (s + bias = -1e9 exactly, lse a multiple of
// 128 near -1.44e9) would get 2^(+-64) in place of the plain version's 1.
__device__ __forceinline__ float bwd_prob(float s, float bias, float lse) {
  return exp2f(__fmul_rn(s + bias, LOG2E) - lse);
}

// A logit's bias with the segment mask: SEG_MASK on top where the query's
// and the key's ids differ (p = 0 there, as in the forward).
__device__ __forceinline__ float seg_bias(float bias, int id_q, int id_k) {
  return id_q == id_k ? bias : bias + SEG_MASK;
}

// 8 bf16 times `mul` in f32, each rounded once to bf16: the TPU kernels'
// q * bf16(1/sqrt(D)) in the input dtype.
__device__ __forceinline__ uint4 scale8(uint4 x, float mul) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
    w[e] = pack_bf16(f.x * mul, f.y * mul);
  }
  return x;
}

// The dq pass's prologue for one 16-byte chunk of a query row: q_s (already
// scaled, `qs8`) goes out to global memory, and the chunk's share of
// delta = rowsum(dO * O) comes back (0 past Lq or D). `row` is the query,
// `d0` the chunk's first column.
__device__ __forceinline__ float prologue_chunk(const Params& p, int b, int h, int row, int d0,
                                                uint4 qs8, uint4 do8) {
  if (row >= p.Lq || d0 >= p.D) return 0.f;
  *reinterpret_cast<uint4*>(p.qs + b * p.qs_sb + h * p.qs_sh + row * p.qs_sl + d0) = qs8;
  return dot8(do8, *reinterpret_cast<const uint4*>(p.out + b * p.o_sb + h * p.o_sh +
                                                    row * p.o_sl + d0));
}

// Write a warp's 16 x NC accumulator, times `mul`, as bf16 into rows
// row_a / row_a + 8 (this thread's two) and columns col0.. of one head of
// an output with row stride `ld`; rows past L and columns past D are not
// written.
template <int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld,
                                           const float (&acc)[NC / 8][4], int row_a,
                                           int col0, int L, int D, int lane, float mul) {
  const int t = lane % 4;
  const int row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col < D) {
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + row_a * ld + col) =
            pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + row_b * ld + col) =
            pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
    }
  }
}

}  // namespace fa_bwd
