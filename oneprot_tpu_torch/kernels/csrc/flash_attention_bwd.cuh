// Device helpers shared by the two FlashAttention-2 backward passes
// (flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu): their parameters,
// the dq pass's prologue arithmetic (q pre-scaled once, delta), and, for
// the dq pass's mma.sync instance (heads wider than 128), the cp.async
// copies of row tiles into shared memory and its two fragment products. The mma/ldmatrix primitives and fragment layouts are
// flash_mha_common.cuh's; the wgmma, TMA and mbarrier ones hopper.cuh's.

#pragma once

#include "flash_mha_common.cuh"

namespace fa_bwd {

using namespace flash;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;  // four warps

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

// Start the copies of rows [row0, row0 + NROWS) of one head (`src`, rows
// `ld` elements apart, unit stride over D) into a [NROWS][LDS] tile, 16
// bytes a copy; rows past L and columns past D are zero-filled.
template <int DP, int LDS, int NROWS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int L, long long ld, int D) {
  for (int i = threadIdx.x; i < NROWS * (DP / 8); i += THREADS) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < L && c < D;
    cp_async16(dst + r * LDS + c, ok ? src + row * ld + c : src, ok);
  }
}

// 4-byte words [row0, row0 + N) of a per-row array (f32, or int32 ids);
// zero past L or when the array is null (a copy that reads nothing still
// names a valid address: `any`).
template <int N, typename T>
__device__ __forceinline__ void copy_words(T* dst, const T* src, int row0, int L,
                                           const void* any) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const int row = row0 + i;
    const bool ok = src != nullptr && row < L;
    cp_async4(dst + i, ok ? static_cast<const void*>(src + row) : any, ok);
  }
}

// c[j] = A . X^T for the 8-row blocks j of X: A is the 16 x DP tile whose
// first row is `a` (of a [*][LDS] tile), X a [NJ * 8][LDS] tile. The
// product over the head dim (q k^T, dO v^T and their transposes); A's
// fragments are read from shared memory once per k-step pair.
template <int DP, int LDS, int NJ>
__device__ __forceinline__ void mma_a_xt(float (&c)[NJ][4], const __nv_bfloat16* a,
                                         const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const __nv_bfloat16* a_base =
      a + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4);
#pragma unroll
  for (int kp = 0; kp < DP / 32; ++kp) {
    uint32_t a0[4], a1[4];  // A fragments of k-steps 2kp and 2kp+1
    ldsm_x4(a0, a_base + kp * 32);
    ldsm_x4(a1, a_base + kp * 32 + 16);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t b[4];  // b0, b1 of k-steps 2kp and 2kp+1
      ldsm_x4(b, x + (j * 8 + (lane & 7)) * LDS + kp * 32 + 8 * (lane >> 3));
      mma16816(c[j], a0, b[0], b[1]);
      mma16816(c[j], a1, b[2], b[3]);
    }
  }
}

// acc (16 x NC) += bf16(S) . X, for S the 16 x NK C fragments `s` and X the
// NK x NC block of a [NK][LDS] tile that starts at `x` (its first column):
// the product over the streamed rows (dS k, p^T dO, dS^T q).
template <int NC, int LDS, int NK>
__device__ __forceinline__ void mma_s_x(float (&acc)[NC / 8][4], const float (&s)[NK / 8][4],
                                        const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const int row = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int jp = 0; jp < NC / 16; ++jp) {
      uint32_t b[4];  // b0, b1 of column blocks 2jp and 2jp+1
      ldsm_x4_trans(b, x + row * LDS + 8 * (2 * jp + (lane >> 4)));
      mma16816(acc[2 * jp], a, b[0], b[1]);
      mma16816(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
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
