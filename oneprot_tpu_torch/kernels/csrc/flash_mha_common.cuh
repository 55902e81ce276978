// Device helpers shared by the flash-MHA kernels (forward, dq, dk/dv):
// cp.async copies into shared memory, ldmatrix fragment loads, the
// mma.sync m16n8k16 bf16 product with f32 accumulation, bf16 packing and
// the rotary rotation of 4 columns of a head's two halves.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g,
//     cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16x8: b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9, col g);
//   C 16x8: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So a C tile of two adjacent 8-column blocks, packed to bf16, is the A
// fragment of the next product, and probabilities never leave registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float SEG_MASK = -1e30f;  // cross-segment logit, as the TPU kernel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; with valid = false the destination is
// zero-filled and the source is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 consecutive bf16 <-> f32
__device__ __forceinline__ void unpack4(uint2 u, float (&x)[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  x[0] = __low2float(h[0]);
  x[1] = __high2float(h[0]);
  x[2] = __low2float(h[1]);
  x[3] = __high2float(h[1]);
}
__device__ __forceinline__ uint2 pack4(const float (&x)[4]) {
  return make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
}

// x_lo, x_hi: the same 4 columns of the two halves of a head;
// (x_lo, x_hi) <- (x_lo*cos_lo - x_hi*sin_lo, x_hi*cos_hi + x_lo*sin_hi)
__device__ __forceinline__ void rotate4(float (&lo)[4], float (&hi)[4], uint2 c_lo,
                                        uint2 c_hi, uint2 s_lo, uint2 s_hi) {
  float cl[4], ch[4], sl[4], sh[4];
  unpack4(c_lo, cl);
  unpack4(c_hi, ch);
  unpack4(s_lo, sl);
  unpack4(s_hi, sh);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = lo[e], b = hi[e];
    lo[e] = a * cl[e] - b * sl[e];
    hi[e] = b * ch[e] + a * sh[e];
  }
}


// ---------------------------------------------------------------------------
// Shared by the two backward passes (flash_mha_bwd_dq.cu, flash_mha_bwd_dkv.cu)

constexpr int BWD_ROWS = 64;      // query (or key) rows per CTA, 16 per warp
constexpr int BWD_TILE = 64;      // keys (or queries) per streamed tile
constexpr int BWD_THREADS = 128;  // four warps
constexpr float LN2 = 0.6931471805599453f;

struct BwdParams {
  const __nv_bfloat16* q;     // [B, L, H*D], as the forward read them
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;  // [B, L, H*D]
  const float* bias;          // [B, L] log2 units, or null
  const __nv_bfloat16* cos;   // [L, D] or null
  const __nv_bfloat16* sin;
  const int* seg;             // [B, L] or null
  const float* lse;           // [B, H, L] base 2, from the forward
  const float* delta;         // [B, H, L] rowsum(dout * out) per head
  __nv_bfloat16* dq;          // [B, L, H*D]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int L, H, D;
  float q_pre;                // log2(e) / sqrt(D), as the forward
  float scale;                // 1 / sqrt(D)
};

// Start the copy of rows [row0, row0 + BWD_TILE) of one head of a
// [B, L, H*D] tensor into a [BWD_TILE][LDS] tile, 16 bytes a copy; rows
// past L and columns past D are zero-filled.
template <int DP, int LDS>
__device__ __forceinline__ void copy_head_rows(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                                size_t head_off, int row0, int L,
                                                int HD, int D) {
  for (int i = threadIdx.x; i < BWD_TILE * (DP / 8); i += BWD_THREADS) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < L && c < D;
    cp_async16(dst + r * LDS + c, ok ? src + head_off + (size_t)row * HD + c : src, ok);
  }
}

// The same for rows of the [L, D] rotary tables, into a [BWD_TILE][DP] tile.
template <int DP>
__device__ __forceinline__ void copy_table_rows(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src, int row0,
                                                 int L, int D) {
  for (int i = threadIdx.x; i < BWD_TILE * (DP / 8); i += BWD_THREADS) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < L && c < D;
    cp_async16(dst + r * DP + c, ok ? src + (size_t)row * D + c : src, ok);
  }
}

// 4-byte words [row0, row0 + BWD_TILE) of a per-row array; zero past L or
// when the array is null (a copy that reads nothing still names a valid
// address: `any`).
__device__ __forceinline__ void copy_row_words(void* dst, const void* src, int row0,
                                               int L, const void* any) {
  if (threadIdx.x < BWD_TILE) {
    const int row = row0 + threadIdx.x;
    const bool ok = src != nullptr && row < L;
    cp_async4(static_cast<uint32_t*>(dst) + threadIdx.x,
              ok ? static_cast<const void*>(static_cast<const uint32_t*>(src) + row)
                 : any,
              ok);
  }
}

// In place on a landed [BWD_TILE][LDS] tile: rotary (when the tables are
// given) and then a multiply by `mul`, in f32, rounded once to bf16: the
// forward's arithmetic for q (mul = q_pre) and for k (no multiply).
template <int DP, int LDS>
__device__ __forceinline__ void rotate_scale_tile(__nv_bfloat16* x,
                                                  const __nv_bfloat16* cos,
                                                  const __nv_bfloat16* sin, int D,
                                                  bool rotary, bool scaled, float mul) {
  const int half = D / 2;
  if (rotary) {
    for (int i = threadIdx.x; i < BWD_TILE * (half / 4); i += BWD_THREADS) {
      const int r = i / (half / 4), c = (i % (half / 4)) * 4;
      uint2* lo_p = reinterpret_cast<uint2*>(x + r * LDS + c);
      uint2* hi_p = reinterpret_cast<uint2*>(x + r * LDS + c + half);
      float lo[4], hi[4];
      unpack4(*lo_p, lo);
      unpack4(*hi_p, hi);
      const __nv_bfloat16* cr = cos + r * DP;
      const __nv_bfloat16* sr = sin + r * DP;
      rotate4(lo, hi, *reinterpret_cast<const uint2*>(cr + c),
              *reinterpret_cast<const uint2*>(cr + c + half),
              *reinterpret_cast<const uint2*>(sr + c),
              *reinterpret_cast<const uint2*>(sr + c + half));
      if (scaled) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] *= mul;
          hi[e] *= mul;
        }
      }
      *lo_p = pack4(lo);
      *hi_p = pack4(hi);
    }
  } else if (scaled) {
    for (int i = threadIdx.x; i < BWD_TILE * (D / 4); i += BWD_THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      uint2* p = reinterpret_cast<uint2*>(x + r * LDS + c);
      float v[4];
      unpack4(*p, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= mul;
      *p = pack4(v);
    }
  }
}

// A fragments of 16 rows x DP columns (the warp's rows of a [*][LDS] tile)
template <int DP, int LDS>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DP / 16][4],
                                             const __nv_bfloat16* tile, int row0,
                                             int lane) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int r = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
    ldsm_x4(f[ks], tile + r * LDS + ks * 16 + 8 * (lane >> 4));
  }
}

// c[j] += A (16 x DP, fragments a) . X^T for the 8-row blocks j of a
// [BWD_TILE][LDS] tile X: the product over the head dim (q k^T, dO v^T)
template <int DP, int LDS>
__device__ __forceinline__ void mma_rows_t(float (&c)[BWD_TILE / 8][4],
                                           const uint32_t (&a)[DP / 16][4],
                                           const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int j = 0; j < BWD_TILE / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < DP / 32; ++kp) {
      uint32_t b[4];  // b0, b1 of k-steps 2kp and 2kp+1
      ldsm_x4(b, x + (j * 8 + (lane & 7)) * LDS + kp * 32 + 8 * (lane >> 3));
      mma16816(c[j], a[2 * kp], b[0], b[1]);
      mma16816(c[j], a[2 * kp + 1], b[2], b[3]);
    }
  }
}

// acc (16 x DP) += S (16 x BWD_TILE, C fragments s, rounded to bf16) . X
// for a [BWD_TILE][LDS] tile X: the product over the streamed rows
template <int DP, int LDS>
__device__ __forceinline__ void mma_acc(float (&acc)[DP / 8][4],
                                        const float (&s)[BWD_TILE / 8][4],
                                        const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int kk = 0; kk < BWD_TILE / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int jp = 0; jp < DP / 16; ++jp) {
      uint32_t b[4];  // b0, b1 of d-blocks 2jp and 2jp+1
      const int row = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      ldsm_x4_trans(b, x + row * LDS + 8 * (2 * jp + (lane >> 4)));
      mma16816(acc[2 * jp], a, b[0], b[1]);
      mma16816(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// Write the warp's 16 x DP accumulator, times `mul`, into an f32 [*][DP]
// tile of shared memory (rows row0..row0+15).
template <int DP>
__device__ __forceinline__ void acc_to_smem(float* g_s, const float (&acc)[DP / 8][4],
                                            int row0, int lane, float mul) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    float* ra = g_s + (row0 + g) * DP + j * 8 + 2 * t;
    float* rb = ra + 8 * DP;
    ra[0] = acc[j][0] * mul;
    ra[1] = acc[j][1] * mul;
    rb[0] = acc[j][2] * mul;
    rb[1] = acc[j][3] * mul;
  }
}

// Rows [row0, row0 + BWD_ROWS) of a gradient taken in the rotated frame
// (f32 [BWD_ROWS][DP] in shared memory) to the input frame,
// R^T g = g cos - rotate_half(g) sin, as bf16 into one head of a
// [B, L, H*D] tensor. Without tables, a plain copy.
template <int DP>
__device__ __forceinline__ void write_rotated_back(__nv_bfloat16* out, const float* g_s,
                                                   const BwdParams& p, size_t head_off,
                                                   int row0) {
  const int D = p.D, half = p.D / 2, HD = p.H * p.D;
  for (int i = threadIdx.x; i < BWD_ROWS * (D / 2); i += BWD_THREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    const int row = row0 + r;
    if (row >= p.L) continue;
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c + e;
      const float gv = g_s[r * DP + col];
      if (p.cos != nullptr) {
        const float cs = __bfloat162float(p.cos[(size_t)row * D + col]);
        const float sn = __bfloat162float(p.sin[(size_t)row * D + col]);
        x[e] = col < half ? gv * cs + g_s[r * DP + col + half] * sn
                          : gv * cs - g_s[r * DP + col - half] * sn;
      } else {
        x[e] = gv;
      }
    }
    *reinterpret_cast<uint32_t*>(out + head_off + (size_t)row * HD + c) =
        pack_bf16(x[0], x[1]);
  }
}

}  // namespace flash
