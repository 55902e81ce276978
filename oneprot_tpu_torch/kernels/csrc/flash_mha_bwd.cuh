// Shared by the two flash-MHA backward passes (flash_mha_bwd_dq.cu,
// flash_mha_bwd_dkv.cu): their parameters and shared-memory tiles, the skip
// rule's list of tiles that share a segment, the rotary rotation of a landed
// tile in place, and the epilogues that take a gradient from the rotated
// frame back to the input's. The flash-MHA forward (flash_mha_fwd.cu) takes
// the rotation from here too, so all three round rot(q), rot(k) and q_r
// alike; the skip rule's tile ranges are segment_tiles.cuh's.
//
// Both passes are warp-specialised sm_90a kernels of 160 threads: warpgroup
// 0 (threads 0-127) computes 64 rows with wgmma, warp 4 (threads 128-159)
// is the producer (TMA loads through 4-D tensor maps over the [B, L, H*D]
// projections, and the per-row side data by plain loads). Tiles are TILE =
// 64 rows of DP columns (DP = 32: 64-byte rows, 64-byte swizzle; DP = 64:
// 128-byte rows, 128-byte swizzle; see hopper.cuh); TMA zero-fills the rows
// past L and the columns past the head dim D.

#pragma once

#include <limits.h>

#include "flash_mha_common.cuh"
#include "hopper.cuh"
#include "segment_tiles.cuh"

namespace mha_bwd {

using namespace flash;
using namespace hopper;

constexpr int TILE = 64;          // rows of a CTA's block and of a streamed tile
constexpr int THREADS = 160;      // one consumer warpgroup + one producer warp
constexpr int CONSUMERS = 128;
constexpr int STAGES = 2;
constexpr int BAR_LIST = 1;       // named barrier: the tile list is ready (160)
constexpr int BAR_CONSUMERS = 2;  // named barrier of the consumer warpgroup (128)

struct Params {
  const float* bias;   // [B, L] key bias in log2 units, or null
  const int* seg;      // [B, L] segment ids (-1 on padding), or null
  const float* lse;    // [B, H, L] base 2, from the forward
  float* delta;        // [B, H, L] rowsum(dO * O): written by dq, read by dk/dv
  __nv_bfloat16* qr;   // [B, L, H*D] bf16(rot(q) * q_pre): written by dq
  __nv_bfloat16* dq;   // [B, L, H*D]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int L, H, D;
  float q_pre;         // bf16(log2(e) / sqrt(D)), the forward's pre-scale of q
  float dq_scale;      // 1 / sqrt(D)
  float dk_scale;      // 1 / log2(e): q_r's log2(e) back out
  bool rotary;         // cos / sin tables given
};

// A [TILE][DP] bf16 tile in shared memory, as TMA writes it: row r is RB =
// 2 DP bytes, and its 16-byte chunk c lands at chunk c ^ swz(r).
template <int DP>
struct Tile {
  static_assert(DP == 32 || DP == 64, "32- or 64-column tiles");
  static constexpr int RB = 2 * DP;
  static constexpr int BYTES = TILE * RB;
  static constexpr int SBO = 8 * RB;  // 8-row groups, for wgmma
  static constexpr CUtensorMapSwizzle SWIZZLE =
      DP == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static __device__ __forceinline__ int swz(int r) { return ((r * RB) >> 7) & (RB / 16 - 1); }
  // byte offset of column `col` of row `r` (col % 8 + the columns that
  // follow it up to the chunk's end are contiguous)
  static __device__ __forceinline__ int off(int r, int col) {
    return r * RB + (((col >> 3) ^ swz(r)) << 4) + (col & 7) * 2;
  }
};

// The tensor map of a [B, L, H*D] projection (or, with H = B = 1 and row
// stride D, of an [L, D] rotary table), in tiles of TILE rows x DP columns.
template <int DP>
int tile_map(CUtensorMap* map, const void* base, int D, int L, int H, int B) {
  const long long hd = (long long)H * D;
  return rows_map(map, base, D, L, H, B, hd, D, L * hd, TILE, DP, Tile<DP>::SWIZZLE);
}

// ---- the skip rule (segment_tiles.cuh) ----------------------------------------

using segtiles::Range;
using segtiles::tiles_meet;

// The producer warp's range of tile j (ids at rows j*TILE + lane and + 32).
__device__ __forceinline__ Range tile_range(int id0, int id1, int j, int L, int lane) {
  const int r0 = j * TILE + lane, r1 = r0 + 32;
  const bool in0 = r0 < L, in1 = r1 < L;
  const bool real0 = in0 && id0 != -1, real1 = in1 && id1 != -1;
  Range t;
  t.lo = __reduce_min_sync(0xffffffffu, min(real0 ? id0 : INT_MAX, real1 ? id1 : INT_MAX));
  t.hi = __reduce_max_sync(0xffffffffu, max(real0 ? id0 : INT_MIN, real1 ? id1 : INT_MIN));
  t.pad = __any_sync(0xffffffffu, (in0 && id0 == -1) || (in1 && id1 == -1));
  return t;
}

// The producer warp writes into `list` the tiles of row `seg` (its L ids,
// or null: every tile) that meet tile `own`, in order, and returns their
// count (the same in every lane). The ids of 8 tiles are loaded at once.
__device__ __forceinline__ int build_list(const int* seg, int L, int own, int n_tiles,
                                          int* list, int lane) {
  if (seg == nullptr) {
    for (int j = lane; j < n_tiles; j += 32) list[j] = j;
    __syncwarp();
    return n_tiles;
  }
  auto id_at = [&](int r) { return r < L ? seg[r] : 0; };
  const Range mine =
      tile_range(id_at(own * TILE + lane), id_at(own * TILE + lane + 32), own, L, lane);
  int count = 0;
  for (int j0 = 0; j0 < n_tiles; j0 += 8) {
    int ids[8][2];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ids[u][0] = id_at((j0 + u) * TILE + lane);
      ids[u][1] = id_at((j0 + u) * TILE + lane + 32);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u;
      if (j < n_tiles && tiles_meet(mine, tile_range(ids[u][0], ids[u][1], j, L, lane))) {
        if (lane == 0) list[count] = j;
        ++count;
      }
    }
  }
  __syncwarp();
  return count;
}

// ---- rotary -------------------------------------------------------------------

// The same 4 columns of a head's two halves, lo and hi (4 bf16 each), to
// rot: (lo, hi) <- (lo cos_lo - hi sin_lo, hi cos_hi + lo sin_hi) in bf16
// arithmetic, x cos, rotate_half(x) sin and their sum each rounded once, as
// `_apply_rot` computes on bf16 arrays (on the low half rotate_half(x) sin
// is -(hi sin_lo): rounding to nearest is symmetric about 0).
__device__ __forceinline__ void rot4(uint2& lo, uint2& hi, uint2 cl, uint2 ch, uint2 sl,
                                     uint2 sh) {
  const uint2 a = lo, b = hi;
  lo.x = bf2_sub(bf2_mul(a.x, cl.x), bf2_mul(b.x, sl.x));
  lo.y = bf2_sub(bf2_mul(a.y, cl.y), bf2_mul(b.y, sl.y));
  hi.x = bf2_add(bf2_mul(b.x, ch.x), bf2_mul(a.x, sh.x));
  hi.y = bf2_add(bf2_mul(b.y, ch.y), bf2_mul(a.y, sh.y));
}

// In place on the TILE rows of a landed tile `x`, by the consumer
// warpgroup (thread `tid`): x <- rot(x) * mul with the tables' rows in tiles `cs`,
// `sn` of the same layout, or x <- x * mul without them (`scaled`: times
// `mul2`, two bf16 copies of mul; else no product). Every product and sum is
// rounded to bf16, as the TPU kernels' bf16 arithmetic rounds it
// (`_apply_rot`, then `q * jnp.asarray(scale * log2e, bf16)`) and as
// `flash_mha.rotated_qk` does: x cos, rotate_half(x) sin, their sum and the
// product with q_pre, each once. So q_r and rot(k) match the plain version
// bit for bit. Column i pairs with i + D/2; a 4-column group never
// straddles a 16-byte chunk (D is a multiple of 8). Columns past D stay as
// they are.
template <int DP>
__device__ __forceinline__ void rotate_rows(uint8_t* x, const uint8_t* cs, const uint8_t* sn,
                                            int D, bool rotary, bool scaled, uint32_t mul2,
                                            int tid) {
  using T = Tile<DP>;
  const int half = D / 2;
  if (rotary) {
    const int groups = half / 4;
    for (int i = tid; i < TILE * groups; i += CONSUMERS) {
      const int r = i / groups, col = (i % groups) * 4;
      const int lo_off = T::off(r, col), hi_off = T::off(r, col + half);
      uint2 nlo = *reinterpret_cast<const uint2*>(x + lo_off);
      uint2 nhi = *reinterpret_cast<const uint2*>(x + hi_off);
      rot4(nlo, nhi, *reinterpret_cast<const uint2*>(cs + lo_off),
           *reinterpret_cast<const uint2*>(cs + hi_off), *reinterpret_cast<const uint2*>(sn + lo_off),
           *reinterpret_cast<const uint2*>(sn + hi_off));
      if (scaled) {
        nlo.x = bf2_mul(nlo.x, mul2);
        nlo.y = bf2_mul(nlo.y, mul2);
        nhi.x = bf2_mul(nhi.x, mul2);
        nhi.y = bf2_mul(nhi.y, mul2);
      }
      *reinterpret_cast<uint2*>(x + lo_off) = nlo;
      *reinterpret_cast<uint2*>(x + hi_off) = nhi;
    }
  } else if (scaled) {
    const int groups = D / 4;
    for (int i = tid; i < TILE * groups; i += CONSUMERS) {
      const int r = i / groups, col = (i % groups) * 4;
      uint2* p = reinterpret_cast<uint2*>(x + T::off(r, col));
      uint2 v = *p;
      v.x = bf2_mul(v.x, mul2);
      v.y = bf2_mul(v.y, mul2);
      *p = v;
    }
  }
}

// q_pre (a bf16 value, passed as f32) in both halves of a bf16x2 word
__device__ __forceinline__ uint32_t bf2_splat(float x) { return pack_bf16(x, x); }

// ---- epilogues ------------------------------------------------------------------

// A 64 x DP f32 accumulator of the consumer warpgroup (wgmma layout), times
// `mul`, into g_s [TILE][DP] f32.
template <int DP>
__device__ __forceinline__ void stage_acc(float* g_s, const float (&acc)[DP / 2], int tid,
                                          float mul) {
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      g_s[(16 * warp + g + 8 * (e >> 1)) * DP + 8 * j + 2 * t + (e & 1)] = acc[4 * j + e] * mul;
}

// Rows [row0, row0 + TILE) of a gradient in the rotated frame (g_s) to the
// input frame, R^T g = g cos - rotate_half(g) sin (the tables' rows in tiles
// `cs`, `sn`), or as it is without tables; bf16 into `out`, the head's
// first column of row 0 of a [*, H*D] tensor. Rows past L are not written.
template <int DP>
__device__ __forceinline__ void write_back(__nv_bfloat16* out, const float* g_s, const uint8_t* cs,
                                           const uint8_t* sn, const Params& p, int row0, int tid) {
  const int half = p.D / 2;
  const long long hd = (long long)p.H * p.D;
  for (int i = tid; i < TILE * half; i += CONSUMERS) {
    const int r = i / half, c = (i % half) * 2;
    if (row0 + r >= p.L) continue;
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c + e;
      const float gv = g_s[r * DP + col];
      if (p.rotary) {
        const int o = Tile<DP>::off(r, col);
        const float cv = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(cs + o));
        const float sv = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(sn + o));
        x[e] = col < half ? gv * cv + g_s[r * DP + col + half] * sv
                          : gv * cv - g_s[r * DP + col - half] * sv;
      } else {
        x[e] = gv;
      }
    }
    *reinterpret_cast<uint32_t*>(out + (row0 + r) * hd + c) = pack_bf16(x[0], x[1]);
  }
}

// A 64 x DP f32 accumulator (wgmma layout) as bf16 rows row0.. of `out` (as
// in write_back), no rotation: dv.
template <int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[DP / 2],
                                          const Params& p, int row0, int tid) {
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long hd = (long long)p.H * p.D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= p.D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * warp + g + 8 * h;
      if (row < p.L)
        *reinterpret_cast<uint32_t*>(out + row * hd + col) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// m64nDPk16, A from registers, B MN-major: the products over the streamed
// rows (dS k, p^T dO, dS^T q_r).
template <int DP>
__device__ __forceinline__ void wgmma_rs_tb_dp(float (&d)[DP / 2], const uint32_t (&a)[4],
                                               uint64_t db) {
  if constexpr (DP == 32)
    wgmma_rs_m64n32_tb(d, a, db, 1);
  else
    wgmma_rs_m64n64_tb(d, a, db, 1);
}

}  // namespace mha_bwd
