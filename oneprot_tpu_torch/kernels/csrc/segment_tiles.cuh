// The skip rule of packed rows, shared by the attention kernels that take
// segment ids: the flash-MHA forward and backward (flash_mha_fwd.cu,
// flash_mha_bwd.cuh) and the FlashAttention-2 forward and backward
// (flash_attention_fwd.cu, flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu). A CTA's own block of rows and a streamed tile
// of rows are visited together when both hold padding (id -1) or when the
// ranges [min, max] of their other ids intersect: disjoint ranges share no
// id, so no pair of equal ids is dropped, whatever the order of the ids
// (flash_mha.segment_tile_hits states the same rule in PyTorch). The
// visited tiles come as a list (build_list) or, where shared memory is
// short (the dq pass at heads of 256), a bitmap (build_mask).

#pragma once

#include <limits.h>
#include <stdint.h>

namespace segtiles {

// Ids of a block of rows: the least and greatest other than -1, and whether
// one is -1 (padding). Rows past L count as neither.
struct Range {
  int lo, hi;
  bool pad;
};

__device__ __forceinline__ bool tiles_meet(const Range& a, const Range& b) {
  return (a.pad && b.pad) || (a.lo <= b.hi && b.lo <= a.hi);
}

// The range of rows [r0, r0 + ROWS) of a packed row, ROWS / 32 ids a lane
// (`ids[u]` is row r0 + lane + 32u), reduced over the warp.
template <int ROWS>
__device__ __forceinline__ Range span(const int (&ids)[ROWS / 32], int r0, int L, int lane) {
  int lo = INT_MAX, hi = INT_MIN;
  bool pad = false;
#pragma unroll
  for (int u = 0; u < ROWS / 32; ++u) {
    if (r0 + lane + 32 * u >= L) continue;
    if (ids[u] == -1) {
      pad = true;
    } else {
      lo = min(lo, ids[u]);
      hi = max(hi, ids[u]);
    }
  }
  Range t;
  t.lo = __reduce_min_sync(0xffffffffu, lo);
  t.hi = __reduce_max_sync(0xffffffffu, hi);
  t.pad = __any_sync(0xffffffffu, pad);
  return t;
}

// One warp calls hit(j, n) for each tile j of BK rows of row `seg` (its L
// ids) that meets the block of OWN rows at `own0`, in order (n: how many
// met before it), in every lane, and returns their count. The ids of 256 /
// BK tiles are loaded at once.
template <int OWN, int BK, typename Hit>
__device__ __forceinline__ int scan_tiles(const int* seg, int L, int own0, int n_tiles,
                                          int lane, Hit hit) {
  auto id_at = [&](int r) { return r < L ? seg[r] : 0; };
  int own[OWN / 32];
#pragma unroll
  for (int u = 0; u < OWN / 32; ++u) own[u] = id_at(own0 + lane + 32 * u);
  const Range mine = span<OWN>(own, own0, L, lane);
  constexpr int U = 256 / BK;
  int count = 0;
  for (int j0 = 0; j0 < n_tiles; j0 += U) {
    int ids[U][BK / 32];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) ids[u][e] = id_at((j0 + u) * BK + lane + 32 * e);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      if (j < n_tiles && tiles_meet(mine, span<BK>(ids[u], j * BK, L, lane))) {
        hit(j, count);
        ++count;
      }
    }
  }
  return count;
}

// One warp writes into `list` the tiles of BK rows of row `seg` (its L ids,
// or null: every tile) that meet the block of OWN rows at `own0`, in order,
// and returns their count (the same in every lane).
template <int OWN, int BK>
__device__ __forceinline__ int build_list(const int* seg, int L, int own0, int n_tiles,
                                          int* list, int lane) {
  if (seg == nullptr) {
    for (int j = lane; j < n_tiles; j += 32) list[j] = j;
    __syncwarp();
    return n_tiles;
  }
  const int count = scan_tiles<OWN, BK>(seg, L, own0, n_tiles, lane, [&](int j, int n) {
    if (lane == 0) list[n] = j;
  });
  __syncwarp();
  return count;
}

// The same tiles as a bitmap, 1 bit a tile where `list` takes 4 bytes: bit
// j % 32 of mask[j / 32] is set for each tile j that is visited.
template <int OWN, int BK>
__device__ __forceinline__ int build_mask(const int* seg, int L, int own0, int n_tiles,
                                          uint32_t* mask, int lane) {
  for (int w = lane; 32 * w < n_tiles; w += 32) {
    const int n = min(n_tiles - 32 * w, 32);  // the tiles of word w
    mask[w] = seg != nullptr ? 0u : n == 32 ? ~0u : (1u << n) - 1u;
  }
  __syncwarp();
  if (seg == nullptr) return n_tiles;
  const int count = scan_tiles<OWN, BK>(seg, L, own0, n_tiles, lane, [&](int j, int) {
    if (lane == 0) mask[j / 32] |= 1u << (j % 32);
  });
  __syncwarp();
  return count;
}

}  // namespace segtiles
