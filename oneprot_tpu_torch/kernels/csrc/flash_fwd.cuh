// The Hopper mainloop of the two attention forwards, the FlashAttention-2
// forward (flash_attention_fwd.cu) and the flash-MHA forward
// (flash_mha_fwd.cu): one query tile of BQ = 128 rows in shared memory, key
// tiles streamed through a ring of mbarrier-guarded stages, S = Q K^T, an
// online exp2 softmax in f32 registers, O += P V and a base-2 lse.
//
// A CTA has three warpgroups: warp 0 of warpgroup 0 loads with TMA (its
// other warps give their registers away and leave), warpgroups 1 and 2
// each own 64 query rows (`attend`). S is an SS wgmma (Q and K both from
// shared memory, K-major); P is packed to bf16 in registers as the A
// operand of O += P V, whose V is read MN-major (wgmma's transposed B).
// Only the fresh P is a register operand: Q stays in shared memory.
//
// Head layouts (`Head<DP>`): DP = 32 is one block of 32 columns in 64-byte
// rows (64-byte swizzle: a head of 24 pads to 32, not 64); DP = 64, 128 and
// 256 are one, two or four blocks of 64 columns in 128-byte rows (128-byte
// swizzle); see hopper.cuh. TMA writes them, zero-filling rows past L and
// columns past the head dim. At DP = 256 the O accumulator is 128 registers
// a consumer thread and P V one m64n256k16 a key-step.

#pragma once

#include "hopper.cuh"

namespace fwd {

using namespace hopper;

constexpr int BQ = 128;       // query rows of a CTA, 64 per consumer warpgroup
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 compute
constexpr int CONSUMERS = 256;
// named barriers 4 and 5: consumer warpgroup 0's and 1's turn to issue
// their products (the other kernels' barriers take 1-3)
constexpr int BAR_TURN = 4;
constexpr float ROW_MAX0 = -1e30f;  // the TPU kernels' starting row max

template <int DP>
struct Head {
  static_assert(DP == 32 || DP == 64 || DP == 128 || DP == 256,
                "heads of 32, 64, 128 or 256 columns");
  static constexpr int RB = DP == 32 ? 64 : 128;   // bytes of a row of a block
  static constexpr int NB = DP == 32 ? 1 : DP / 64;  // blocks of the head
  static constexpr int BOX_COLS = RB / 2;         // columns of a block (a TMA box)
  static constexpr int KPB = RB / 32;             // 16-column k-steps of a block
  static constexpr CUtensorMapSwizzle SWIZZLE =
      DP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  // bytes of a tile of `rows` rows (NB blocks of rows x RB)
  static constexpr __host__ __device__ int bytes(int rows) { return NB * rows * RB; }
  // The descriptor of an operand read K-major (the head dim is the
  // reduction) from a tile whose block 0 holds the operand's first row at
  // shared address `addr`; k-step kk of it is `kstep<rows>(desc, kk)`.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
    return desc_sw<RB>(addr, 16, 8 * RB);
  }
  template <int ROWS>
  static __device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk) {
    // the start address (bits 0-13, in 16-byte units) moves; shared
    // addresses stay below 256 KB, so the field never carries over
    return desc + (((kk / KPB) * ROWS * RB + (kk % KPB) * 32) >> 4);
  }
  // The descriptor of a [ROWS][DP] operand at `addr` read MN-major (the
  // rows are the reduction, the head dim is N); key-step kk (16 rows) of it
  // is `desc + kk * 16 * RB / 16`.
  template <int ROWS>
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
    return desc_sw<RB>(addr, ROWS * RB, 8 * RB);
  }
  static constexpr int MN_STEP = RB;  // key-step of an MN-major descriptor, 16 B units
};

// S (64 x N) = A B^T + (scale_d ? S : 0) over one k-step, both operands
// from shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "key tiles of 64 or 128");
  if constexpr (N == 64)
    wgmma_ss_m64n64(d, da, db, scale_d);
  else
    wgmma_ss_m64n128(d, da, db, scale_d);
}

// O (64 x DP) += P B over one key-step, P from registers, B MN-major
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 32)
    wgmma_rs_m64n32_tb(d, a, db, 1);
  else if constexpr (DP == 64)
    wgmma_rs_m64n64_tb(d, a, db, 1);
  else if constexpr (DP == 128)
    wgmma_rs_m64n128_tb(d, a, db, 1);
  else
    wgmma_rs_m64n256_tb(d, a, db, 1);
}

// Wait for a phase of the ring: trapping after 10 s at heads up to 128; at
// DP = 256 without the trap, which would hold the consumers to 168 registers
// (hopper.cuh: mbar_wait_or_trap) where O alone takes 128.
template <int DP>
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
  if constexpr (DP == 256)
    mbar_wait(bar, parity);
  else
    mbar_wait_or_trap(bar, parity);
}

// The key tiles of a ring of ST stages in shared memory: tile `it` is in
// stage it % ST, K at `k_addr + s * stage_bytes`, V `v_off` bytes after it.
// A split ring (`attend`'s SPLIT) guards K and V by barriers of their own:
// `ready` and `empty` are K's, `v_ready` and `v_empty` V's, so K's half of
// a stage is refilled as soon as its S and logits are done, a tile before V's.
struct Ring {
  uint32_t k_addr;
  int stage_bytes, v_off;
  uint64_t* ready;  // [ST]: the stage's tile may be read
  uint64_t* empty;  // [ST]: every consumer thread is done with the stage
  uint64_t* v_ready;  // [ST], split rings only
  uint64_t* v_empty;
};

// Issue S = Q K^T (64 x BK, f32) for the consumer's rows of Q (at q_addr,
// in a tile of BQ rows) and the K tile at k_addr, one k-step a wgmma.
template <int DP, int BK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint64_t q_desc, uint32_t k_addr) {
  using Hd = Head<DP>;
  const uint64_t k_desc = Hd::kmajor(k_addr);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<BK>(sc, Hd::template kstep<BQ>(q_desc, kk), Hd::template kstep<BK>(k_desc, kk), kk);
  wgmma_commit();
}

// A consumer warpgroup's pass over `count` key tiles of BK keys: its 64
// query rows (at shared address q_addr, in a tile of BQ rows) against each
// tile, online. `logits(sc, s)` turns the raw products of the tile in stage
// s into base-2 logits in place (bias, masks; -inf for keys past the end).
// Returns the unnormalised output o (wgmma accumulator layout: o[4j + e] is
// row r_a = 16 warp + lane / 4 (e < 2) or r_a + 8, column 8j + 2t + (e & 1),
// t = lane % 4), and each of the thread's two rows' max m and partial sum
// l (this thread's columns only; `finish` sums the quad).
//
// Per tile: wait for the stage; S (issued at the end of the previous tile)
// completes; the previous tile's P V has completed too, so its stage is
// released; softmax; O *= corr; O += P V is issued; the next tile's S is
// issued behind it, so the tensor cores go from one to the other. The two
// consumer warpgroups take turns to issue their products (FA-3's
// ping-pong: a named barrier each, 256 threads, warpgroup 0 first), so one
// computes its softmax while the other's products run. SPLIT (a split
// Ring): K's half of the stage is released once the tile's logits are
// read, V's once its P V has completed, and P V waits for V alone.
template <int DP, int BK, int ST, bool SPLIT = false, typename Logits>
__device__ __forceinline__ void attend(float (&o)[DP / 2], float (&m)[2], float (&l)[2],
                                       uint32_t q_addr, const Ring& ring, int count,
                                       Logits logits) {
  using Hd = Head<DP>;
  constexpr int PS = BK / 16;  // key-steps of P V
  float sc[BK / 2];
  uint32_t pa[PS][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  fence_regs(o);  // sunk into the first S's wgmma stage, this zeroing made ptxas serialise
  m[0] = m[1] = ROW_MAX0;
  l[0] = l[1] = 0.f;
  if (count == 0) return;

  const uint64_t q_desc = Hd::kmajor(q_addr);
  const int wg = threadIdx.x / 128 - 1;  // this consumer warpgroup, 0 or 1
  if (wg == 1) named_bar_arrive(BAR_TURN, CONSUMERS);
  ring_wait<DP>(&ring.ready[0], 0);
  issue_s<DP, BK>(sc, q_desc, ring.k_addr);
  for (int it = 0; it < count; ++it) {
    const int s = it % ST;
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(o);
    if constexpr (SPLIT) {
      if (it > 0) mbar_arrive(&ring.v_empty[(it - 1) % ST]);
      logits(sc, s);
      mbar_arrive(&ring.empty[s]);  // K and the tile's bias are read
    } else {
      if (it > 0) mbar_arrive(&ring.empty[(it - 1) % ST]);
      logits(sc, s);
    }

    // online softmax over the tile, in base 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      corr[h] = fast_exp2(m[h] - mn);
      m[h] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = fast_exp2(sc[4 * j + e] - m[e >> 1]);
        sum[e >> 1] += sc[4 * j + e];
      }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
    // O *= corr, skipped when no row of the warp found a larger max
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
    }

    // O += bf16(P) V. The rescaled O and the packed P are pinned before
    // wgmma.fence: a write to an accumulator that the compiler sank past it
    // would make ptxas serialise every wgmma of the kernel.
    a_operand(pa, sc);
    fence_regs(o);
    fence_regs(pa);
    const uint64_t v_desc =
        Hd::template mnmajor<BK>(ring.k_addr + s * ring.stage_bytes + ring.v_off);
    if constexpr (SPLIT) ring_wait<DP>(&ring.v_ready[s], (it / ST) & 1);
    named_bar_sync(BAR_TURN + wg, CONSUMERS);  // this warpgroup's turn
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PS; ++kk) wgmma_pv<DP>(o, pa[kk], v_desc + kk * Hd::MN_STEP);
    wgmma_commit();
    if (it + 1 < count) {
      ring_wait<DP>(&ring.ready[(it + 1) % ST], ((it + 1) / ST) & 1);
      issue_s<DP, BK>(sc, q_desc, ring.k_addr + ((it + 1) % ST) * ring.stage_bytes);
    }
    // the other's turn (warpgroup 1's last arrival would find no one waiting)
    if (wg == 0 || it + 1 < count) named_bar_arrive(BAR_TURN + 1 - wg, CONSUMERS);
  }
  wgmma_wait<0>();
  fence_regs(o);
  if constexpr (SPLIT)
    mbar_arrive(&ring.v_empty[(count - 1) % ST]);
  else
    mbar_arrive(&ring.empty[(count - 1) % ST]);
}

// The end of `attend` for the thread's two rows: the quad's partial sums
// added and clamped at 1e-30 (a row whose keys are all masked stays
// finite); inv = 1 / l and lse = m + log2(l), base 2.
__device__ __forceinline__ void finish(const float (&m)[2], float (&l)[2], float (&inv)[2],
                                       float (&lse)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / l[h];
    lse[h] = m[h] + log2f(l[h]);
  }
}

}  // namespace fwd
