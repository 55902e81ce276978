// Tied-row attention of the MSA Transformer, forward only, in the
// [B, R, L, H*D] layout of the q/k/v projections, for heads of D = 16, 32
// or 64 (one instance each; the launcher zero-pads other widths to the next
// instance).
//
// Replaces: oneprot_tpu/kernels/tied_row_attention.py:_kernel (launched by
// tied_row_attention). Same function: one attention map per (batch, head)
// shared by all R rows of the MSA,
//   logits[i, j] = scale * sum_r q[r, i, :] . k[r, j, :] + bias[j]
//   out[r, i, :] = sum_j softmax_j(logits)[i, j] * v[r, j, :],
// logits in f32, an online softmax in base 2 (scale and bias come in log2
// units), out in bf16. As in the TPU kernel, each 128-key tile's
// probabilities are rounded to bf16 against the running row max of that
// tile, p = bf16(2^(s - m_t)), and the output is rescaled tile by tile and
// divided by the row sum at the end; the plain version rounds the
// normalised softmax instead. Both sit well inside the 1.5e-2 gate. No
// [B, H, L, L] tensor goes to device memory. (The TPU kernel takes D = 64
// only; the JAX package runs narrower heads through its einsum path.)
//
// What bounds it on H100: 4 * L^2 * R * D flops per (batch, head) against
// 4 * R * L * D * 2 bytes of q/k/v/out, so the card's bound is tensor-core
// operations (0.21 ms at B=4 R=16 L=1024 H=12 D=64). In the way of it: the
// tied sum makes this attention's head R*D wide (1024 at R=16 D=64, 800 at
// R=50 D=16), so neither q nor the f32 output of a query block stays on
// chip, and every CTA streams its head's q (once per key tile), k and v
// through shared memory, ~5 MB at R=16 L=1024 D=64, beside a probability
// strip of up to 128 KB. How many bytes the ring keeps in flight, more than
// the tensor cores or L2's bandwidth, sets the pace (measured on an H100:
// with no product at all the kernel keeps ~88% of its time, and halving
// L2's reads of k and v by TMA multicast between two CTAs gained under 3%).
//
// Design (sm_90a): one CTA of 160 threads per (block of 64 query columns,
// head, batch), for L <= 1024 (the model's max_positions). Warp 4 loads
// with TMA (4-D tensor maps over [B, R, L, H*D], boxes of D columns, a
// swizzle of 2D bytes: 128 at D = 64, 64 at 32, 32 at 16) into a ring of
// 24 KB stages guarded by mbarriers, as deep as shared memory allows beside
// the strip (4 stages at L = 1024, 6 at L <= 640); warps 0-3 are one
// consumer warpgroup that owns the 64 query rows. Every instance moves the
// same 24 KB an item, so a narrow head takes several MSA rows an item
// rather than more items of fewer bytes, each with its own barrier round.
//   1. Logits. For each 128-key tile, S[64, 128] accumulates in registers
//      over the R MSA rows by SS wgmma (m64n128k16, D / 16 k-steps a row,
//      q_r and k_r both K-major from the ring; one ring item = q's 64 rows
//      and k's 128 keys of RB = 64 / D MSA rows, one TMA box each, rows past
//      R zero-filled). The tile's online softmax follows (its key bias
//      loaded from global memory before the tile's products): the running
//      max m, the running sum l, the tile's rescale factor 2^(m_old - m),
//      and P = bf16(2^(s - m)) into a [64, L] bf16 strip in shared memory
//      (128 KB at L = 1024, [64][64] blocks swizzled as wgmma reads them;
//      then fence.proxy.async). Keys past L take -inf by index (TMA's zero
//      fill is no mask).
//   2. Output. For each group of G = 192 / D MSA rows (3 at D = 64, 12 at
//      16), O[64, 192] accumulates in registers over the key tiles by SS
//      wgmma (m64n192k16): P from the strip (K-major), v of the G rows from
//      the ring (one TMA box of 64 keys x D columns x G rows, read
//      MN-major), O scaled by each tile's factor before its product
//      (skipped where it is 1 on every row of a warp); then O / l to bf16.
//      The strip is read R / G times.
// Key tiles whose every key carries a bias SKIP_GAP (1e6, natural units)
// or more below the batch element's largest bias are not visited: with
// |scale * sum_r q . k| below 4e5 their softmax weight is exactly 0 in
// f32, so the result is the same (the MSA columns padded to a bucket carry
// -1e9). An element whose keys are all padded skips nothing, so its rows
// still average over every key, as in the plain version.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;          // query columns of a CTA: the warpgroup's wgmma rows
constexpr int BK = 128;         // keys of a logit tile
constexpr int HK = 64;          // keys of an output item (half a tile)
constexpr int ON = 192;         // columns of O: G MSA rows of D
constexpr int Q_BYTES = BQ * 128;
constexpr int K_BYTES = BK * 128;
constexpr int STAGE_BYTES = Q_BYTES + K_BYTES;  // a logit item; an output item is ON * HK * 2
constexpr int P_BLOCK = BQ * 128;     // [64 rows][64 keys] bf16 of the strip
constexpr int MAX_L = 1024;
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;  // warps 0-3 compute, warp 4 loads
constexpr float ROW_MAX0 = -1e30f;       // the TPU kernel's starting row max
constexpr float SKIP_GAP = 1e6f * 1.4426950408889634f;  // in log2 units
static_assert(ON * HK * 2 == STAGE_BYTES, "both kinds of item fill a stage");
static_assert(MAX_L / BK <= 8, "the quads keep rescale factors of at most 8 tiles");

// The layout of an instance's items for heads of D: rows of SW = 2D bytes
// (the swizzle span), RB MSA rows of q and k a logit item, G a value item.
template <int D>
struct Heads {
  static_assert(D == 16 || D == 32 || D == 64, "an instance for heads of 16, 32 or 64");
  static constexpr int SW = 2 * D;
  static constexpr int RB = 64 / D;    // MSA rows of a logit item
  static constexpr int KS = D / 16;    // k-steps of one MSA row's q . k
  static constexpr int G = ON / D;     // MSA rows of an output item
  static constexpr int Q_ROW = BQ * SW;  // bytes of one MSA row's q box
  static constexpr int K_ROW = BK * SW;
  static constexpr int V_ROW = HK * SW;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static_assert(RB * Q_ROW == Q_BYTES && RB * K_ROW == K_BYTES && G * V_ROW == STAGE_BYTES,
                "every instance's items fill a stage");
};

// Shared memory from a 1024-aligned base, for n_kt key tiles and ST stages:
// the ring, the P strip, the barriers.
__host__ __device__ constexpr int p_off(int st) { return st * STAGE_BYTES; }
__host__ __device__ constexpr int bars_off(int st, int n_kt) { return p_off(st) + n_kt * 2 * P_BLOCK; }
__host__ __device__ constexpr int smem_bytes(int st, int n_kt) {
  return bars_off(st, n_kt) + 2 * st * 8 + 1024;  // + alignment slack
}
// the deepest ring that fits beside the strip of n_kt tiles, of 4 to 6
// stages (a seventh gained ~3% at L = 384)
constexpr int stages_for(int n_kt) { return n_kt >= 7 ? 4 : n_kt == 6 ? 5 : 6; }
static_assert(smem_bytes(stages_for(8), 8) <= 232448 && smem_bytes(stages_for(6), 6) <= 232448 &&
                  smem_bytes(stages_for(5), 5) <= 232448,
              "each ring fits beside its strip");

struct Params {
  const float* bias;   // [B, L] log2 units, or null
  __nv_bfloat16* out;  // [B, R, L, H*D]
  int R, L, H;
  float qk_scale;      // scale * log2(e)
};

struct alignas(64) Args {
  CUtensorMap q;  // boxes of D columns x BQ rows x RB MSA rows
  CUtensorMap k;  // D columns x BK rows x RB MSA rows
  CUtensorMap v;  // D columns x HK rows x G MSA rows
  Params p;
};

// The key tiles that batch element's query rows visit, as a bit mask (bit
// kt: keys kt * BK ..), the same in every warp that computes it.
__device__ __forceinline__ uint32_t live_tiles(const float* bias, int L, int n_kt) {
  const uint32_t all = (1u << n_kt) - 1;
  if (bias == nullptr) return all;
  const int lane = threadIdx.x % 32;
  float mx = -INFINITY;
  for (int j = lane; j < L; j += 32) mx = fmaxf(mx, bias[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float dead_at = mx - SKIP_GAP;  // a key at or below this weighs 0
  uint32_t live = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    bool any = false;
#pragma unroll
    for (int e = 0; e < BK / 32; ++e) {
      const int j = kt * BK + lane + 32 * e;
      any |= j < L && bias[j] > dead_at;
    }
    if (__any_sync(0xffffffffu, any)) live |= 1u << kt;
  }
  return live != 0 ? live : all;
}

// Warp 4: the ring's items in the consumers' order. Logits: per live tile,
// per RB MSA rows, q's 64 rows and k's 128 keys. Output: per group of G MSA
// rows, per live tile, v of each 64-key half that starts before L.
template <int D, int ST>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, uint32_t live, int q0,
                                         int h, int b) {
  using S = Heads<D>;
  const Params& p = a.p;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + bars_off(ST, (p.L + BK - 1) / BK));
  uint64_t* empty = full + ST;
  const int lane = threadIdx.x % 32;
  int item = 0;
  auto acquire = [&](int bytes) -> uint8_t* {
    const int s = item % ST;
    mbar_wait_or_trap(&empty[s], ((item / ST) & 1) ^ 1);
    if (lane == 0)
      mbar_arrive_expect_tx(&full[s], bytes);
    else
      mbar_arrive(&full[s]);
    return sm + s * STAGE_BYTES;
  };
  for (uint32_t rest = live; rest != 0; rest &= rest - 1) {
    const int kt = __ffs(rest) - 1;
    for (int r = 0; r < p.R; r += S::RB, ++item) {
      uint8_t* st = acquire(STAGE_BYTES);
      if (lane == 0) {
        tma_load_4d(st, &a.q, &full[item % ST], D * h, q0, r, b);
        tma_load_4d(st + Q_BYTES, &a.k, &full[item % ST], D * h, kt * BK, r, b);
      }
    }
  }
  for (int g0 = 0; g0 < p.R; g0 += S::G) {
    for (uint32_t rest = live; rest != 0; rest &= rest - 1) {
      const int kt = __ffs(rest) - 1;
      for (int k0 = kt * BK; k0 < kt * BK + BK && k0 < p.L; k0 += HK, ++item) {
        uint8_t* st = acquire(STAGE_BYTES);
        if (lane == 0) tma_load_4d(st, &a.v, &full[item % ST], D * h, k0, g0, b);
      }
    }
  }
}

// Warps 0-3: the logits and softmax of every live tile into the P strip,
// then the output, G MSA rows at a time.
template <int D, int ST>
__device__ __forceinline__ void consumer(const Args& a, uint8_t* sm, uint32_t live, int q0,
                                         int h, int b) {
  using S = Heads<D>;
  const Params& p = a.p;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + bars_off(ST, (p.L + BK - 1) / BK));
  uint64_t* empty = full + ST;
  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const uint32_t ring = smem_u32(sm);
  const uint32_t strip = smem_u32(sm + p_off(ST));
  int item = 0;

  // ---- logits and softmax, tile by tile --------------------------------
  float m[2] = {ROW_MAX0, ROW_MAX0}, l[2] = {0.f, 0.f};
  // the rescale factor 2^(m_old - m_new) of live tile i for the thread's two
  // rows, kept by lane i % 4 of the quad that shares the rows
  float c_lo[2] = {1.f, 1.f}, c_hi[2] = {1.f, 1.f};
  int n_live = 0;
  for (uint32_t rest = live; rest != 0; rest &= rest - 1, ++n_live) {
    const int kt = __ffs(rest) - 1;
    // the key bias of the thread's columns 8j + 2t (+1), in flight during
    // the tile's products; keys past L at -inf
    float bb[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * BK + 8 * j + 2 * t + e;
        bb[2 * j + e] = key < p.L ? (bias == nullptr ? 0.f : __ldg(bias + key)) : -INFINITY;
      }
    float sc[BK / 2];
    for (int r = 0; r < p.R; r += S::RB, ++item) {
      const int s = item % ST;
      mbar_wait_or_trap(&full[s], (item / ST) & 1);
      const uint32_t qa = ring + s * STAGE_BYTES;
      const uint64_t qd = desc_sw<S::SW>(qa, 16, 8 * S::SW);
      const uint64_t kd = desc_sw<S::SW>(qa + Q_BYTES, 16, 8 * S::SW);
      fence_regs(sc);
      wgmma_fence();
      // MSA rows past R are TMA's zero fill: they add 0 to S
#pragma unroll
      for (int rr = 0; rr < S::RB; ++rr)
#pragma unroll
        for (int kk = 0; kk < S::KS; ++kk)
          wgmma_ss_m64n128(sc, qd + ((rr * S::Q_ROW) >> 4) + 2 * kk,
                           kd + ((rr * S::K_ROW) >> 4) + 2 * kk, r > 0 || rr > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous item's products are done: free its stage
      fence_regs(sc);
      if (r > 0) mbar_arrive(&empty[(item - 1) % ST]);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&empty[(item - 1) % ST]);

    // base-2 logits s * scale + bias, the tile's max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = fmaf(sc[4 * j + e], p.qk_scale, bb[2 * j + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      corr[hh] = fast_exp2(m[hh] - mn);
      m[hh] = mn;
    }
    if (t == (n_live & 3)) {
      if (n_live < 4) {
        c_lo[0] = corr[0];
        c_lo[1] = corr[1];
      } else {
        c_hi[0] = corr[0];
        c_hi[1] = corr[1];
      }
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
    // P of this tile into strip blocks 2 n_live (keys 0-63) and 2 n_live + 1:
    // row r's 16-byte chunk c at chunk c ^ (r % 8), as TMA's 128-byte swizzle
    // lays out the operands wgmma reads
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + lane / 4 + 8 * hh;
        *reinterpret_cast<__nv_bfloat162*>(sm + p_off(ST) + (2 * n_live + j / 8) * P_BLOCK +
                                           row * 128 + (((j % 8) ^ (row % 8)) << 4) + 4 * t) =
            __floats2bfloat162_rn(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]);
      }
  }
  fence_proxy_async();  // P, written here, is read by wgmma
  named_bar_sync(1, CONSUMERS);
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
  }

  // ---- the output, G MSA rows at a time ---------------------------------
  const size_t HD = (size_t)p.H * D;
  const int row_a = q0 + 16 * warp + lane / 4;
  for (int g0 = 0; g0 < p.R; g0 += S::G) {
    float o[ON / 2];
    int j = 0;  // this group's items
    int i = 0;  // live tile
    for (uint32_t rest = live; rest != 0; rest &= rest - 1, ++i) {
      const int kt = __ffs(rest) - 1;
      for (int hh = 0; hh < 2 && kt * BK + hh * HK < p.L; ++hh, ++item, ++j) {
        if (hh == 0 && i > 0) {
          // O *= tile i's factor, unless it is 1 on every row of the warp
          const int owner = (lane & ~3) | (i & 3);
          const float c0 = __shfl_sync(0xffffffffu, i < 4 ? c_lo[0] : c_hi[0], owner);
          const float c1 = __shfl_sync(0xffffffffu, i < 4 ? c_lo[1] : c_hi[1], owner);
          if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
            wgmma_wait<0>();
            fence_regs(o);
#pragma unroll
            for (int n = 0; n < ON / 8; ++n) {
              o[4 * n + 0] *= c0;
              o[4 * n + 1] *= c0;
              o[4 * n + 2] *= c1;
              o[4 * n + 3] *= c1;
            }
          }
        }
        const int s = item % ST;
        mbar_wait_or_trap(&full[s], (item / ST) & 1);
        const uint64_t pd = desc_sw<128>(strip + (2 * i + hh) * P_BLOCK, 16, 1024);
        const uint64_t vd = desc_sw<S::SW>(ring + s * STAGE_BYTES, S::V_ROW, 8 * S::SW);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HK / 16; ++kk)
          wgmma_ss_m64n192_tb(o, pd + 2 * kk, vd + ((16 * S::SW * kk) >> 4), j > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(o);
        if (j > 0) mbar_arrive(&empty[(item - 1) % ST]);
      }
    }
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[(item - 1) % ST]);
    // o[4n + e]: row row_a (+ 8 for e >= 2), column 8n + 2t + (e & 1) of the
    // group's G x D: MSA row g0 + 8n / D, head column (8n) % D + 2t
#pragma unroll
    for (int n = 0; n < ON / 8; ++n) {
      const int r = g0 + 8 * n / D;
      if (r < p.R) {
        __nv_bfloat16* orow =
            p.out + ((size_t)b * p.R + r) * p.L * HD + D * h + (8 * n) % D + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row_a + 8 * hh;
          if (row < p.L)
            *reinterpret_cast<__nv_bfloat162*>(orow + row * HD) = __floats2bfloat162_rn(
                o[4 * n + 2 * hh] * inv[hh], o[4 * n + 2 * hh + 1] * inv[hh]);
        }
      }
    }
  }
}

template <int D, int ST>
__global__ void __launch_bounds__(THREADS, 1)
    tied_row_attention_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const int n_kt = (a.p.L + BK - 1) / BK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + bars_off(ST, n_kt));
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + s, 32);              // full: the loader warp (+ TMA's bytes)
      mbar_init(bars + ST + s, CONSUMERS);  // empty: every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const uint32_t live =
      live_tiles(a.p.bias == nullptr ? nullptr : a.p.bias + (size_t)b * a.p.L, a.p.L, n_kt);
  if (threadIdx.x >= CONSUMERS)
    producer<D, ST>(a, sm, live, q0, h, b);
  else
    consumer<D, ST>(a, sm, live, q0, h, b);
}

template <int D, int ST>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = smem_bytes(ST, (a.p.L + BK - 1) / BK);
  const cudaError_t err = cudaFuncSetAttribute(
      tied_row_attention_kernel<D, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.p.L + BQ - 1) / BQ, a.p.H, B);
  tied_row_attention_kernel<D, ST><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run(const void* q, const void* k, const void* v, const void* bias, void* out, int B, int R,
        int L, int H, float qk_scale, cudaStream_t stream) {
  using S = Heads<D>;
  Args a;
  const int HD = H * D;
  const long long sl = HD, sr = (long long)L * HD, sb = (long long)R * L * HD;
  // [B, R, L, H*D] read as rows_map's [B, H, L, D] with R in the place of H
  int rc = rows_map(&a.q, q, HD, L, R, B, sl, sr, sb, BQ, D, S::SWIZZLE, S::RB);
  if (rc == 0) rc = rows_map(&a.k, k, HD, L, R, B, sl, sr, sb, BK, D, S::SWIZZLE, S::RB);
  if (rc == 0) rc = rows_map(&a.v, v, HD, L, R, B, sl, sr, sb, HK, D, S::SWIZZLE, S::G);
  if (rc != 0) return rc;
  a.p.bias = static_cast<const float*>(bias);
  a.p.out = static_cast<__nv_bfloat16*>(out);
  a.p.R = R;
  a.p.L = L;
  a.p.H = H;
  a.p.qk_scale = qk_scale;
  switch (stages_for((L + BK - 1) / BK)) {
    case 4: return launch<D, 4>(a, B, stream);
    case 5: return launch<D, 5>(a, B, stream);
    default: return launch<D, 6>(a, B, stream);
  }
}

}  // namespace

// q, k, v, out: contiguous bf16 [B, R, L, H*D], 16-byte aligned, D = 16, 32
// or 64; bias: f32 [B, L] in log2 units or null; qk_scale = scale *
// log2(e). The caller checks 1 <= L <= 1024. Returns cudaGetLastError()
// after the launch, or hopper::ERR_* if a tensor map could not be made.
// `device`: the card's index.
extern "C" int oneprot_tied_row_attention(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int B, int R,
                                          int L, int H, int D, float qk_scale, int device,
                                          void* stream) {
  if (L < 1 || L > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  // cuTensorMapEncodeTiled needs the card's context current on this thread
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run<16>(q, k, v, bias, out, B, R, L, H, qk_scale, s);
    case 32: return run<32>(q, k, v, bias, out, B, R, L, H, qk_scale, s);
    case 64: return run<64>(q, k, v, bias, out, B, R, L, H, qk_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
