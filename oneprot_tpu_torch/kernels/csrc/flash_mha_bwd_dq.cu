// Flash multi-head attention backward, dq pass, in the [B, L, H*D] layout,
// and the backward's prologue.
//
// Replaces: oneprot_tpu/kernels/flash_mha.py:_bwd_dq_kernel (launched by
// _bwd, behind the custom vjp of mha_attention). Same function: for each
// query row, q_r = rot(q) * bf16(log2(e) / sqrt(D)) in bf16 arithmetic,
// each product and sum rounded (rotate_rows), as the forward rounds it; s
// = q_r rot(k)^T + bias (log2 units; -1e30 across segments) and p =
// exp2(min(s - lse, 0)) from the forward's base-2 lse (the clamp keeps the
// padding rows of packed batches finite), dS = p (dO v^T - delta), rounded
// to bf16 as the operand of dS rot(k), and dq = R^T (dS rot(k)) / sqrt(D).
// The prologue, which the TPU package runs outside its kernels: each CTA
// writes q_r and delta = rowsum(dO * O) (f32) for its own query rows, which
// it reads anyway; the dk/dv pass (flash_mha_bwd_dkv.cu) loads both as they
// are, so nothing rotates or scales q twice and no eager pass over dO and O
// runs.
//
// What bounds it on H100: three products of 2 * D flops per (query, key)
// pair that shares a segment (q k^T, dO v^T, dS k) and an exp2 per pair,
// against ~7 * D * 2 bytes per row (q, dO, O, k, v in; dq, q_r out). At the
// 35M tower's D = 24 with 16 proteins a row, the pairs that share a segment
// are few, and the bound is the bytes; the work is in the tiles that hold
// such pairs, so the kernel visits only those. Each visited key tile moves
// 4 x 64 rows of D * 2 = 48 bytes (K, V and the two rotary tables), one
// TMA row fetch each: the fetches, not the products, set its pace.
//
// Design (sm_90a; shared helpers in flash_mha_bwd.cuh): one CTA per 64
// query rows of one (batch, head), warp-specialised: warp 4 is the
// producer, warpgroup 0 computes. The producer TMA-loads the CTA's q, dO,
// O and rotary rows once, builds the list of key tiles that share a segment
// with the CTA's block (the skip rule: min / max of the ids other than -1
// and a padding flag per tile; without segment ids, every tile), and
// streams those tiles' K, V and rotary rows through a two-stage mbarrier
// ring, with each key's bias and segment id by plain loads. The consumers'
// prologue rotates and pre-scales q in place (then fence.proxy.async, since
// wgmma reads through the async proxy) and writes q_r and delta. Per key
// tile the consumers rotate K in place (fence.proxy.async and a barrier
// again), take S = q_r K^T and dP = dO V^T (wgmma m64n64k16 with both
// operands K-major in shared memory: q_r and dO held as register A
// operands across the loop gave wrong products at DP = 64), p and dS in
// registers, and dq += dS K (dS packed as the A operand, K read
// MN-major). The epilogue scales dq, stages
// it in shared memory and applies R^T. Heads up to 32 wide take 64-byte
// rows with the 64-byte swizzle (DP = 32: the tower's D = 24 pads to 32,
// not 64), wider ones up to 64 128-byte rows. Small CTAs (55 KB of shared
// memory and at most 136 registers a thread at DP = 32: three an SM) let one
// CTA's prologue overlap another's products. No atomics: dq is
// deterministic. Any L >= 1.

#include "flash_mha_bwd.cuh"

namespace {

using namespace mha_bwd;

struct alignas(64) Args {
  CUtensorMap q, dout, out, k, v, cos, sin;
  Params p;
};

// Shared memory, in bytes from a 1024-aligned base; every tile Tile<DP>.
template <int DP>
struct Smem {
  static constexpr int T = Tile<DP>::BYTES;
  static constexpr int Q = 0;        // q, then q_r; with DO, dq in f32 at the end
  static constexpr int DO = Q + T;
  static constexpr int O = DO + T;
  static constexpr int CQ = O + T;   // the query rows' rotary tables
  static constexpr int SQ = CQ + T;
  static constexpr int STAGE = SQ + T;  // [STAGES] x (K, V, cos, sin)
  static constexpr int STAGE_BYTES = 4 * T;
  static constexpr int BIAS = STAGE + STAGES * STAGE_BYTES;  // f32 [STAGES][TILE]
  static constexpr int SEG = BIAS + STAGES * TILE * 4;        // int [STAGES][TILE]
  static constexpr int DELTA = SEG + STAGES * TILE * 4;       // f32 [TILE]
  static constexpr int BARS = DELTA + TILE * 4;  // q_full, kv_full[STAGES], kv_empty[STAGES]
  static constexpr int COUNT = BARS + 8 * (1 + 2 * STAGES);  // the list's length
  static constexpr int LIST = COUNT + 16;                     // int [n_tiles]
  static int bytes(int n_tiles) { return LIST + 4 * n_tiles + 1024; }  // + alignment slack
  static_assert(TILE * DP * 4 <= 2 * T, "dq in f32 must fit the q and dO tiles");
};

template <int DP>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, int q0, int h, int b) {
  using S = Smem<DP>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 1 + STAGES;
  const int lane = threadIdx.x % 32;
  const int L = p.L;
  if (lane == 0) {
    mbar_arrive_expect_tx(bars, (p.rotary ? 5 : 3) * S::T);
    tma_load_4d(sm + S::Q, &a.q, bars, 0, q0, h, b);
    tma_load_4d(sm + S::DO, &a.dout, bars, 0, q0, h, b);
    tma_load_4d(sm + S::O, &a.out, bars, 0, q0, h, b);
    if (p.rotary) {
      tma_load_4d(sm + S::CQ, &a.cos, bars, 0, q0, 0, 0);
      tma_load_4d(sm + S::SQ, &a.sin, bars, 0, q0, 0, 0);
    }
  }
  const int n_tiles = (L + TILE - 1) / TILE;
  int* list = reinterpret_cast<int*>(sm + S::LIST);
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (size_t)b * L;
  const int count = build_list(seg, L, q0 / TILE, n_tiles, list, lane);
  if (lane == 0) *reinterpret_cast<int*>(sm + S::COUNT) = count;
  named_bar_arrive(BAR_LIST, THREADS);

  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * L;
  float* bias_s = reinterpret_cast<float*>(sm + S::BIAS);
  int* seg_s = reinterpret_cast<int*>(sm + S::SEG);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    const int k0 = list[it] * TILE;
    mbar_wait_or_trap(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
    // keys past L: bias -inf, so p = 0 there whatever the row's lse
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e, key = k0 + i;
      bias_s[s * TILE + i] = key < L ? (bias == nullptr ? 0.f : bias[key]) : -INFINITY;
      seg_s[s * TILE + i] = seg == nullptr ? 0 : seg[min(key, L - 1)];
    }
    if (lane == 0) {
      uint8_t* st = sm + S::STAGE + s * S::STAGE_BYTES;
      mbar_arrive_expect_tx(&kv_full[s], (p.rotary ? 4 : 2) * S::T);
      tma_load_4d(st, &a.k, &kv_full[s], 0, k0, h, b);
      tma_load_4d(st + S::T, &a.v, &kv_full[s], 0, k0, h, b);
      if (p.rotary) {
        tma_load_4d(st + 2 * S::T, &a.cos, &kv_full[s], 0, k0, 0, 0);
        tma_load_4d(st + 3 * S::T, &a.sin, &kv_full[s], 0, k0, 0, 0);
      }
    } else {
      mbar_arrive(&kv_full[s]);
    }
  }
}

// The prologue: q_r in place and out to global memory, delta of the CTA's
// rows (tile order) to shared and global memory. Each row's DP / 8 chunks
// of 16 bytes go to as many neighbouring threads for delta.
template <int DP>
__device__ __forceinline__ void prologue(const Params& p, uint8_t* sm, int tid, int q0, int h,
                                         int b) {
  using S = Smem<DP>;
  using T = Tile<DP>;
  rotate_rows<DP>(sm + S::Q, sm + S::CQ, sm + S::SQ, p.D, p.rotary, true, bf2_splat(p.q_pre),
                  tid);
  fence_proxy_async();  // q_r, written here, is read by wgmma

  constexpr int CH = DP / 8;           // chunks of a row
  constexpr int RPP = CONSUMERS / CH;  // rows per pass
  float* delta_s = reinterpret_cast<float*>(sm + S::DELTA);
  const size_t lrow = ((size_t)b * p.H + h) * p.L;
  const int cc = tid % CH;
#pragma unroll
  for (int i = 0; i < TILE / RPP; ++i) {
    const int r = tid / CH + RPP * i;
    const int o = r * T::RB + ((cc ^ T::swz(r)) << 4);
    const float dot = row_sum<CH>(dot8(*reinterpret_cast<const uint4*>(sm + S::DO + o),
                                       *reinterpret_cast<const uint4*>(sm + S::O + o)));
    if (cc == 0) {
      delta_s[r] = dot;
      if (q0 + r < p.L) p.delta[lrow + q0 + r] = dot;
    }
  }
  named_bar_sync(BAR_CONSUMERS, CONSUMERS);  // q_r and delta_s complete

  const long long hd = (long long)p.H * p.D;
  __nv_bfloat16* qr = p.qr + (size_t)b * p.L * hd + (size_t)h * p.D;
  const int dch = p.D / 8;
  for (int i = tid; i < TILE * dch; i += CONSUMERS) {
    const int r = i / dch, c = i % dch;
    if (q0 + r < p.L)
      *reinterpret_cast<uint4*>(qr + (q0 + r) * hd + 8 * c) =
          *reinterpret_cast<const uint4*>(sm + S::Q + r * T::RB + ((c ^ T::swz(r)) << 4));
  }
}

template <int DP>
__device__ __forceinline__ void consumer(const Args& a, uint8_t* sm, int q0, int h, int b) {
  using S = Smem<DP>;
  using T = Tile<DP>;
  constexpr int RB = T::RB;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 1 + STAGES;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;

  mbar_wait_or_trap(bars, 0);  // q, dO, O and the query rows' tables landed
  prologue<DP>(p, sm, tid, q0, h, b);
  const uint32_t q_addr = smem_u32(sm + S::Q), do_addr = smem_u32(sm + S::DO);

  const int r_a = 16 * warp + lane / 4;  // this thread's rows of the tile
  const int row_a = q0 + r_a, row_b = row_a + 8;
  const size_t lrow = ((size_t)b * p.H + h) * p.L;
  // rows past L: lse = +inf makes p = 0
  const float lse_a = row_a < p.L ? p.lse[lrow + row_a] : INFINITY;
  const float lse_b = row_b < p.L ? p.lse[lrow + row_b] : INFINITY;
  const float* delta_s = reinterpret_cast<const float*>(sm + S::DELTA);
  const float dl_a = delta_s[r_a], dl_b = delta_s[r_a + 8];
  const bool segmented = p.seg != nullptr;
  int seg_a = 0, seg_b = 0;
  if (segmented) {
    seg_a = p.seg[(size_t)b * p.L + min(row_a, p.L - 1)];
    seg_b = p.seg[(size_t)b * p.L + min(row_b, p.L - 1)];
  }
  const float* bias_s = reinterpret_cast<const float*>(sm + S::BIAS);
  const int* seg_s = reinterpret_cast<const int*>(sm + S::SEG);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  named_bar_sync(BAR_LIST, THREADS);
  const int count = *reinterpret_cast<const int*>(sm + S::COUNT);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    mbar_wait_or_trap(&kv_full[s], (it / STAGES) & 1);
    uint8_t* st = sm + S::STAGE + s * S::STAGE_BYTES;
    if (p.rotary) {
      rotate_rows<DP>(st, st + 2 * S::T, st + 3 * S::T, p.D, true, false, 0u, tid);
      fence_proxy_async();  // the rotated K, written here, is read by wgmma
      named_bar_sync(BAR_CONSUMERS, CONSUMERS);
    }
    const uint32_t k_addr = smem_u32(st);
    const uint32_t v_addr = smem_u32(st + S::T);

    // S = q_r K^T and dP = dO V^T, 64 x 64 each, over the head dim
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_m64n64(sc, desc_sw<RB>(q_addr + 32 * kk, 16, T::SBO),
                      desc_sw<RB>(k_addr + 32 * kk, 16, T::SBO), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_m64n64(dp, desc_sw<RB>(do_addr + 32 * kk, 16, T::SBO),
                      desc_sw<RB>(v_addr + 32 * kk, 16, T::SBO), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // p = exp2(min(s + bias (+ -1e30 across segments) - lse, 0))
    const float* bs = bias_s + s * TILE;
    const int* ss = seg_s + s * TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * j + 2 * t + e;
        float add_a = bs[kc], add_b = add_a;
        if (segmented) {
          const int sk = ss[kc];
          add_a += sk == seg_a ? 0.f : SEG_MASK;
          add_b += sk == seg_b ? 0.f : SEG_MASK;
        }
        sc[4 * j + e] = exp2f(fminf(sc[4 * j + e] + add_a - lse_a, 0.f));
        sc[4 * j + 2 + e] = exp2f(fminf(sc[4 * j + 2 + e] + add_b - lse_b, 0.f));
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = p (dP - delta), then dq += bf16(dS) K
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dp[4 * j + 0] = sc[4 * j + 0] * (dp[4 * j + 0] - dl_a);
      dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - dl_a);
      dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - dl_b);
      dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - dl_b);
    }
    uint32_t ds[4][4];
    a_operand(ds, dp);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb_dp<DP>(acc, ds[kk], desc_sw<RB>(k_addr + kk * 16 * RB, S::T, T::SBO));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&kv_empty[s]);  // this thread is done with the stage
  }

  // dq = R^T (acc / sqrt(D)), staged in f32 over the q and dO tiles (the
  // last product that read them has completed)
  float* g_s = reinterpret_cast<float*>(sm + S::Q);
  stage_acc<DP>(g_s, acc, tid, p.dq_scale);
  named_bar_sync(BAR_CONSUMERS, CONSUMERS);
  write_back<DP>(p.dq + (size_t)b * p.L * p.H * p.D + (size_t)h * p.D, g_s, sm + S::CQ,
                 sm + S::SQ, p, q0, tid);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 32 ? 3 : 2)
    flash_mha_bwd_dq_wgmma(const __grid_constant__ Args a) {
  using S = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  if (threadIdx.x == CONSUMERS) {
    mbar_init(bars, 1);  // q_full: the producer's expect_tx, then TMA's bytes
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);                  // kv_full: the producer warp
      mbar_init(bars + 1 + STAGES + s, CONSUMERS);  // kv_empty: every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x >= CONSUMERS)
    producer<DP>(a, sm, q0, h, b);
  else
    consumer<DP>(a, sm, q0, h, b);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* cos, const void* sin, const Params& p, int B, cudaStream_t stream) {
  Args a;
  a.p = p;
  int rc = tile_map<DP>(&a.q, q, p.D, p.L, p.H, B);
  if (rc == 0) rc = tile_map<DP>(&a.dout, dout, p.D, p.L, p.H, B);
  if (rc == 0) rc = tile_map<DP>(&a.out, out, p.D, p.L, p.H, B);
  if (rc == 0) rc = tile_map<DP>(&a.k, k, p.D, p.L, p.H, B);
  if (rc == 0) rc = tile_map<DP>(&a.v, v, p.D, p.L, p.H, B);
  if (rc == 0 && p.rotary) rc = tile_map<DP>(&a.cos, cos, p.D, p.L, 1, 1);
  if (rc == 0 && p.rotary) rc = tile_map<DP>(&a.sin, sin, p.D, p.L, 1, 1);
  if (rc != 0) return rc;
  const int n_tiles = (p.L + TILE - 1) / TILE;
  const int smem = Smem<DP>::bytes(n_tiles);
  auto kernel = flash_mha_bwd_dq_wgmma<DP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout, dq, qr: contiguous bf16 [B, L, H*D]; bias: f32 [B, L]
// in log2 units or null; cos, sin: bf16 [L, D] or both null; seg: int32
// [B, L] or null; lse (base 2): f32 [B, H, L]; delta: f32 [B, H, L],
// written. q_pre = bf16(log2(e) / sqrt(D)), dq_scale = 1 / sqrt(D). The caller
// checks D % 8 == 0, D <= 64 and 16-byte aligned pointers. Returns
// cudaGetLastError() after the launch, or hopper::ERR_* if a tensor map could
// not be made. `device`: the card's index.
extern "C" int oneprot_flash_mha_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* bias,
                                        const void* cos, const void* sin, const void* seg,
                                        const void* lse, void* dq, void* qr, void* delta, int B,
                                        int L, int H, int D, float q_pre, float dq_scale,
                                        int device, void* stream) {
  // cuTensorMapEncodeTiled needs the card's context current on this thread
  // (autograd runs the backward on a thread of its own)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p = {};
  p.bias = static_cast<const float*>(bias);
  p.seg = static_cast<const int*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.qr = static_cast<__nv_bfloat16*>(qr);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.L = L;
  p.H = H;
  p.D = D;
  p.q_pre = q_pre;
  p.dq_scale = dq_scale;
  p.rotary = cos != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 32 ? launch<32>(q, k, v, out, dout, cos, sin, p, B, s)
                 : launch<64>(q, k, v, out, dout, cos, sin, p, B, s);
}
