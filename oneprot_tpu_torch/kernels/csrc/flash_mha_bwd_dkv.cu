// Flash multi-head attention backward, dk/dv pass, in the [B, L, H*D] layout.
//
// Replaces: oneprot_tpu/kernels/flash_mha.py:_bwd_dkv_kernel (launched by
// _bwd, behind the custom vjp of mha_attention). Same function: for each
// key and query row, s = q_r rot(k)^T + bias (log2 units; -1e30 across
// segments) and p = exp2(min(s - lse, 0)) from the forward's base-2 lse;
// dv = bf16(p)^T dO; dS = p (dO v^T - delta), rounded to bf16, and dk =
// R^T (dS^T q_r) / log2(e), since q_r = rot(q) * bf16(log2(e) / sqrt(D))
// already carries the softmax scale (rot(k) and q_r in bf16 arithmetic,
// each product and sum rounded: rotate_rows). q_r and delta = rowsum(dO *
// O) come in as the dq pass's prologue wrote them (flash_mha_bwd_dq.cu), so this pass
// launches after it and rotates nothing that it streams.
//
// What bounds it on H100: four products of 2 * D flops per (key, query)
// pair that shares a segment (k q_r^T, v dO^T, p^T dO, dS^T q_r) and an
// exp2 per pair, against ~6 * D * 2 bytes per row (k, v, q_r, dO in; dk, dv
// out); with 16 proteins a row at D = 24 the pairs are few and the bytes
// bound it, so the kernel visits only the query tiles that share a segment
// with its keys.
//
// Design (sm_90a; shared helpers in flash_mha_bwd.cuh), FA-3's dk/dv pass:
// one CTA per 64 keys of one (batch, head), warp 4 the producer,
// warpgroup 0 computing. The producer TMA-loads the CTA's K, V and rotary
// rows once, builds the list of query tiles that share a segment with the
// keys (the skip rule of the dq pass, from the other side), and streams
// those tiles' q_r and dO through a two-stage mbarrier ring, with each
// query's lse, delta and segment id by plain loads. The consumers rotate
// their own K once, in the prologue (then fence.proxy.async): S^T = K_rot
// q_r^T and dP^T = V dO^T are wgmma m64n64k16 with both operands K-major in
// shared memory; dV += bf16(P^T) dO and dK += bf16(dS^T) q_r take the packed
// accumulators as A operands and read the dO and q_r tiles MN-major, so p
// and dS never touch shared memory. dv goes out from the registers; dk is
// scaled, staged in shared memory and rotated back by R^T. DP = 32 (64-byte
// rows, 64-byte swizzle) for heads up to 32, DP = 64 up to 64; at DP = 32
// three CTAs share an SM (34 KB of shared memory, at most 136 registers a
// thread). No atomics. Any L >= 1.

#include "flash_mha_bwd.cuh"

namespace {

using namespace mha_bwd;

struct alignas(64) Args {
  CUtensorMap qr, dout, k, v, cos, sin;
  Params p;
};

// Shared memory, in bytes from a 1024-aligned base; every tile Tile<DP>.
template <int DP>
struct Smem {
  static constexpr int T = Tile<DP>::BYTES;
  static constexpr int K = 0;        // k, then K_rot; with V, dk in f32 at the end
  static constexpr int V = K + T;
  static constexpr int CK = V + T;   // the keys' rotary tables
  static constexpr int SK = CK + T;
  static constexpr int STAGE = SK + T;  // [STAGES] x (q_r, dO)
  static constexpr int STAGE_BYTES = 2 * T;
  static constexpr int LSE = STAGE + STAGES * STAGE_BYTES;  // f32 [STAGES][TILE]
  static constexpr int DELTA = LSE + STAGES * TILE * 4;     // f32 [STAGES][TILE]
  static constexpr int SEG = DELTA + STAGES * TILE * 4;     // int [STAGES][TILE]
  static constexpr int BARS = SEG + STAGES * TILE * 4;  // k_full, q_full[STAGES], q_empty[STAGES]
  static constexpr int COUNT = BARS + 8 * (1 + 2 * STAGES);
  static constexpr int LIST = COUNT + 16;  // int [n_tiles]
  static int bytes(int n_tiles) { return LIST + 4 * n_tiles + 1024; }  // + alignment slack
  static_assert(TILE * DP * 4 <= 2 * T, "dk in f32 must fit the K and V tiles");
};

template <int DP>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, int k0, int h, int b) {
  using S = Smem<DP>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* q_full = bars + 1;
  uint64_t* q_empty = bars + 1 + STAGES;
  const int lane = threadIdx.x % 32;
  const int L = p.L;
  if (lane == 0) {
    mbar_arrive_expect_tx(bars, (p.rotary ? 4 : 2) * S::T);
    tma_load_4d(sm + S::K, &a.k, bars, 0, k0, h, b);
    tma_load_4d(sm + S::V, &a.v, bars, 0, k0, h, b);
    if (p.rotary) {
      tma_load_4d(sm + S::CK, &a.cos, bars, 0, k0, 0, 0);
      tma_load_4d(sm + S::SK, &a.sin, bars, 0, k0, 0, 0);
    }
  }
  const int n_tiles = (L + TILE - 1) / TILE;
  int* list = reinterpret_cast<int*>(sm + S::LIST);
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (size_t)b * L;
  const int count = build_list(seg, L, k0 / TILE, n_tiles, list, lane);
  if (lane == 0) *reinterpret_cast<int*>(sm + S::COUNT) = count;
  named_bar_arrive(BAR_LIST, THREADS);

  const size_t lrow = ((size_t)b * p.H + h) * L;
  float* lse_s = reinterpret_cast<float*>(sm + S::LSE);
  float* delta_s = reinterpret_cast<float*>(sm + S::DELTA);
  int* seg_s = reinterpret_cast<int*>(sm + S::SEG);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    const int q0 = list[it] * TILE;
    mbar_wait_or_trap(&q_empty[s], ((it / STAGES) & 1) ^ 1);
    // queries past L: lse +inf (p = 0) and delta 0
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e, row = q0 + i;
      const bool in = row < L;
      lse_s[s * TILE + i] = in ? p.lse[lrow + row] : INFINITY;
      delta_s[s * TILE + i] = in ? p.delta[lrow + row] : 0.f;
      seg_s[s * TILE + i] = seg == nullptr ? 0 : seg[min(row, L - 1)];
    }
    if (lane == 0) {
      uint8_t* st = sm + S::STAGE + s * S::STAGE_BYTES;
      mbar_arrive_expect_tx(&q_full[s], 2 * S::T);
      tma_load_4d(st, &a.qr, &q_full[s], 0, q0, h, b);
      tma_load_4d(st + S::T, &a.dout, &q_full[s], 0, q0, h, b);
    } else {
      mbar_arrive(&q_full[s]);
    }
  }
}

template <int DP>
__device__ __forceinline__ void consumer(const Args& a, uint8_t* sm, int k0, int h, int b) {
  using S = Smem<DP>;
  using T = Tile<DP>;
  constexpr int RB = T::RB;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* q_full = bars + 1;
  uint64_t* q_empty = bars + 1 + STAGES;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int key_a = k0 + 16 * warp + lane / 4;  // this thread's two keys
  const int key_b = key_a + 8;
  // keys past L: bias -inf makes p = 0
  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * p.L;
  float bias_a = -INFINITY, bias_b = -INFINITY;
  if (key_a < p.L) bias_a = bias == nullptr ? 0.f : bias[key_a];
  if (key_b < p.L) bias_b = bias == nullptr ? 0.f : bias[key_b];
  const bool segmented = p.seg != nullptr;
  int seg_a = 0, seg_b = 0;
  if (segmented) {
    seg_a = p.seg[(size_t)b * p.L + min(key_a, p.L - 1)];
    seg_b = p.seg[(size_t)b * p.L + min(key_b, p.L - 1)];
  }

  // the prologue: K_rot = rot(k) in bf16 arithmetic, in place, for wgmma to read
  mbar_wait_or_trap(bars, 0);
  if (p.rotary) {
    rotate_rows<DP>(sm + S::K, sm + S::CK, sm + S::SK, p.D, true, false, 0u, tid);
    fence_proxy_async();
    named_bar_sync(BAR_CONSUMERS, CONSUMERS);
  }
  const uint32_t k_addr = smem_u32(sm + S::K), v_addr = smem_u32(sm + S::V);

  const float* lse_s = reinterpret_cast<const float*>(sm + S::LSE);
  const float* delta_s = reinterpret_cast<const float*>(sm + S::DELTA);
  const int* seg_s = reinterpret_cast<const int*>(sm + S::SEG);
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  named_bar_sync(BAR_LIST, THREADS);
  const int count = *reinterpret_cast<const int*>(sm + S::COUNT);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    mbar_wait_or_trap(&q_full[s], (it / STAGES) & 1);
    const uint32_t qr_addr = smem_u32(sm + S::STAGE + s * S::STAGE_BYTES);
    const uint32_t do_addr = qr_addr + S::T;

    // S^T = K_rot q_r^T and dP^T = V dO^T: 64 keys x 64 queries
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_m64n64(st, desc_sw<RB>(k_addr + 32 * kk, 16, T::SBO),
                      desc_sw<RB>(qr_addr + 32 * kk, 16, T::SBO), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_m64n64(dpt, desc_sw<RB>(v_addr + 32 * kk, 16, T::SBO),
                      desc_sw<RB>(do_addr + 32 * kk, 16, T::SBO), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T = exp2(min(s + bias (+ -1e30 across segments) - lse, 0)), then
    // dV += bf16(P^T) dO
    const float* ls = lse_s + s * TILE;
    const int* ss = seg_s + s * TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * t + e;
        float add_a = bias_a, add_b = bias_b;
        if (segmented) {
          const int sq = ss[qc];
          add_a += sq == seg_a ? 0.f : SEG_MASK;
          add_b += sq == seg_b ? 0.f : SEG_MASK;
        }
        const float lse = ls[qc];
        st[4 * j + e] = exp2f(fminf(st[4 * j + e] + add_a - lse, 0.f));
        st[4 * j + 2 + e] = exp2f(fminf(st[4 * j + 2 + e] + add_b - lse, 0.f));
      }
    }
    uint32_t pa[4][4];
    a_operand(pa, st);
    wgmma_fence();
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb_dp<DP>(dv, pa[kk], desc_sw<RB>(do_addr + kk * 16 * RB, S::T, T::SBO));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed (dV may still run)
    fence_regs(dpt);

    // dS^T = P^T (dP^T - delta), then dK += bf16(dS^T) q_r
    const float* dls = delta_s + s * TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
      dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - dl.x);
      dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - dl.y);
      dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - dl.x);
      dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - dl.y);
    }
    uint32_t da[4][4];
    a_operand(da, dpt);
    wgmma_fence();
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb_dp<DP>(dk, da[kk], desc_sw<RB>(qr_addr + kk * 16 * RB, S::T, T::SBO));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(&q_empty[s]);  // this thread is done with the stage
  }

  const size_t head = (size_t)b * p.L * p.H * p.D + (size_t)h * p.D;
  store_acc<DP>(p.dv + head, dv, p, k0, tid);
  // dk = R^T (acc / log2 e), staged in f32 over the K and V tiles (the
  // last product that read them has completed)
  float* g_s = reinterpret_cast<float*>(sm + S::K);
  stage_acc<DP>(g_s, dk, tid, p.dk_scale);
  named_bar_sync(BAR_CONSUMERS, CONSUMERS);
  write_back<DP>(p.dk + head, g_s, sm + S::CK, sm + S::SK, p, k0, tid);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 32 ? 3 : 2)
    flash_mha_bwd_dkv_wgmma(const __grid_constant__ Args a) {
  using S = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  if (threadIdx.x == CONSUMERS) {
    mbar_init(bars, 1);  // k_full: the producer's expect_tx, then TMA's bytes
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);                  // q_full: the producer warp
      mbar_init(bars + 1 + STAGES + s, CONSUMERS);  // q_empty: every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x >= CONSUMERS)
    producer<DP>(a, sm, k0, h, b);
  else
    consumer<DP>(a, sm, k0, h, b);
}

template <int DP>
int launch(const void* qr, const void* k, const void* v, const void* dout, const void* cos,
           const void* sin, const Params& p, int B, cudaStream_t stream) {
  Args a;
  a.p = p;
  int rc = tile_map<DP>(&a.qr, qr, p.D, p.L, p.H, B);
  if (rc == 0) rc = tile_map<DP>(&a.dout, dout, p.D, p.L, p.H, B);
  if (rc == 0) rc = tile_map<DP>(&a.k, k, p.D, p.L, p.H, B);
  if (rc == 0) rc = tile_map<DP>(&a.v, v, p.D, p.L, p.H, B);
  if (rc == 0 && p.rotary) rc = tile_map<DP>(&a.cos, cos, p.D, p.L, 1, 1);
  if (rc == 0 && p.rotary) rc = tile_map<DP>(&a.sin, sin, p.D, p.L, 1, 1);
  if (rc != 0) return rc;
  const int n_tiles = (p.L + TILE - 1) / TILE;
  const int smem = Smem<DP>::bytes(n_tiles);
  auto kernel = flash_mha_bwd_dkv_wgmma<DP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qr, k, v, dout, dk, dv: contiguous bf16 [B, L, H*D] (qr as the dq pass
// wrote it); bias: f32 [B, L] in log2 units or null; cos, sin: bf16 [L, D]
// or both null; seg: int32 [B, L] or null; lse (base 2), delta: f32
// [B, H, L]. dk_scale = 1 / log2(e). The caller checks D % 8 == 0, D <= 64
// and 16-byte aligned pointers. Returns cudaGetLastError() after the
// launch, or hopper::ERR_* if a tensor map could not be made. `device`: the
// card's index.
extern "C" int oneprot_flash_mha_bwd_dkv(const void* qr, const void* k, const void* v,
                                         const void* dout, const void* bias, const void* cos,
                                         const void* sin, const void* seg, const void* lse,
                                         const void* delta, void* dk, void* dv, int B, int L,
                                         int H, int D, float dk_scale, int device,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p = {};
  p.bias = static_cast<const float*>(bias);
  p.seg = static_cast<const int*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.L = L;
  p.H = H;
  p.D = D;
  p.dk_scale = dk_scale;
  p.rotary = cos != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 32 ? launch<32>(qr, k, v, dout, cos, sin, p, B, s)
                 : launch<64>(qr, k, v, dout, cos, sin, p, B, s);
}
