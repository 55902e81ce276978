// FlashAttention-2 backward, dq pass, over [B, H, L, D] with an additive
// key bias, and the backward's prologue.
//
// Replaces: oneprot_tpu/kernels/flash_attention.py:_bwd_dq_kernel (launched
// by _bwd, behind the custom vjp flash_attention). Same function: q is
// multiplied by bf16(1/sqrt(D)) and rounded to bf16; for each query row and
// key, s = (q k^T + bias) * log2(e) in f32 and p = exp2(s - lse) from the
// forward's base-2 lse; dS = p (dO v^T - delta), rounded to bf16 as the
// operand of dS k; dq = (dS k) * (1/sqrt(D) in f32), stored as bf16; with
// segment ids (packed rows, Lq = Lk) a pair of unequal ids takes SEG_MASK
// on top of its bias, as in the forward (flash_attention_fwd.cu). The
// prologue, which the TPU package runs outside its kernels: each CTA writes
// q_s = bf16(q * bf16(1/sqrt(D))) and delta = rowsum(dO * O) (f32) for its
// own query rows, which it reads anyway; the dk/dv pass
// (flash_attention_bwd_dkv.cu) loads both as they are, so no pass scales q
// twice and no eager pass over dO and O runs.
//
// What bounds it on H100: three products of 2 * Lk * D flops per query row
// (q k^T, dO v^T, dS k) against ~6 * D * 2 bytes of q, dO, O, q_s, dq per
// row: at the ESM2-15B width (D = 128, L up to 1024) far above the card's
// ~295 flop/byte ridge, so tensor-core operations, which only wgmma reaches.
//
// Design (`wg`, sm_90a): FA-2's dq pass as a warp-specialised Hopper
// kernel. A CTA owns 128 query rows of one (batch, head): warpgroup 0 is
// the producer (one warp issues TMA and loads the bias; setmaxnreg gives
// its registers to the others), warpgroups 1 and 2 each compute 64 rows.
// The producer TMA-loads the CTA's q and dO rows once (4-D tensor maps over
// the strided [B, L, H, D] projections, 128-byte swizzle) and streams
// 64-key tiles of K and V, with the tile's bias, through a two-stage
// mbarrier ring. The prologue scales q in place in shared memory (then
// fence.proxy.async, so wgmma sees it). Per tile, S = Q_s K^T and dP = dO
// V^T are wgmma m64n64k16 from shared memory (K-major), p and dS stay in
// registers, and dq += dS K is a wgmma with dS as the register A operand
// and the K tile read MN-major (transpose bit): dS never touches shared
// memory and dq accumulates in f32 registers, 64 a thread at D = 128 and
// 128 at D = 256. No atomics: dq is deterministic. Masking is explicit,
// never by TMA's zero fill: keys past Lk get bias -inf (p = 0; a
// zero-filled key would give p = exp2(-lse), inf on a row whose keys are
// all masked), queries past Lq lse = +inf. Heads are zero-filled by TMA up
// to the instance's width: 64, 128 or 256.
//
// Heads of 136-256 (NH = 4): q and dO take 128 KB and a 64-key tile of K
// or V 32 KB, so K has two stages and V one (224 KB): K with its bias and
// ids arrives on barriers of its own, S starts before V has landed, and V
// is refilled once both consumers' dP is done, while they finish the tile.
// Tiles of 64 keys, not 32: a wgmma m64n32k16 from shared memory took
// nearly as long as an m64n64k16, so halving S's and dP's width nearly
// doubled their time. The waits are plain mbar_wait: a trap would hold the
// consumers to the launch's 168 registers (hopper.cuh), where dq alone
// takes 128.
//
// Packed rows: the producer marks the key tiles that share an id range
// with the CTA's 128 query rows in a bitmap (segment_tiles.cuh; 1 bit a
// tile, so a row of 225,280 keys still fits beside the 224 KB at NH = 4)
// and streams only those, each key's id beside its bias; the skipped
// tiles' dS is 0.
//
// Any Lq, Lk >= 1 (Lq = Lk with segment ids). dq and q_s are written by
// their own (batch, head, row) strides, so they land in the [B, L, H, D]
// order of the projections.

#include "flash_attention_bwd.cuh"
#include "hopper.cuh"
#include "segment_tiles.cuh"

namespace {

using namespace fa_bwd;

// ---------------------------------------------------------------------------
// wgmma + TMA, heads of 64, 128 and 256 (NH = 1, 2, 4 blocks of 64 columns)

namespace wg {

using namespace hopper;

constexpr int ROWS = 128;     // query rows per CTA, 64 per consumer warpgroup
constexpr int BK = 64;        // keys per streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 compute
// named barrier 3: the tile bitmap and count are ready (the producer warp
// and the consumers; the consumers' own take 1 and 2)
constexpr int BAR_LIST = 3;
constexpr int LISTENERS = 32 + 256;

struct alignas(64) Args {
  CUtensorMap q, dout;  // boxes of 64 columns x ROWS rows
  CUtensorMap k, v;     // boxes of 64 columns x BK rows
  Params p;
};

// Shared memory, in bytes from a 1024-aligned base. NH: 64-column blocks of
// the head (1: D <= 64, 2: D <= 128, 4: D <= 256); every tile is NH blocks
// of [rows][64] bf16 (see hopper.cuh). At NH = 4, q and dO take 128 KB and
// a K or V tile 32 KB, so V has one stage: K, the bias and the ids are
// guarded by kv_full and kv_empty, V by v_full and v_empty.
template <int NH>
struct Smem {
  static constexpr int V_STAGES = NH == 4 ? 1 : STAGES;
  static constexpr int ROW_BLOCK = ROWS * 128;
  static constexpr int KV_BLOCK = BK * 128;
  static constexpr int Q = 0;                                // q, then q_s
  static constexpr int DO = Q + NH * ROW_BLOCK;
  static constexpr int K = DO + NH * ROW_BLOCK;              // [STAGES][NH] blocks
  static constexpr int V = K + STAGES * NH * KV_BLOCK;       // [V_STAGES][NH] blocks
  static constexpr int BIAS = V + V_STAGES * NH * KV_BLOCK;  // f32 [STAGES][BK]
  static constexpr int SEG = BIAS + STAGES * BK * 4;         // int [STAGES][BK]
  static constexpr int DELTA = SEG + STAGES * BK * 4;        // f32 [ROWS]
  // q_full, kv_full[STAGES], kv_empty[STAGES], then at NH = 4 v_full, v_empty
  static constexpr int BARS = DELTA + ROWS * 4;
  static constexpr int COUNT = BARS + 8 * (1 + 2 * STAGES + (NH == 4 ? 2 : 0));  // tiles visited
  static constexpr int MASK = COUNT + 16;  // uint32 [ceil(n_tiles / 32)]: the tiles visited
  // + alignment slack; at NH = 4 (232,008 bytes before the mask) up to
  // 3,520 key tiles, Lk <= 225,280, beyond which the launch is refused
  static int bytes(int n_tiles) { return MASK + 4 * ((n_tiles + 31) / 32) + 1024; }
};

// One warp: q and dO once, the bitmap of key tiles to visit, then K, V, the
// bias and the segment ids tile by tile.
template <int NH>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, int q0, int h, int b) {
  using S = Smem<NH>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 1 + STAGES;
  float* bias_s = reinterpret_cast<float*>(sm + S::BIAS);
  const int lane = threadIdx.x % 32;
  const int Lk = a.p.Lk;
  const float* bias = a.p.bias == nullptr ? nullptr : a.p.bias + (size_t)b * Lk;
  const int* seg = a.p.seg == nullptr ? nullptr : a.p.seg + (size_t)b * Lk;
  int* seg_s = reinterpret_cast<int*>(sm + S::SEG);
  if (lane == 0) {
    mbar_arrive_expect_tx(bars, 2 * NH * S::ROW_BLOCK);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load_4d(sm + S::Q + c * S::ROW_BLOCK, &a.q, bars, 64 * c, q0, h, b);
      tma_load_4d(sm + S::DO + c * S::ROW_BLOCK, &a.dout, bars, 64 * c, q0, h, b);
    }
  }
  const int n_tiles = (Lk + BK - 1) / BK;
  uint32_t* mask = reinterpret_cast<uint32_t*>(sm + S::MASK);
  const int count = segtiles::build_mask<ROWS, BK>(seg, Lk, q0, n_tiles, mask, lane);
  if (lane == 0) *reinterpret_cast<int*>(sm + S::COUNT) = count;
  named_bar_arrive(BAR_LIST, LISTENERS);
  // the visited tiles in order: the set bits of each word of the bitmap
  int it = 0;
  for (int w = 0; 32 * w < n_tiles; ++w) {
    for (uint32_t bits = mask[w]; bits != 0; bits &= bits - 1, ++it) {
      const int s = it % STAGES;
      const int k0 = (32 * w + __ffs(bits) - 1) * BK;
      mbar_wait(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
      // keys past Lk: bias -inf, so p = 0 there whatever the row's lse
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 2 * lane + e;
        bias_s[s * BK + 2 * lane + e] =
            key < Lk ? (bias == nullptr ? 0.f : bias[key]) : -INFINITY;
        if (seg != nullptr) seg_s[s * BK + 2 * lane + e] = seg[min(key, Lk - 1)];
      }
      uint8_t* k_st = sm + S::K + s * NH * S::KV_BLOCK;
      if constexpr (NH == 4) {
        // K now; V once both consumers are done with the previous tile's
        uint64_t* v_full = kv_empty + STAGES;
        if (lane == 0) {
          mbar_arrive_expect_tx(&kv_full[s], NH * S::KV_BLOCK);
#pragma unroll
          for (int c = 0; c < NH; ++c)
            tma_load_4d(k_st + c * S::KV_BLOCK, &a.k, &kv_full[s], 64 * c, k0, h, b);
        } else {
          mbar_arrive(&kv_full[s]);
        }
        mbar_wait(v_full + 1, (it & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(v_full, NH * S::KV_BLOCK);
#pragma unroll
          for (int c = 0; c < NH; ++c)
            tma_load_4d(sm + S::V + c * S::KV_BLOCK, &a.v, v_full, 64 * c, k0, h, b);
        }
      } else if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full[s], 2 * NH * S::KV_BLOCK);
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          tma_load_4d(k_st + c * S::KV_BLOCK, &a.k, &kv_full[s], 64 * c, k0, h, b);
          tma_load_4d(sm + S::V + (s * NH + c) * S::KV_BLOCK, &a.v, &kv_full[s], 64 * c, k0,
                      h, b);
        }
      } else {
        mbar_arrive(&kv_full[s]);
      }
    }
  }
}

// The prologue of consumer warpgroup c, in place on its 64 rows of the q
// tile: q_s = bf16(q * qscale) to shared and global memory, delta to
// shared (the tile's row order) and global memory. Each row's 8 * NH
// chunks of 16 bytes go to as many neighbouring threads.
template <int NH>
__device__ __forceinline__ void prologue(const Params& p, uint8_t* sm, int c, int tid, int q0,
                                         int h, int b) {
  using S = Smem<NH>;
  constexpr int CH = 8 * NH;     // chunks of a row
  constexpr int RPP = 128 / CH;  // rows per pass of the warpgroup
  float* delta_s = reinterpret_cast<float*>(sm + S::DELTA);
  const size_t lrow = ((size_t)b * p.H + h) * p.Lq;
  const int cc = tid % CH;
#pragma unroll
  for (int i = 0; i < 64 / RPP; ++i) {
    const int r = 64 * c + tid / CH + RPP * i;  // row of the CTA's tile
    const int row = q0 + r;
    const int off = (cc / 8) * S::ROW_BLOCK + r * 128 + (((cc % 8) ^ (r % 8)) << 4);
    uint4* qp = reinterpret_cast<uint4*>(sm + S::Q + off);
    const uint4 qs8 = scale8(*qp, p.qscale);
    *qp = qs8;
    const float dot = row_sum<CH>(prologue_chunk(
        p, b, h, row, 8 * cc, qs8, *reinterpret_cast<const uint4*>(sm + S::DO + off)));
    if (cc == 0) {
      delta_s[r] = dot;
      if (row < p.Lq) p.delta[lrow + row] = dot;
    }
  }
}

template <int NH, bool SEG>
__device__ __forceinline__ void consumer(const Args& a, uint8_t* sm, int c, int q0, int h,
                                         int b) {
  using S = Smem<NH>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 1 + STAGES;
  uint64_t* v_full = bars + 1 + 2 * STAGES;  // and v_empty after it (NH = 4)
  const int tid = threadIdx.x - 128 * (c + 1);
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;

  mbar_wait(bars, 0);  // q and dO landed
  prologue<NH>(p, sm, c, tid, q0, h, b);
  fence_proxy_async();
  named_bar_sync(1 + c, 128);

  const int r_a = 64 * c + 16 * warp + lane / 4;  // this thread's rows of the tile
  const int row_a = q0 + r_a, row_b = row_a + 8;
  const size_t lrow = ((size_t)b * p.H + h) * p.Lq;
  // rows past Lq: lse = +inf makes p = 0
  const float lse_a = row_a < p.Lq ? p.lse[lrow + row_a] : INFINITY;
  const float lse_b = row_b < p.Lq ? p.lse[lrow + row_b] : INFINITY;
  const float* delta_s = reinterpret_cast<const float*>(sm + S::DELTA);
  const float dl_a = delta_s[r_a], dl_b = delta_s[r_a + 8];
  const float* bias_s = reinterpret_cast<const float*>(sm + S::BIAS);
  const int* seg_s = reinterpret_cast<const int*>(sm + S::SEG);
  int seg_a = 0, seg_b = 0;  // this thread's rows' ids
  if (SEG) {
    seg_a = p.seg[(size_t)b * p.Lk + min(row_a, p.Lk - 1)];
    seg_b = p.seg[(size_t)b * p.Lk + min(row_b, p.Lk - 1)];
  }
  const uint32_t q_addr = smem_u32(sm + S::Q + c * 64 * 128);
  const uint32_t do_addr = smem_u32(sm + S::DO + c * 64 * 128);

  float acc[32 * NH];
#pragma unroll
  for (int i = 0; i < 32 * NH; ++i) acc[i] = 0.f;

  named_bar_sync(BAR_LIST, LISTENERS);
  const int count = *reinterpret_cast<const int*>(sm + S::COUNT);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    mbar_wait(&kv_full[s], (it / STAGES) & 1);
    const uint32_t k_addr = smem_u32(sm + S::K + s * NH * S::KV_BLOCK);
    const uint32_t v_addr = smem_u32(sm + S::V + (s % S::V_STAGES) * NH * S::KV_BLOCK);

    // S = Q_s K^T and dP = dO V^T, 64 x 64 each, over the head dim
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < 4 * NH; ++kk) {
      const uint32_t kq = (kk / 4) * S::ROW_BLOCK + (kk % 4) * 32;
      const uint32_t kb = (kk / 4) * S::KV_BLOCK + (kk % 4) * 32;
      wgmma_ss_m64n64(sc, desc_sw128(q_addr + kq, 16, 1024), desc_sw128(k_addr + kb, 16, 1024),
                      kk);
    }
    wgmma_commit();
    if constexpr (NH == 4) {
      mbar_wait(v_full, it & 1);
      wgmma_fence();  // after the wait, or ptxas adds one (C7519)
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NH; ++kk) {
      const uint32_t kq = (kk / 4) * S::ROW_BLOCK + (kk % 4) * 32;
      const uint32_t kb = (kk / 4) * S::KV_BLOCK + (kk % 4) * 32;
      wgmma_ss_m64n64(dp, desc_sw128(do_addr + kq, 16, 1024), desc_sw128(v_addr + kb, 16, 1024),
                      kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // p = exp2((s + bias) * log2 e - lse), SEG_MASK across segments
    const float* bs = bias_s + s * BK;
    const int* ss = seg_s + s * BK;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
      float add[4] = {bb.x, bb.y, bb.x, bb.y};
      if (SEG) {
        const int2 kk = *reinterpret_cast<const int2*>(ss + 8 * j + 2 * t);
        add[0] = seg_bias(add[0], seg_a, kk.x);
        add[1] = seg_bias(add[1], seg_a, kk.y);
        add[2] = seg_bias(add[2], seg_b, kk.x);
        add[3] = seg_bias(add[3], seg_b, kk.y);
      }
      sc[4 * j + 0] = bwd_prob(sc[4 * j + 0], add[0], lse_a);
      sc[4 * j + 1] = bwd_prob(sc[4 * j + 1], add[1], lse_a);
      sc[4 * j + 2] = bwd_prob(sc[4 * j + 2], add[2], lse_b);
      sc[4 * j + 3] = bwd_prob(sc[4 * j + 3], add[3], lse_b);
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if constexpr (NH == 4) mbar_arrive(v_full + 1);  // this thread is done with V

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
      wgmma_rs_tb<NH>(acc, ds[kk], desc_sw128(k_addr + kk * 16 * 128, S::KV_BLOCK, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&kv_empty[s]);  // this thread is done with the stage
  }

  store_rows<64 * NH>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sl,
                      reinterpret_cast<const float(&)[8 * NH][4]>(acc), row_a, 0, p.Lq, p.D,
                      lane, p.scale);
}

template <int NH, bool SEG>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_dq_wgmma(const __grid_constant__ Args a) {
  using S = Smem<NH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // q_full: the producer's expect_tx, then TMA's bytes
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);            // kv_full: the producer warp
      mbar_init(bars + 1 + STAGES + s, 256);  // kv_empty: every consumer thread
    }
    if constexpr (NH == 4) {
      mbar_init(bars + 1 + 2 * STAGES, 1);    // v_full: expect_tx, then TMA's bytes
      mbar_init(bars + 2 + 2 * STAGES, 256);  // v_empty: every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  // at NH = 4 the producer spills at 24 registers, and the consumers' 232
  // suffice
  if (threadIdx.x < 128) {
    if constexpr (NH == 4)
      setmaxnreg_dec<40>();
    else
      setmaxnreg_dec<24>();
    if (threadIdx.x < 32) producer<NH>(a, sm, q0, h, b);
  } else {
    if constexpr (NH == 4)
      setmaxnreg_inc<232>();
    else
      setmaxnreg_inc<240>();
    consumer<NH, SEG>(a, sm, threadIdx.x / 128 - 1, q0, h, b);
  }
}

template <int NH>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = Smem<NH>::bytes((p.Lk + BK - 1) / BK);
  Args a;
  a.p = p;
  int rc = rows_map(&a.q, p.q, p.D, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, ROWS);
  if (rc == 0) rc = rows_map(&a.dout, p.dout, p.D, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, ROWS);
  if (rc == 0) rc = rows_map(&a.k, p.k, p.D, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, BK);
  if (rc == 0) rc = rows_map(&a.v, p.v, p.D, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, BK);
  if (rc != 0) return rc;
  auto kernel = p.seg == nullptr ? flash_attention_bwd_dq_wgmma<NH, false>
                                 : flash_attention_bwd_dq_wgmma<NH, true>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + ROWS - 1) / ROWS, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// q, k, v, out, dout, dq, qs: bf16 [B, H, L, D] at the given element strides
// (batch, head, row; unit stride over D); bias: f32 [B, Lk] contiguous or
// null; seg: int32 [B, L] contiguous segment ids (Lq = Lk = L) or null; lse
// (base 2): f32 [B, H, Lq] contiguous; delta: f32 [B, H, Lq]
// contiguous, written. qscale = bf16(1/sqrt(D)) as f32, scale = 1/sqrt(D).
// The caller checks D % 8 == 0, 64 <= D <= 256, strides that are multiples
// of 8 and 16-byte aligned pointers. Returns cudaGetLastError() after the
// launch, or hopper::ERR_* if a tensor map could not be made. `device`:
// the card's index.
extern "C" int oneprot_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias, const void* seg,
    const void* out, const void* dout, const void* lse, void* dq, void* qs, void* delta, int B,
    int H, int Lq,
    int Lk, int D, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
    long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl, long long do_sb, long long do_sh,
    long long do_sl, long long dq_sb, long long dq_sh, long long dq_sl, long long qs_sb,
    long long qs_sh, long long qs_sl, float qscale, float scale, int device, void* stream) {
  // cuTensorMapEncodeTiled needs the card's context current on this thread
  // (autograd runs the backward on a thread of its own)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<const __nv_bfloat16*>(out);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.bias = static_cast<const float*>(bias);
  p.seg = static_cast<const int*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.qs = static_cast<__nv_bfloat16*>(qs);
  p.delta = static_cast<float*>(delta);
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sl = q_sl;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sl = k_sl;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sl = v_sl;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sl = o_sl;
  p.do_sb = do_sb;
  p.do_sh = do_sh;
  p.do_sl = do_sl;
  p.dq_sb = dq_sb;
  p.dq_sh = dq_sh;
  p.dq_sl = dq_sl;
  p.qs_sb = qs_sb;
  p.qs_sh = qs_sh;
  p.qs_sl = qs_sl;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.qscale = qscale;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return wg::launch<1>(p, B, s);
  if (D <= 128) return wg::launch<2>(p, B, s);
  return wg::launch<4>(p, B, s);
}
