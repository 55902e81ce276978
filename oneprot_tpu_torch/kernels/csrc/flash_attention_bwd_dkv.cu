// FlashAttention-2 backward, dk/dv pass, over [B, H, L, D] with an additive
// key bias.
//
// Replaces: oneprot_tpu/kernels/flash_attention.py:_bwd_dkv_kernel (launched
// by _bwd, behind the custom vjp flash_attention). Same function: for each
// key and query row, s = (q_s k^T + bias) * log2(e) in f32 with q_s =
// bf16(q * bf16(1/sqrt(D))), and p = exp2(s - lse) from the forward's base-2
// lse; dv = bf16(p)^T dO; dS = p (dO v^T - delta), rounded to bf16, and dk =
// dS^T q_s with no further factor (q_s already carries 1/sqrt(D)); with
// segment ids (packed rows, Lq = Lk) a pair of unequal ids takes SEG_MASK
// on top of its bias, as in the forward (flash_attention_fwd.cu). q_s and
// delta = rowsum(dO * O) come in as the dq pass's prologue wrote them
// (flash_attention_bwd_dq.cu), so this pass launches after it.
//
// What bounds it on H100: four products of 2 * Lq * D flops per key row
// (k q_s^T, v dO^T, p^T dO, dS^T q_s) against 4 * D * 2 bytes of k, v, dk
// and dv per row: tensor-core operations at the ESM2-15B width, which only
// wgmma reaches.
//
// Design for heads up to 128 wide (`wg`, sm_90a): FA-2's dk/dv pass as a
// warp-specialised Hopper kernel. A CTA owns 128 keys of one (batch, head):
// warpgroup 0 is the producer (one warp issues TMA and loads lse and delta;
// setmaxnreg gives its registers to the others), warpgroups 1 and 2 each
// own 64 keys. The producer TMA-loads the CTA's K and V rows once (4-D
// tensor maps over the strided [B, L, H, D] projections, 128-byte swizzle)
// and streams 64-query tiles of q_s and dO, with their lse and delta,
// through a two-stage mbarrier ring. The products are taken transposed,
// keys as rows: S^T = K Q_s^T and dP^T = V dO^T are wgmma m64n64k16 from
// shared memory (K-major); dV += P^T dO and dK += dS^T Q_s take bf16(P^T)
// and dS^T as the register A operand (the accumulator packed in place) and
// read the dO and q_s tiles MN-major (transpose bit), so p and dS never
// touch shared memory. dK and dV accumulate in f32 registers: 128 a thread
// at D = 128, beside 64 for S^T and dP^T, which is why the consumers take
// 240 registers from the producer. Masking is explicit, never by TMA's zero
// fill: keys past Lk take bias -inf, queries past Lq lse = +inf (p = 0) and
// delta = 0. Heads narrower than 128 are zero-filled by TMA up to 64 or 128.
//
// Heads wider than 128 (`sm80`): the first, mma.sync version, chosen by
// head width at compile time (a 64 x 256 f32 dK and dV would be 256
// accumulator registers a thread). One CTA of four warps per 32 keys, each
// pair of warps sharing 16 keys, one warp for each half of the head dim:
// both recompute the same p and dS (1.5 times the products in all) and each
// keeps 128 accumulator registers. Query tiles of 32 stream through a
// two-stage cp.async ring; mma.sync m16n8k16 with ldmatrix fragments.
//
// Packed rows: the Hopper instance's producer lists the query tiles that
// share an id range with the CTA's 128 keys (segment_tiles.cuh) and streams
// only those, each query's id beside its lse and delta; the skipped tiles'
// p and dS are 0. The sm80 instance masks by the ids and visits every tile.
//
// Any Lq, Lk >= 1 (Lq = Lk with segment ids). dk and dv are written by
// their own strides, in the [B, L, H, D] order of the projections.

#include "flash_attention_bwd.cuh"
#include "hopper.cuh"
#include "segment_tiles.cuh"

namespace {

using namespace fa_bwd;

// ---------------------------------------------------------------------------
// Hopper instance: wgmma + TMA, heads up to 128

namespace wg {

using namespace hopper;

constexpr int KEYS = 128;     // keys per CTA, 64 per consumer warpgroup
constexpr int BQ = 64;        // queries per streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 compute
// named barrier 1: the tile list is ready (the producer warp and the
// consumers)
constexpr int BAR_LIST = 1;
constexpr int LISTENERS = 32 + 256;

struct alignas(64) Args {
  CUtensorMap k, v;      // boxes of 64 columns x KEYS rows
  CUtensorMap qs, dout;  // boxes of 64 columns x BQ rows
  Params p;
};

// Shared memory, in bytes from a 1024-aligned base; NH 64-column blocks of
// the head (1: D <= 64, 2: D <= 128), each tile NH blocks of [rows][64].
template <int NH>
struct Smem {
  static constexpr int KEY_BLOCK = KEYS * 128;
  static constexpr int Q_BLOCK = BQ * 128;
  static constexpr int K = 0;
  static constexpr int V = K + NH * KEY_BLOCK;
  static constexpr int QS = V + NH * KEY_BLOCK;             // [STAGES][NH] blocks
  static constexpr int DO = QS + STAGES * NH * Q_BLOCK;
  static constexpr int LSE = DO + STAGES * NH * Q_BLOCK;    // f32 [STAGES][BQ]
  static constexpr int DELTA = LSE + STAGES * BQ * 4;       // f32 [STAGES][BQ]
  static constexpr int SEG = DELTA + STAGES * BQ * 4;       // int [STAGES][BQ]
  static constexpr int BARS = SEG + STAGES * BQ * 4;  // kv_full, q_full[STAGES], q_empty[STAGES]
  static constexpr int COUNT = BARS + 8 * (1 + 2 * STAGES);  // the list's length
  static constexpr int LIST = COUNT + 16;                     // int [n_tiles]
  static int bytes(int n_tiles) { return LIST + 4 * n_tiles + 1024; }  // + alignment slack
};

// One warp: K and V once, the list of query tiles to visit, then q_s, dO,
// lse, delta and the segment ids tile by tile.
template <int NH>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, int k0, int h, int b) {
  using S = Smem<NH>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* q_full = bars + 1;
  uint64_t* q_empty = bars + 1 + STAGES;
  float* lse_s = reinterpret_cast<float*>(sm + S::LSE);
  float* delta_s = reinterpret_cast<float*>(sm + S::DELTA);
  const int lane = threadIdx.x % 32;
  const int Lq = a.p.Lq;
  const size_t lrow = ((size_t)b * a.p.H + h) * Lq;
  const int* seg = a.p.seg == nullptr ? nullptr : a.p.seg + (size_t)b * Lq;
  int* seg_s = reinterpret_cast<int*>(sm + S::SEG);
  if (lane == 0) {
    mbar_arrive_expect_tx(bars, 2 * NH * S::KEY_BLOCK);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load_4d(sm + S::K + c * S::KEY_BLOCK, &a.k, bars, 64 * c, k0, h, b);
      tma_load_4d(sm + S::V + c * S::KEY_BLOCK, &a.v, bars, 64 * c, k0, h, b);
    }
  }
  const int n_tiles = (Lq + BQ - 1) / BQ;
  int* list = reinterpret_cast<int*>(sm + S::LIST);
  const int count = segtiles::build_list<KEYS, BQ>(seg, Lq, k0, n_tiles, list, lane);
  if (lane == 0) *reinterpret_cast<int*>(sm + S::COUNT) = count;
  named_bar_arrive(BAR_LIST, LISTENERS);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    const int q0 = list[it] * BQ;
    mbar_wait(&q_empty[s], ((it / STAGES) & 1) ^ 1);
    // queries past Lq: lse +inf (p = 0) and delta 0
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      const bool in = q0 + i < Lq;
      lse_s[s * BQ + i] = in ? a.p.lse[lrow + q0 + i] : INFINITY;
      delta_s[s * BQ + i] = in ? a.p.delta[lrow + q0 + i] : 0.f;
      if (seg != nullptr) seg_s[s * BQ + i] = seg[min(q0 + i, Lq - 1)];
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_full[s], 2 * NH * S::Q_BLOCK);
#pragma unroll
      for (int c = 0; c < NH; ++c) {
        tma_load_4d(sm + S::QS + (s * NH + c) * S::Q_BLOCK, &a.qs, &q_full[s], 64 * c, q0, h, b);
        tma_load_4d(sm + S::DO + (s * NH + c) * S::Q_BLOCK, &a.dout, &q_full[s], 64 * c, q0, h,
                    b);
      }
    } else {
      mbar_arrive(&q_full[s]);
    }
  }
}

template <int NH, bool SEG>
__device__ __forceinline__ void consumer(const Args& a, uint8_t* sm, int c, int k0, int h,
                                         int b) {
  using S = Smem<NH>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* q_full = bars + 1;
  uint64_t* q_empty = bars + 1 + STAGES;
  const int tid = threadIdx.x - 128 * (c + 1);
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int key_a = k0 + 64 * c + 16 * warp + lane / 4;  // this thread's two keys
  const int key_b = key_a + 8;
  // keys past Lk: bias -inf makes p = 0
  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * p.Lk;
  float bias_a = -INFINITY, bias_b = -INFINITY;
  if (key_a < p.Lk) bias_a = bias == nullptr ? 0.f : bias[key_a];
  if (key_b < p.Lk) bias_b = bias == nullptr ? 0.f : bias[key_b];
  const float* lse_s = reinterpret_cast<const float*>(sm + S::LSE);
  const float* delta_s = reinterpret_cast<const float*>(sm + S::DELTA);
  const int* seg_s = reinterpret_cast<const int*>(sm + S::SEG);
  int seg_a = 0, seg_b = 0;  // this thread's keys' ids
  if (SEG) {
    seg_a = p.seg[(size_t)b * p.Lk + min(key_a, p.Lk - 1)];
    seg_b = p.seg[(size_t)b * p.Lk + min(key_b, p.Lk - 1)];
  }
  const uint32_t k_addr = smem_u32(sm + S::K + c * 64 * 128);
  const uint32_t v_addr = smem_u32(sm + S::V + c * 64 * 128);

  float dk[32 * NH], dv[32 * NH];
#pragma unroll
  for (int i = 0; i < 32 * NH; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(bars, 0);  // K and V landed

  named_bar_sync(BAR_LIST, LISTENERS);
  const int count = *reinterpret_cast<const int*>(sm + S::COUNT);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    mbar_wait(&q_full[s], (it / STAGES) & 1);
    const uint32_t qs_addr = smem_u32(sm + S::QS + s * NH * S::Q_BLOCK);
    const uint32_t do_addr = smem_u32(sm + S::DO + s * NH * S::Q_BLOCK);

    // S^T = K Q_s^T and dP^T = V dO^T: 64 keys x 64 queries, over the head dim
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < 4 * NH; ++kk) {
      const uint32_t kr = (kk / 4) * S::KEY_BLOCK + (kk % 4) * 32;
      const uint32_t kq = (kk / 4) * S::Q_BLOCK + (kk % 4) * 32;
      wgmma_ss_m64n64(st, desc_sw128(k_addr + kr, 16, 1024), desc_sw128(qs_addr + kq, 16, 1024),
                      kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * NH; ++kk) {
      const uint32_t kr = (kk / 4) * S::KEY_BLOCK + (kk % 4) * 32;
      const uint32_t kq = (kk / 4) * S::Q_BLOCK + (kk % 4) * 32;
      wgmma_ss_m64n64(dpt, desc_sw128(v_addr + kr, 16, 1024), desc_sw128(do_addr + kq, 16, 1024),
                      kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T = exp2((s + bias) * log2 e - lse) (SEG_MASK across segments),
    // then dV += bf16(P^T) dO
    const float* ls = lse_s + s * BQ;
    const int* ss = seg_s + s * BQ;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      float add[4] = {bias_a, bias_a, bias_b, bias_b};
      if (SEG) {
        const int2 qq = *reinterpret_cast<const int2*>(ss + 8 * j + 2 * t);
        add[0] = seg_bias(add[0], qq.x, seg_a);
        add[1] = seg_bias(add[1], qq.y, seg_a);
        add[2] = seg_bias(add[2], qq.x, seg_b);
        add[3] = seg_bias(add[3], qq.y, seg_b);
      }
      st[4 * j + 0] = bwd_prob(st[4 * j + 0], add[0], l.x);
      st[4 * j + 1] = bwd_prob(st[4 * j + 1], add[1], l.y);
      st[4 * j + 2] = bwd_prob(st[4 * j + 2], add[2], l.x);
      st[4 * j + 3] = bwd_prob(st[4 * j + 3], add[3], l.y);
    }
    uint32_t pa[4][4];
    a_operand(pa, st);
    wgmma_fence();
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<NH>(dv, pa[kk], desc_sw128(do_addr + kk * 16 * 128, S::Q_BLOCK, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed (dV may still run)
    fence_regs(dpt);

    // dS^T = P^T (dP^T - delta), then dK += bf16(dS^T) Q_s
    const float* dls = delta_s + s * BQ;
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
      wgmma_rs_tb<NH>(dk, da[kk], desc_sw128(qs_addr + kk * 16 * 128, S::Q_BLOCK, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(&q_empty[s]);  // this thread is done with the stage
  }

  store_rows<64 * NH>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl,
                      reinterpret_cast<const float(&)[8 * NH][4]>(dv), key_a, 0, p.Lk, p.D,
                      lane, 1.f);
  store_rows<64 * NH>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl,
                      reinterpret_cast<const float(&)[8 * NH][4]>(dk), key_a, 0, p.Lk, p.D,
                      lane, 1.f);
}

template <int NH, bool SEG>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_dkv_wgmma(const __grid_constant__ Args a) {
  using S = Smem<NH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // kv_full: the producer's expect_tx, then TMA's bytes
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);            // q_full: the producer warp
      mbar_init(bars + 1 + STAGES + s, 256);  // q_empty: every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int k0 = blockIdx.x * KEYS, h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) producer<NH>(a, sm, k0, h, b);
  } else {
    setmaxnreg_inc<240>();
    consumer<NH, SEG>(a, sm, threadIdx.x / 128 - 1, k0, h, b);
  }
}

template <int NH>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = Smem<NH>::bytes((p.Lq + BQ - 1) / BQ);
  Args a;
  a.p = p;
  int rc = rows_map(&a.k, p.k, p.D, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, KEYS);
  if (rc == 0) rc = rows_map(&a.v, p.v, p.D, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, KEYS);
  if (rc == 0) rc = rows_map(&a.qs, p.q, p.D, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, BQ);
  if (rc == 0) rc = rows_map(&a.dout, p.dout, p.D, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, BQ);
  if (rc != 0) return rc;
  auto kernel = p.seg == nullptr ? flash_attention_bwd_dkv_wgmma<NH, false>
                                 : flash_attention_bwd_dkv_wgmma<NH, true>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lk + KEYS - 1) / KEYS, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// mma.sync instance: heads wider than 128

namespace sm80 {

// DP: head width in shared memory; BQ: queries per streamed tile; DSPLIT:
// warps that share 16 keys, each with DP / DSPLIT columns of dk and dv
template <int DP, int BQ, int DSPLIT>
struct Cfg {
  static constexpr int KROWS = 4 * 16 / DSPLIT;  // keys per CTA
  static constexpr int DC = DP / DSPLIT;         // dk/dv columns per warp
  static constexpr int LDS = DP + 8;  // row pitch (bf16): conflict-free ldmatrix
  static constexpr int KV_ELEMS = KROWS * LDS;
  static constexpr int Q_ELEMS = BQ * LDS;
  static constexpr int STAGE_ELEMS = 2 * Q_ELEMS + 3 * BQ * 2;  // q, dO, f32 lse, delta, int32 ids
  // K and V rows, then two stages
  static constexpr size_t SMEM_BYTES = (size_t)(2 * KV_ELEMS + 2 * STAGE_ELEMS) * 2;
};

template <typename C, int DP, int BQ>
__device__ __forceinline__ void start_q_tile(const Params& p, __nv_bfloat16* st,
                                             const __nv_bfloat16* qh,
                                             const __nv_bfloat16* doh, const int* seg,
                                             size_t lrow, int qt) {
  const int q0 = qt * BQ;
  copy_rows<DP, C::LDS, BQ>(st, qh, q0, p.Lq, p.q_sl, p.D);
  copy_rows<DP, C::LDS, BQ>(st + C::Q_ELEMS, doh, q0, p.Lq, p.do_sl, p.D);
  float* words = reinterpret_cast<float*>(st + 2 * C::Q_ELEMS);
  copy_words<BQ>(words, p.lse + lrow, q0, p.Lq, qh);
  copy_words<BQ>(words + BQ, p.delta + lrow, q0, p.Lq, qh);
  copy_words<BQ>(reinterpret_cast<int*>(words + 2 * BQ), seg, q0, p.Lq, qh);
}

template <int DP, int BQ, int DSPLIT>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dkv_mma(const Params p) {
  using C = Cfg<DP, BQ, DSPLIT>;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Ks = smem;
  __nv_bfloat16* Vs = Ks + C::KV_ELEMS;
  __nv_bfloat16* stages = Vs + C::KV_ELEMS;

  const int k0 = blockIdx.x * C::KROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vh = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* doh = p.dout + b * p.do_sb + h * p.do_sh;
  const size_t lrow = ((size_t)b * p.H + h) * p.Lq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int kg = warp / DSPLIT;               // the warp's 16 keys
  const int col0 = (warp % DSPLIT) * C::DC;   // and its columns of dk, dv
  const int key_a = k0 + kg * 16 + lane / 4;  // this thread's two keys
  const int key_b = key_a + 8;
  const int n_tiles = (p.Lq + BQ - 1) / BQ;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (size_t)b * p.Lk;
  const int seg_a = seg == nullptr ? 0 : seg[min(key_a, p.Lk - 1)];
  const int seg_b = seg == nullptr ? 0 : seg[min(key_b, p.Lk - 1)];

  // group 0: the K and V rows and query tile 0
  copy_rows<DP, C::LDS, C::KROWS>(Ks, kh, k0, p.Lk, p.k_sl, p.D);
  copy_rows<DP, C::LDS, C::KROWS>(Vs, vh, k0, p.Lk, p.v_sl, p.D);
  start_q_tile<C, DP, BQ>(p, stages, qh, doh, seg, lrow, 0);
  cp_async_commit();

  // keys past Lk: bias -inf makes p = 0
  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * p.Lk;
  float bias_a = -INFINITY, bias_b = -INFINITY;
  if (key_a < p.Lk) bias_a = bias == nullptr ? 0.f : bias[key_a];
  if (key_b < p.Lk) bias_b = bias == nullptr ? 0.f : bias[key_b];

  float dk[C::DC / 8][4], dv[C::DC / 8][4];
#pragma unroll
  for (int j = 0; j < C::DC / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  const __nv_bfloat16* k_warp = Ks + kg * 16 * C::LDS;
  const __nv_bfloat16* v_warp = Vs + kg * 16 * C::LDS;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const __nv_bfloat16* qs = stages + (qt & 1) * C::STAGE_ELEMS;
    const __nv_bfloat16* dos = qs + C::Q_ELEMS;
    const float* lse = reinterpret_cast<const float*>(qs + 2 * C::Q_ELEMS);
    const float* delta = lse + BQ;
    const int* sq = reinterpret_cast<const int*>(delta + BQ);
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (qt + 1 < n_tiles) {
      start_q_tile<C, DP, BQ>(p, stages + ((qt + 1) & 1) * C::STAGE_ELEMS, qh, doh, seg,
                              lrow, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile qt has landed for every thread
    const int q0 = qt * BQ;

    // p^T: this warp's 16 keys as rows, the tile's BQ queries as columns
    float s[BQ / 8][4];
    mma_a_xt<DP, C::LDS, BQ / 8>(s, k_warp, qs, lane);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;
        const bool in = q0 + qc < p.Lq;
        const float l = lse[qc];
        const float ba = seg == nullptr ? bias_a : seg_bias(bias_a, sq[qc], seg_a);
        const float bb = seg == nullptr ? bias_b : seg_bias(bias_b, sq[qc], seg_b);
        s[j][e] = in ? bwd_prob(s[j][e], ba, l) : 0.f;
        s[j][2 + e] = in ? bwd_prob(s[j][2 + e], bb, l) : 0.f;
      }
    }
    mma_s_x<C::DC, C::LDS, BQ>(dv, s, dos + col0, lane);  // dv += p^T dO

    float dp[BQ / 8][4];
    mma_a_xt<DP, C::LDS, BQ / 8>(dp, v_warp, dos, lane);  // (dO v^T)^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = delta[j * 8 + 2 * t + e];
        dp[j][e] = s[j][e] * (dp[j][e] - dl);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - dl);
      }
    }
    mma_s_x<C::DC, C::LDS, BQ>(dk, dp, qs + col0, lane);  // dk += dS^T q_scaled
  }

  store_rows<C::DC>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl, dv, key_a, col0, p.Lk,
                    p.D, lane, 1.f);
  store_rows<C::DC>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl, dk, key_a, col0, p.Lk,
                    p.D, lane, 1.f);
}

template <int DP, int BQ, int DSPLIT>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<DP, BQ, DSPLIT>;
  auto kernel = flash_attention_bwd_dkv_mma<DP, BQ, DSPLIT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lk + C::KROWS - 1) / C::KROWS, p.H, B);
  kernel<<<grid, THREADS, C::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm80

}  // namespace

// qs (q_s, from the dq pass), k, v, dout, dk, dv: bf16 [B, H, L, D] at the
// given element strides (batch, head, row; unit stride over D); bias: f32
// [B, Lk] contiguous or null; seg: int32 [B, L] contiguous segment ids (Lq =
// Lk = L) or null; lse (base 2) and delta (from the dq pass):
// f32 [B, H, Lq] contiguous. The caller checks D % 8 == 0, 64 <= D <= 256,
// strides that are multiples of 8 and 16-byte aligned pointers. Returns
// cudaGetLastError() after the launch, or hopper::ERR_* if a tensor map
// could not be made. `device`: the card's index.
extern "C" int oneprot_flash_attention_bwd_dkv(
    const void* qs, const void* k, const void* v, const void* bias, const void* seg,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Lq, int Lk,
    int D, long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
    long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long do_sb,
    long long do_sh, long long do_sl, long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl, int device, void* stream) {
  // cuTensorMapEncodeTiled needs the card's context current on this thread
  // (autograd runs the backward on a thread of its own)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(qs);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.bias = static_cast<const float*>(bias);
  p.seg = static_cast<const int*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sl = q_sl;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sl = k_sl;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sl = v_sl;
  p.do_sb = do_sb;
  p.do_sh = do_sh;
  p.do_sl = do_sl;
  p.dk_sb = dk_sb;
  p.dk_sh = dk_sh;
  p.dk_sl = dk_sl;
  p.dv_sb = dv_sb;
  p.dv_sh = dv_sh;
  p.dv_sl = dv_sl;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return wg::launch<1>(p, B, s);
  if (D <= 128) return wg::launch<2>(p, B, s);
  return sm80::launch<256, 32, 2>(p, B, s);
}
