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
// and dv per row: tensor-core operations at the ESM2-15B width and above,
// which only wgmma reaches.
//
// Design (`wg`, sm_90a): FA-2's dk/dv pass as a warp-specialised Hopper
// kernel. Warpgroup 0 is the producer (one warp issues TMA and loads lse
// and delta; setmaxnreg gives its registers to the others), warpgroups 1
// and 2 compute. The producer TMA-loads the CTA's K and V rows once (4-D
// tensor maps over the strided [B, L, H, D] projections, 128-byte swizzle)
// and streams 64-query tiles of q_s and dO, with their lse and delta,
// through a two-stage mbarrier ring. The products are taken transposed,
// keys as rows. Masking is explicit, never by TMA's zero fill: keys past
// Lk take bias -inf, queries past Lq lse = +inf (p = 0) and delta = 0.
// Heads are zero-filled by TMA up to the instance's width: 64, 128 or 256.
//
// Heads up to 128 wide (`consumer`): a CTA owns 128 keys of one (batch,
// head), 64 a consumer warpgroup. S^T = K Q_s^T and dP^T = V dO^T are
// wgmma m64n64k16 from shared memory (K-major); dV += P^T dO and dK +=
// dS^T Q_s take bf16(P^T) and dS^T as the register A operand (the
// accumulator packed in place) and read the dO and q_s tiles MN-major
// (transpose bit), so p and dS never touch shared memory. dK and dV
// accumulate in f32 registers: 128 a thread at D = 128, beside 64 for S^T
// and dP^T, which is why the consumers take 240 registers from the
// producer.
//
// Heads wider than 128 (`consumer_wide`): a 64 x 256 f32 dK and dV would
// be 256 accumulator registers a thread, so the two consumer warpgroups
// split the columns instead of the keys. A CTA owns 64 keys; both
// warpgroups hold all 64 as the rows of their products. Warpgroup c
// computes S^T and dP^T for queries 32c..32c+31 of each tile (wgmma
// m64n32k16 over the 256 columns: each logit once in the CTA, no product
// taken twice), writes its halves of bf16(P^T) and bf16(dS^T) to shared
// memory (8 KB each, 128-byte swizzled as TMA would write them), and
// accumulates columns 128c..128c+127 of dK and dV (128 registers a
// thread): dV += P^T dO and dK += dS^T Q_s are SS wgmma m64n128k16 over the
// tile's 64 queries. Named barriers between the warpgroups: P^T complete
// (dV may start while dS^T is computed), dS^T complete, and both done with
// the previous tile's. Shared memory: K and V 64 KB, two q_s/dO stages 128
// KB, P^T and dS^T 16 KB.
//
// Packed rows: the producer lists the query tiles that share an id range
// with the CTA's keys (segment_tiles.cuh) and streams only those, each
// query's id beside its lse and delta; the skipped tiles' p and dS are 0.
//
// Any Lq, Lk >= 1 (Lq = Lk with segment ids). dk and dv are written by
// their own strides, in the [B, L, H, D] order of the projections.

#include "flash_attention_bwd.cuh"
#include "hopper.cuh"
#include "segment_tiles.cuh"

namespace {

using namespace fa_bwd;

// ---------------------------------------------------------------------------
// wgmma + TMA, heads of 64, 128 and 256 (NH = 1, 2, 4 blocks of 64 columns)

namespace wg {

using namespace hopper;

constexpr int BQ = 64;        // queries per streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // warpgroup 0 loads, 1 and 2 compute
// named barrier 1: the tile list is ready (the producer warp and the
// consumers); at NH = 4, 2-4 between the two consumer warpgroups: both
// halves of P^T written, both halves of dS^T written, both done reading the
// previous tile's
constexpr int BAR_LIST = 1;
constexpr int LISTENERS = 32 + 256;
constexpr int BAR_P = 2, BAR_DS = 3, BAR_FREE = 4;

struct alignas(64) Args {
  CUtensorMap k, v;      // boxes of 64 columns x Smem::KEYS rows
  CUtensorMap qs, dout;  // boxes of 64 columns x BQ rows
  Params p;
};

// Shared memory, in bytes from a 1024-aligned base; NH 64-column blocks of
// the head (1: D <= 64, 2: D <= 128, 4: D <= 256), each tile NH blocks of
// [rows][64]. At NH = 4 a CTA holds 64 keys, and P^T and dS^T pass between
// its two consumer warpgroups through shared memory (bf16 [KEYS][BQ] each,
// one 128-byte-swizzled block).
template <int NH>
struct Smem {
  static constexpr int KEYS = NH == 4 ? 64 : 128;  // keys per CTA
  static constexpr int KEY_BLOCK = KEYS * 128;
  static constexpr int Q_BLOCK = BQ * 128;
  static constexpr int K = 0;
  static constexpr int V = K + NH * KEY_BLOCK;
  static constexpr int QS = V + NH * KEY_BLOCK;             // [STAGES][NH] blocks
  static constexpr int DO = QS + STAGES * NH * Q_BLOCK;
  static constexpr int PT = DO + STAGES * NH * Q_BLOCK;     // bf16 P^T (NH = 4)
  static constexpr int DST = PT + (NH == 4 ? KEYS * BQ * 2 : 0);  // bf16 dS^T
  static constexpr int LSE = DST + (NH == 4 ? KEYS * BQ * 2 : 0);  // f32 [STAGES][BQ]
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
  const int count = segtiles::build_list<S::KEYS, BQ>(seg, Lq, k0, n_tiles, list, lane);
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

// bf16 pair (x, y) into a 128-byte-swizzled [rows][64] block at `base`:
// row r, columns c, c + 1 (c even), as TMA would have written them.
__device__ __forceinline__ void store_pair_sw128(uint8_t* base, int r, int c, float x,
                                                 float y) {
  *reinterpret_cast<uint32_t*>(base + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
      pack_bf16(x, y);
}

// Consumer warpgroup c (0 or 1) at NH = 4 (heads of 256). Both warpgroups
// hold the CTA's 64 keys as the rows of their products; warpgroup c takes
// queries 32c..32c+31 of each tile for S^T and dP^T (64 x 32 each, so each
// is computed once in the CTA) and columns 128c..128c+127 of dK and dV (64
// accumulator registers each a thread). Its halves of bf16(P^T) and
// bf16(dS^T) go to shared memory; once both halves are there, dV += P^T dO
// and dK += dS^T Q_s are SS wgmma m64n128 over the tile's 64 queries.
template <bool SEG>
__device__ __forceinline__ void consumer_wide(const Args& a, uint8_t* sm, int c, int k0,
                                              int h, int b) {
  using S = Smem<4>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* q_full = bars + 1;
  uint64_t* q_empty = bars + 1 + STAGES;
  const int tid = threadIdx.x - 128 * (c + 1);
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row_a = 16 * warp + lane / 4;  // this thread's two keys, in the CTA
  const int key_a = k0 + row_a;
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
  const uint32_t k_addr = smem_u32(sm + S::K);
  const uint32_t v_addr = smem_u32(sm + S::V);
  const uint32_t pt_addr = smem_u32(sm + S::PT);
  const uint32_t dst_addr = smem_u32(sm + S::DST);
  const int q_half = 32 * c;  // this warpgroup's queries of a tile

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(bars, 0);  // K and V landed

  named_bar_sync(BAR_LIST, LISTENERS);
  const int count = *reinterpret_cast<const int*>(sm + S::COUNT);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    mbar_wait(&q_full[s], (it / STAGES) & 1);
    const uint32_t qs_addr = smem_u32(sm + S::QS + s * 4 * S::Q_BLOCK);
    const uint32_t do_addr = smem_u32(sm + S::DO + s * 4 * S::Q_BLOCK);

    // S^T = K Q_s^T and dP^T = V dO^T for this warpgroup's 32 queries: 64
    // keys x 32, over the 256 columns of the head
    float st[16], dpt[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t kr = (kk / 4) * S::KEY_BLOCK + (kk % 4) * 32;
      const uint32_t kq = (kk / 4) * S::Q_BLOCK + q_half * 128 + (kk % 4) * 32;
      wgmma_ss_m64n32(st, desc_sw128(k_addr + kr, 16, 1024), desc_sw128(qs_addr + kq, 16, 1024),
                      kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t kr = (kk / 4) * S::KEY_BLOCK + (kk % 4) * 32;
      const uint32_t kq = (kk / 4) * S::Q_BLOCK + q_half * 128 + (kk % 4) * 32;
      wgmma_ss_m64n32(dpt, desc_sw128(v_addr + kr, 16, 1024), desc_sw128(do_addr + kq, 16, 1024),
                      kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T = exp2((s + bias) * log2 e - lse) (SEG_MASK across segments)
    const float* ls = lse_s + s * BQ + q_half;
    const int* ss = seg_s + s * BQ + q_half;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
    // the other warpgroup is done with the previous tile's P^T and dS^T
    if (it > 0) named_bar_sync(BAR_FREE, 256);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = q_half + 8 * j + 2 * t;
      store_pair_sw128(sm + S::PT, row_a, col, st[4 * j], st[4 * j + 1]);
      store_pair_sw128(sm + S::PT, row_a + 8, col, st[4 * j + 2], st[4 * j + 3]);
    }
    fence_proxy_async();  // P^T, written here, is read by wgmma
    named_bar_sync(BAR_P, 256);

    // dV[:, 128c..] += bf16(P^T) dO, over the tile's 64 queries
    wgmma_fence();
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n128_tb(dv, desc_sw128(pt_addr + kk * 32, 16, 1024),
                          desc_sw128(do_addr + 2 * c * S::Q_BLOCK + kk * 16 * 128, S::Q_BLOCK,
                                     1024),
                          1);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed (dV may still run)
    fence_regs(dpt);

    // dS^T = P^T (dP^T - delta)
    const float* dls = delta_s + s * BQ + q_half;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
      const int col = q_half + 8 * j + 2 * t;
      store_pair_sw128(sm + S::DST, row_a, col, st[4 * j + 0] * (dpt[4 * j + 0] - dl.x),
                       st[4 * j + 1] * (dpt[4 * j + 1] - dl.y));
      store_pair_sw128(sm + S::DST, row_a + 8, col, st[4 * j + 2] * (dpt[4 * j + 2] - dl.x),
                       st[4 * j + 3] * (dpt[4 * j + 3] - dl.y));
    }
    fence_proxy_async();
    named_bar_sync(BAR_DS, 256);

    // dK[:, 128c..] += bf16(dS^T) Q_s
    wgmma_fence();
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n128_tb(dk, desc_sw128(dst_addr + kk * 32, 16, 1024),
                          desc_sw128(qs_addr + 2 * c * S::Q_BLOCK + kk * 16 * 128, S::Q_BLOCK,
                                     1024),
                          1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(&q_empty[s]);  // this thread is done with the stage
  }

  store_rows<128>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl,
                  reinterpret_cast<const float(&)[16][4]>(dv), key_a, 128 * c, p.Lk, p.D,
                  lane, 1.f);
  store_rows<128>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl,
                  reinterpret_cast<const float(&)[16][4]>(dk), key_a, 128 * c, p.Lk, p.D,
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
  const int k0 = blockIdx.x * S::KEYS, h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) producer<NH>(a, sm, k0, h, b);
  } else {
    setmaxnreg_inc<240>();
    if constexpr (NH == 4)
      consumer_wide<SEG>(a, sm, threadIdx.x / 128 - 1, k0, h, b);
    else
      consumer<NH, SEG>(a, sm, threadIdx.x / 128 - 1, k0, h, b);
  }
}

template <int NH>
int launch(const Params& p, int B, cudaStream_t stream) {
  using S = Smem<NH>;
  const int smem = S::bytes((p.Lq + BQ - 1) / BQ);
  Args a;
  a.p = p;
  int rc = rows_map(&a.k, p.k, p.D, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, S::KEYS);
  if (rc == 0) rc = rows_map(&a.v, p.v, p.D, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, S::KEYS);
  if (rc == 0) rc = rows_map(&a.qs, p.q, p.D, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, BQ);
  if (rc == 0) rc = rows_map(&a.dout, p.dout, p.D, p.Lq, p.H, B, p.do_sl, p.do_sh, p.do_sb, BQ);
  if (rc != 0) return rc;
  auto kernel = p.seg == nullptr ? flash_attention_bwd_dkv_wgmma<NH, false>
                                 : flash_attention_bwd_dkv_wgmma<NH, true>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lk + S::KEYS - 1) / S::KEYS, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

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
  return wg::launch<4>(p, B, s);
}
