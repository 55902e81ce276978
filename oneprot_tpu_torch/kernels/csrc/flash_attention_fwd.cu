// FlashAttention-2 forward over [B, H, L, D] with an additive key bias.
//
// Replaces: oneprot_tpu/kernels/flash_attention.py:_fwd_kernel (launched by
// _fwd, behind the custom vjp flash_attention). Same function: q is
// multiplied by bf16(1/sqrt(D)) and rounded to bf16 before QK^T; the logits
// plus the f32 key bias are taken to base 2 (times log2(e)) under an online
// exp2 softmax started at -1e30; P is rounded to bf16 before PV; the row
// sum is clamped at 1e-30, so a row whose keys are all masked stays finite;
// out is bf16 and lse = m + log2(l) is f32, base 2. With segment ids (packed
// rows, self-attention: several proteins a row, -1 on padding) a logit
// whose query and key ids differ takes flash::SEG_MASK (-1e30) on top of
// its bias, the block-diagonal mask the JAX layer builds densely for heads
// over 64 (oneprot_tpu/models/esm2.py: packed_segment_bias, then XLA
// attention, since the TPU kernel takes no mask but a key bias).
//
// What bounds it on H100: at the ESM2-15B width (D = 128, L up to 1024) the
// two products are 4*Lk*D flops per query row against 4*D*2 bytes of q/k/v/o
// traffic per row, far above the card's ~295 flop/byte ridge, so the bound
// is tensor-core operations, which only wgmma reaches; the exp2 of the
// softmax (one per logit, on the special-function units) comes next.
//
// Design (`wg`, sm_90a; the mainloop is flash_fwd.cuh's): FA-3's forward
// shape, one template for every head width. A CTA owns 128 query rows of
// one (batch, head). Warp 0 is the producer (setmaxnreg gives its
// registers to the others): it TMA-loads the CTA's q rows once and streams
// key tiles of K and V (128 keys at heads up to 64, 64 above), with the
// tile's bias, through an mbarrier ring (4-D tensor maps over the strided
// [B, L, H, D] views, 128-byte swizzle). Warpgroups 1 and 2 each scale
// their 64 rows of q in place (then fence.proxy.async, since wgmma reads
// through the async proxy) and run the online softmax: S = Q K^T is an SS
// wgmma, P stays in registers as the A operand of O += P V (V read
// MN-major), and each tile's S is issued right behind the previous tile's
// P V. Masking is explicit, never by TMA's zero fill: keys past Lk get
// bias -inf (p = 0), queries past Lq are not stored. Heads are zero-filled
// by TMA up to the instance's width: 64, 128 or 256.
//
// Heads wider than 128 (DP = 256): four 64-column blocks a row. q takes 64
// KB and a stage of K and V 64 KB, so the ring is two stages deep (four at
// 64 and 128). With two stages a tile's loads would have only part of a
// tile's time, so K and V of a stage have barriers of their own (a split
// ring): K's half is refilled as soon as its S and logits are done, a tile
// ahead of V's. The 64 x 256 f32 output is 128 registers a consumer thread
// beside S's 32 and P's 16, within the 240 that setmaxnreg gives (its
// waits do not trap: see flash_fwd.cuh's ring_wait), and O += P V is one
// m64n256k16 a key-step of 16.
//
// Packed rows: the work is in the (query, key) pairs of equal ids, so the
// kernel visits only the key tiles that share an id range with the CTA's
// 128 query rows (segment_tiles.cuh: warp 0 lists them before it streams
// them, with each key's id beside its bias; each consumer thread holds its
// two rows' ids in registers).
//
// Any Lq, Lk >= 1 (Lq = Lk with segment ids). Each of q, k, v and out is
// read or written by its own (batch, head, row) strides with unit stride
// over D, so heads viewed out of a [B, L, H*D] projection need no copy.

#include "flash_fwd.cuh"
#include "flash_mha_common.cuh"
#include "segment_tiles.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;  // [B, H, Lq, D] by the strides below
  const __nv_bfloat16* k;  // [B, H, Lk, D]
  const __nv_bfloat16* v;
  const float* bias;       // [B, Lk] contiguous, natural-log units, or null
  const int* seg;          // [B, L] contiguous segment ids (Lq = Lk = L), or null
  __nv_bfloat16* out;      // [B, H, Lq, D]
  float* lse;              // [B, H, Lq] contiguous, base 2
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh,
      o_sl;                // element strides of batch, head and row
  int H, Lq, Lk, D;
  float scale;             // bf16(1 / sqrt(D)), as f32
};

// ---------------------------------------------------------------------------
// wgmma + TMA, heads of 64, 128 and 256 (DP)

namespace wg {

using namespace fwd;

// named barrier 3: the tile list is ready (warp 0 and the consumers; the
// consumers' own take 1 and 2, their turns 4 and 5)
constexpr int BAR_LIST = 3;
constexpr int LISTENERS = 32 + CONSUMERS;

struct alignas(64) Args {
  CUtensorMap q;     // boxes of 64 columns x BQ rows
  CUtensorMap k, v;  // boxes of 64 columns x BK rows
  Params p;
};

// Shared memory, in bytes from a 1024-aligned base. BK: keys a tile.
template <int DP, int BK>
struct Smem {
  using Hd = Head<DP>;
  // the ring's depth: four stages (a tile's loads have three tiles' time)
  // where they fit; at DP = 256 q alone takes 64 KB and a stage 64 KB, so two
  static constexpr int STAGES = DP > 128 ? 2 : 4;
  static constexpr int Q = 0;
  static constexpr int STAGE = Q + Hd::bytes(BQ);  // [STAGES] x (K, V)
  static constexpr int KV = Hd::bytes(BK);
  static constexpr int STAGE_BYTES = 2 * KV;
  static constexpr int BIAS = STAGE + STAGES * STAGE_BYTES;  // f32 [STAGES][BK]
  static constexpr int SEG = BIAS + STAGES * BK * 4;          // int [STAGES][BK]
  // K and V guarded apart (a split ring) where the ring is two stages deep
  static constexpr bool SPLIT = STAGES == 2;
  // q_full, kv_full[STAGES], kv_empty[STAGES], then v_full[STAGES],
  // v_empty[STAGES] in a split ring (kv_* guard K alone there)
  static constexpr int BARS = SEG + STAGES * BK * 4;
  static constexpr int COUNT = BARS + 8 * (1 + (SPLIT ? 4 : 2) * STAGES);  // the list's length
  static constexpr int LIST = COUNT + 16;                     // int [n_tiles]
  static int bytes(int n_tiles) { return LIST + 4 * n_tiles + 1024; }  // + alignment slack
};

// Warp 0: q once, the list of key tiles to visit, then K, V, the bias and
// the segment ids tile by tile.
template <int DP, int BK>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, int q0, int h, int b) {
  using S = Smem<DP, BK>;
  using Hd = Head<DP>;
  constexpr int STAGES = S::STAGES;
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
    mbar_arrive_expect_tx(bars, Hd::bytes(BQ));
#pragma unroll
    for (int c = 0; c < Hd::NB; ++c)
      tma_load_4d(sm + S::Q + c * BQ * Hd::RB, &a.q, bars, 64 * c, q0, h, b);
  }
  const int n_tiles = (Lk + BK - 1) / BK;
  int* list = reinterpret_cast<int*>(sm + S::LIST);
  const int count = segtiles::build_list<BQ, BK>(seg, Lk, q0, n_tiles, list, lane);
  if (lane == 0) *reinterpret_cast<int*>(sm + S::COUNT) = count;
  named_bar_arrive(BAR_LIST, LISTENERS);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    const int k0 = list[it] * BK;
    ring_wait<DP>(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
    // keys past Lk: bias -inf, so p = 0 there
#pragma unroll
    for (int e = 0; e < BK / 32; ++e) {
      const int key = k0 + lane + 32 * e;
      bias_s[s * BK + lane + 32 * e] =
          key < Lk ? (bias == nullptr ? 0.f : bias[key]) : -INFINITY;
      if (seg != nullptr) seg_s[s * BK + lane + 32 * e] = seg[min(key, Lk - 1)];
    }
    if constexpr (S::SPLIT) {
      uint8_t* st = sm + S::STAGE + s * S::STAGE_BYTES;
      uint64_t* v_full = kv_empty + STAGES;
      uint64_t* v_empty = v_full + STAGES;
      if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full[s], S::KV);
#pragma unroll
        for (int c = 0; c < Hd::NB; ++c)
          tma_load_4d(st + c * BK * Hd::RB, &a.k, &kv_full[s], 64 * c, k0, h, b);
        ring_wait<DP>(&v_empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&v_full[s], S::KV);
#pragma unroll
        for (int c = 0; c < Hd::NB; ++c)
          tma_load_4d(st + S::KV + c * BK * Hd::RB, &a.v, &v_full[s], 64 * c, k0, h, b);
      } else {
        mbar_arrive(&kv_full[s]);
      }
      __syncwarp();
    } else if (lane == 0) {
      uint8_t* st = sm + S::STAGE + s * S::STAGE_BYTES;
      mbar_arrive_expect_tx(&kv_full[s], S::STAGE_BYTES);
#pragma unroll
      for (int c = 0; c < Hd::NB; ++c) {
        tma_load_4d(st + c * BK * Hd::RB, &a.k, &kv_full[s], 64 * c, k0, h, b);
        tma_load_4d(st + S::KV + c * BK * Hd::RB, &a.v, &kv_full[s], 64 * c, k0, h, b);
      }
    } else {
      mbar_arrive(&kv_full[s]);
    }
  }
}

// Consumer warpgroup c (0 or 1): q * bf16(1/sqrt(D)) in place on its 64
// rows, the online softmax over the listed key tiles, then out and lse.
// SEG: with segment ids (an instance of its own, so that the registers the
// mask takes cost the unpacked rows nothing).
template <int DP, int BK, bool SEG>
__device__ __forceinline__ void consumer(const Args& a, uint8_t* sm, int c, int q0, int h,
                                         int b) {
  using S = Smem<DP, BK>;
  using Hd = Head<DP>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  const int tid = threadIdx.x - 128 * (c + 1);
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;

  ring_wait<DP>(bars, 0);  // q landed
  {
    // each row's 8 NB chunks of 16 bytes go to as many neighbouring threads
    constexpr int CH = 8 * Hd::NB;
    constexpr int RPP = 128 / CH;
    const int cc = tid % CH;
    const uint32_t scale2 = flash::pack_bf16(p.scale, p.scale);  // q * scale, rounded once
#pragma unroll
    for (int i = 0; i < 64 / RPP; ++i) {
      const int r = 64 * c + tid / CH + RPP * i;
      uint4* qp = reinterpret_cast<uint4*>(sm + S::Q + (cc / 8) * BQ * Hd::RB + r * 128 +
                                           (((cc % 8) ^ (r % 8)) << 4));
      uint4 x = *qp;
      x.x = bf2_mul(x.x, scale2);
      x.y = bf2_mul(x.y, scale2);
      x.z = bf2_mul(x.z, scale2);
      x.w = bf2_mul(x.w, scale2);
      *qp = x;
    }
  }
  fence_proxy_async();  // the scaled q, written here, is read by wgmma
  named_bar_sync(1 + c, 128);

  const int row_a = q0 + 64 * c + 16 * warp + lane / 4;  // this thread's rows
  int seg_r[2] = {0, 0};
  if (SEG) {
    seg_r[0] = p.seg[(size_t)b * p.Lk + min(row_a, p.Lk - 1)];
    seg_r[1] = p.seg[(size_t)b * p.Lk + min(row_a + 8, p.Lk - 1)];
  }
  const float* bias_s = reinterpret_cast<const float*>(sm + S::BIAS);
  const int* seg_s = reinterpret_cast<const int*>(sm + S::SEG);
  named_bar_sync(BAR_LIST, LISTENERS);
  const int count = *reinterpret_cast<const int*>(sm + S::COUNT);
  Ring ring;
  ring.k_addr = smem_u32(sm + S::STAGE);
  ring.stage_bytes = S::STAGE_BYTES;
  ring.v_off = S::KV;
  ring.ready = bars + 1;
  ring.empty = bars + 1 + S::STAGES;
  ring.v_ready = bars + 1 + 2 * S::STAGES;
  ring.v_empty = bars + 1 + 3 * S::STAGES;
  float o[DP / 2], m[2], l[2];
  attend<DP, BK, S::STAGES, S::SPLIT>(
      o, m, l, smem_u32(sm + S::Q + c * 64 * Hd::RB), ring, count,
      [&](float (&sc)[BK / 2], int s) {
        // (s + bias) * log2 e, the product rounded (no fused multiply-add
        // with the softmax's subtraction: on a row whose keys are all
        // masked the logits sit near -1.44e9, where an unrounded product
        // would weigh keys by 2^(+-64)); keys past Lk at -inf by their bias;
        // a key of another segment than the row's takes SEG_MASK on top
        const float* bs = bias_s + s * BK;
        const int* ss = seg_s + s * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
          float add[4] = {bb.x, bb.y, bb.x, bb.y};
          if (SEG) {
            const int2 kk = *reinterpret_cast<const int2*>(ss + 8 * j + 2 * t);
            add[0] += kk.x == seg_r[0] ? 0.f : flash::SEG_MASK;
            add[1] += kk.y == seg_r[0] ? 0.f : flash::SEG_MASK;
            add[2] += kk.x == seg_r[1] ? 0.f : flash::SEG_MASK;
            add[3] += kk.y == seg_r[1] ? 0.f : flash::SEG_MASK;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * j + e] = __fmul_rn(sc[4 * j + e] + add[e], LOG2E);
        }
      });

  float inv[2], lse[2];
  finish(m, l, inv, lse);
  __nv_bfloat16* oh = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= p.D) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_a + 8 * hh;
      if (row < p.Lq)
        *reinterpret_cast<uint32_t*>(oh + row * p.o_sl + col) =
            flash::pack_bf16(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
    }
  }
  if (t == 0) {
    float* lse_row = p.lse + ((size_t)b * p.H + h) * p.Lq;
    if (row_a < p.Lq) lse_row[row_a] = lse[0];
    if (row_a + 8 < p.Lq) lse_row[row_a + 8] = lse[1];
  }
}

template <int DP, int BK, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_fwd_wgmma(const __grid_constant__ Args a) {
  using S = Smem<DP, BK>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // q_full: the producer's expect_tx, then TMA's bytes
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);                  // kv_full: the producer warp
      mbar_init(bars + 1 + STAGES + s, CONSUMERS);  // kv_empty: every consumer thread
      if (S::SPLIT) {
        mbar_init(bars + 1 + 2 * STAGES + s, 1);          // v_full: the producer's lane 0
        mbar_init(bars + 1 + 3 * STAGES + s, CONSUMERS);  // v_empty
      }
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) producer<DP, BK>(a, sm, q0, h, b);
  } else {
    setmaxnreg_inc<240>();
    consumer<DP, BK, SEG>(a, sm, threadIdx.x / 128 - 1, q0, h, b);
  }
}

template <int DP, int BK>
int launch(const Params& p, int B, cudaStream_t stream) {
  using S = Smem<DP, BK>;
  const int smem = S::bytes((p.Lk + BK - 1) / BK);
  Args a;
  a.p = p;
  int rc = rows_map(&a.q, p.q, p.D, p.Lq, p.H, B, p.q_sl, p.q_sh, p.q_sb, BQ);
  if (rc == 0) rc = rows_map(&a.k, p.k, p.D, p.Lk, p.H, B, p.k_sl, p.k_sh, p.k_sb, BK);
  if (rc == 0) rc = rows_map(&a.v, p.v, p.D, p.Lk, p.H, B, p.v_sl, p.v_sh, p.v_sb, BK);
  if (rc != 0) return rc;
  auto kernel = p.seg == nullptr ? flash_attention_fwd_wgmma<DP, BK, false>
                                 : flash_attention_fwd_wgmma<DP, BK, true>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// q, k, v, out: bf16 [B, H, L, D] at the given element strides (batch,
// head, row; unit stride over D); bias: f32 [B, Lk] contiguous or null;
// seg: int32 [B, L] contiguous segment ids (-1 on padding; Lq = Lk = L) or
// null; lse: f32 [B, H, Lq] contiguous. scale = bf16(1/sqrt(D)) as f32. The
// caller checks D % 8 == 0, 64 <= D <= 256, strides that are multiples of 8
// and 16-byte aligned pointers. Returns cudaGetLastError() after the launch,
// or hopper::ERR_* if a tensor map could not be made. `device`: the card's
// index.
extern "C" int oneprot_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* seg,
    void* out, void* lse, int B, int H, int Lq, int Lk, int D, long long q_sb, long long q_sh,
    long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
    float scale, int device, void* stream) {
  // cuTensorMapEncodeTiled needs the card's context current on this thread
  // (autograd runs a remat recompute on a thread of its own)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.seg = static_cast<const int*>(seg);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
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
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return wg::launch<64, 128>(p, B, s);
  if (D <= 128) return wg::launch<128, 64>(p, B, s);
  return wg::launch<256, 64>(p, B, s);
}
