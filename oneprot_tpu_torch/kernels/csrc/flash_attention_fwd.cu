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
// Design for heads up to 128 wide (`wg`, sm_90a; the mainloop is
// flash_fwd.cuh's): FA-3's forward shape. A CTA owns 128 query rows of one
// (batch, head). Warp 0 is the producer (setmaxnreg gives its registers to
// the others): it TMA-loads the CTA's q rows once and streams 128-key tiles
// of K and V, with the tile's bias, through a four-stage mbarrier ring (4-D
// tensor maps over the strided [B, L, H, D] views, 128-byte swizzle).
// Warpgroups 1 and 2 each scale their 64 rows of q in place (then
// fence.proxy.async, since wgmma reads through the async proxy) and run the
// online softmax: S = Q K^T is an SS wgmma, P stays in registers as the A
// operand of O += P V (V read MN-major), and each tile's S is issued right
// behind the previous tile's P V. Masking is explicit, never by TMA's zero
// fill: keys past Lk get bias -inf (p = 0), queries past Lq are not
// stored. Heads narrower than 64 or between 64 and 128 are zero-filled by
// TMA up to 64 or 128.
//
// Heads wider than 128 (`sm80`): the first, mma.sync version. At 256 the
// 64 x 256 f32 output accumulator would take 128 registers a thread on top
// of S, so it stays on mma.sync: one CTA of four warps per 64 query rows,
// 16 rows a warp, 32-key tiles of K, V and the bias through a two-stage
// cp.async ring, ldmatrix fragments (transposed for V), q's fragments read
// from shared memory at each tile.
//
// Packed rows: the work is in the (query, key) pairs of equal ids, so the
// Hopper instance visits only the key tiles that share an id range with the
// CTA's 128 query rows (segment_tiles.cuh: warp 0 lists them before it
// streams them, with each key's id beside its bias; each consumer thread
// holds its two rows' ids in registers). The sm80 instance masks by the ids
// and visits every tile.
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
// Hopper instance: wgmma + TMA, heads up to 128

namespace wg {

using namespace fwd;

constexpr int STAGES = 4;  // the ring's depth: a tile's loads have three tiles' time
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
  static constexpr int Q = 0;
  static constexpr int STAGE = Q + Hd::bytes(BQ);  // [STAGES] x (K, V)
  static constexpr int KV = Hd::bytes(BK);
  static constexpr int STAGE_BYTES = 2 * KV;
  static constexpr int BIAS = STAGE + STAGES * STAGE_BYTES;  // f32 [STAGES][BK]
  static constexpr int SEG = BIAS + STAGES * BK * 4;          // int [STAGES][BK]
  static constexpr int BARS = SEG + STAGES * BK * 4;  // q_full, kv_full[STAGES], kv_empty[STAGES]
  static constexpr int COUNT = BARS + 8 * (1 + 2 * STAGES);  // the list's length
  static constexpr int LIST = COUNT + 16;                     // int [n_tiles]
  static int bytes(int n_tiles) { return LIST + 4 * n_tiles + 1024; }  // + alignment slack
};

// Warp 0: q once, the list of key tiles to visit, then K, V, the bias and
// the segment ids tile by tile.
template <int DP, int BK>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, int q0, int h, int b) {
  using S = Smem<DP, BK>;
  using Hd = Head<DP>;
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
    mbar_wait_or_trap(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
    // keys past Lk: bias -inf, so p = 0 there
#pragma unroll
    for (int e = 0; e < BK / 32; ++e) {
      const int key = k0 + lane + 32 * e;
      bias_s[s * BK + lane + 32 * e] =
          key < Lk ? (bias == nullptr ? 0.f : bias[key]) : -INFINITY;
      if (seg != nullptr) seg_s[s * BK + lane + 32 * e] = seg[min(key, Lk - 1)];
    }
    if (lane == 0) {
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

  mbar_wait_or_trap(bars, 0);  // q landed
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
  ring.empty = bars + 1 + STAGES;
  float o[DP / 2], m[2], l[2];
  attend<DP, BK, STAGES>(
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
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // q_full: the producer's expect_tx, then TMA's bytes
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);                  // kv_full: the producer warp
      mbar_init(bars + 1 + STAGES + s, CONSUMERS);  // kv_empty: every consumer thread
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

// ---------------------------------------------------------------------------
// mma.sync instance: heads wider than 128

namespace sm80 {

using namespace flash;

constexpr float ROW_MAX0 = -1e30f;
constexpr int DP = 256;     // head width in shared memory
constexpr int BK = 32;      // keys per streamed tile
constexpr int NWARPS = 4;   // 16 query rows each
constexpr int BQ = NWARPS * 16;
constexpr int NT = NWARPS * 32;
constexpr int LDS = DP + 8;  // row pitch (bf16): conflict-free ldmatrix
constexpr int Q_ELEMS = BQ * LDS;
constexpr int KV_ELEMS = BK * LDS;
constexpr int STAGE_ELEMS = 2 * KV_ELEMS + 4 * BK;  // K, V, f32 bias, int32 ids
constexpr size_t SMEM_BYTES = (size_t)(Q_ELEMS + 2 * STAGE_ELEMS) * 2;

// Start the copies of key tile kt into stage `st`: K and V rows in 16-byte
// chunks, the bias and the segment ids in 4-byte words; keys past Lk and
// columns past D are zero-filled.
__device__ __forceinline__ void issue_tile(const Params& p, __nv_bfloat16* st,
                                           const __nv_bfloat16* kh, const __nv_bfloat16* vh,
                                           const float* bias, const int* seg, int kt) {
  const int k0 = kt * BK;
  __nv_bfloat16* ks = st;
  __nv_bfloat16* vs = st + KV_ELEMS;
  float* bs = reinterpret_cast<float*>(st + 2 * KV_ELEMS);
  int* ss = reinterpret_cast<int*>(bs + BK);
  for (int i = threadIdx.x; i < BK * (DP / 8); i += NT) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int key = k0 + r;
    const bool ok = key < p.Lk && c < p.D;
    cp_async16(ks + r * LDS + c, ok ? kh + key * p.k_sl + c : kh, ok);
    cp_async16(vs + r * LDS + c, ok ? vh + key * p.v_sl + c : vh, ok);
  }
  if (threadIdx.x < BK) {
    // a copy that reads nothing still names a valid address (here kh)
    const int key = k0 + threadIdx.x;
    const bool ok = bias != nullptr && key < p.Lk;
    cp_async4(bs + threadIdx.x,
              ok ? static_cast<const void*>(bias + key) : static_cast<const void*>(kh), ok);
    const bool has = seg != nullptr && key < p.Lk;
    cp_async4(ss + threadIdx.x,
              has ? static_cast<const void*>(seg + key) : static_cast<const void*>(kh), has);
  }
}

__global__ void __launch_bounds__(NT, 2) flash_attention_fwd_mma(const Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem;
  __nv_bfloat16* stages = smem + Q_ELEMS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vh = p.v + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * p.Lk;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (size_t)b * p.Lk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const int n_tiles = (p.Lk + BK - 1) / BK;
  const int seg_a = seg == nullptr ? 0 : seg[min(row_a, p.Lk - 1)];
  const int seg_b = seg == nullptr ? 0 : seg[min(row_b, p.Lk - 1)];

  issue_tile(p, stages, kh, vh, bias, seg, 0);
  cp_async_commit();

  // q tile: times bf16(1/sqrt(D)) in f32, rounded once to bf16
  for (int i = threadIdx.x; i < BQ * (DP / 8); i += NT) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.Lq && c < p.D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qh + row * p.q_sl + c);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t* o = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(x[e]);
        o[e] = pack_bf16(f.x * p.scale, f.y * p.scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * LDS + c) = val;
  }
  __syncthreads();

  // a0..a3 of k-step ks: rows 0-7 / 8-15 of the warp's 16, columns 0-7 /
  // 8-15 of the k-step
  const __nv_bfloat16* q_frag_base =
      Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4);

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = ROW_MAX0, m_b = ROW_MAX0, l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const __nv_bfloat16* ks = stages + (kt & 1) * STAGE_ELEMS;
    const __nv_bfloat16* vs = ks + KV_ELEMS;
    const float* bs = reinterpret_cast<const float*>(ks + 2 * KV_ELEMS);
    const int* ss = reinterpret_cast<const int*>(bs + BK);
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (kt + 1 < n_tiles) {
      issue_tile(p, stages + ((kt + 1) & 1) * STAGE_ELEMS, kh, vh, bias, seg, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    const int k0 = kt * BK;

    // S = (q * scale) K^T for this warp's 16 rows and BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < DP / 32; ++kp) {
      uint32_t qa[4], qb[4];  // A fragments of k-steps 2kp and 2kp+1
      ldsm_x4(qa, q_frag_base + 2 * kp * 16);
      ldsm_x4(qb, q_frag_base + (2 * kp + 1) * 16);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t kf[4];  // b0, b1 of k-steps 2kp and 2kp+1
        ldsm_x4(kf, ks + (j * 8 + (lane & 7)) * LDS + kp * 32 + 8 * (lane >> 3));
        mma16816(s[j], qa, kf[0], kf[1]);
        mma16816(s[j], qb, kf[2], kf[3]);
      }
    }

    // (logits + bias) * log2 e, SEG_MASK across segments; keys past Lk at -inf
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = j * 8 + 2 * t + e;
        const bool ok = k0 + kc < p.Lk;
        const float bb = bs[kc];
        float ba = bb, bb2 = bb;
        if (seg != nullptr) {
          ba += ss[kc] == seg_a ? 0.f : SEG_MASK;
          bb2 += ss[kc] == seg_b ? 0.f : SEG_MASK;
        }
        s[j][e] = ok ? (s[j][e] + ba) * LOG2E : -INFINITY;
        s[j][2 + e] = ok ? (s[j][2 + e] + bb2) * LOG2E : -INFINITY;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_a);
      s[j][1] = exp2f(s[j][1] - mn_a);
      s[j][2] = exp2f(s[j][2] - mn_b);
      s[j][3] = exp2f(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * corr_a + sum_a;  // partial: the quad sums once at the end
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= corr_a;
      acc[j][1] *= corr_a;
      acc[j][2] *= corr_b;
      acc[j][3] *= corr_b;
    }

    // O += P V: the S fragments of key blocks 2kk, 2kk+1 are the A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < DP / 16; ++jp) {
        uint32_t vf[4];  // b0, b1 of d-blocks 2jp and 2jp+1
        const int key = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm_x4_trans(vf, vs + key * LDS + 8 * (2 * jp + (lane >> 4)));
        mma16816(acc[2 * jp], pf, vf[0], vf[1]);
        mma16816(acc[2 * jp + 1], pf, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  __nv_bfloat16* oh = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < p.D) {
      if (row_a < p.Lq)
        *reinterpret_cast<uint32_t*>(oh + row_a * p.o_sl + col) =
            pack_bf16(acc[j][0] * inv_a, acc[j][1] * inv_a);
      if (row_b < p.Lq)
        *reinterpret_cast<uint32_t*>(oh + row_b * p.o_sl + col) =
            pack_bf16(acc[j][2] * inv_b, acc[j][3] * inv_b);
    }
  }
  if (t == 0) {
    float* lse_row = p.lse + ((size_t)b * p.H + h) * p.Lq;
    if (row_a < p.Lq) lse_row[row_a] = m_a + log2f(l_a);
    if (row_b < p.Lq) lse_row[row_b] = m_b + log2f(l_b);
  }
}

int launch(const Params& p, int B, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, B);
  flash_attention_fwd_mma<<<grid, NT, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm80

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
  return sm80::launch(p, B, s);
}
