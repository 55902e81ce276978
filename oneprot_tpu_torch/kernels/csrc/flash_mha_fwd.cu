// Flash multi-head attention, forward only, in the [B, L, H*D] layout.
//
// Replaces: oneprot_tpu/kernels/flash_mha.py:_fwd_kernel (launched by _fwd,
// behind mha_attention). Same function: rotary applied to q and k inside the
// kernel from [L, D] tables, q_r = rot(q) * bf16(log2(e) / sqrt(D)) and
// rot(k) in bf16 arithmetic (each product and sum rounded, as the TPU
// kernel's bf16 arithmetic rounds it: mha_bwd::rot4, so q_r equals the dq
// kernel's bit for bit), softmax in base 2 with an additive key bias
// already in log2 units, a block-diagonal mask built from segment ids
// (-1e30 across segments), the row max started at -1e30 and the row sum
// clamped at 1e-30 (a row whose keys are all masked stays finite), and the
// base-2 log-sum-exp written beside the output for the backward pass.
//
// What bounds it on H100: at the hub's shapes (D = 64, L = 256..1024) the
// two products QK^T and PV are 4*L*D flops per query row against 4*D*2
// bytes of q/o traffic, far above the card's ~295 flop/byte ridge, so the
// bound is tensor-core operations; the exp2 of the softmax (one per logit)
// comes next, then the rotation of q and k (bf16x2 arithmetic, once per
// row).
// On packed rows the work is in the (query, key) pairs that share a
// segment, so the kernel visits only the key tiles that hold such pairs.
//
// Design (sm_90a; the mainloop is flash_fwd.cuh's). Two launches. With
// rotary, `rotate_k` first writes rot(k) once per (batch, head) into a
// scratch [B, L, H*D] tensor: rotating each landed K tile in shared memory
// instead, as the TPU kernel does, repeats the rotation once per query tile
// (8 times at L = 1024), and the first version of this kernel, which did
// that with three warps, spent its time there (PERF.md, PR 11). Then one CTA
// per 128 query rows of one (batch, head). Warp 0 TMA-loads the CTA's q rows
// and their rotary rows once, builds the list of key tiles that share a
// segment with the CTA's block (the skip rule of the backward kernels: min /
// max of the ids other than -1 and a padding flag per tile; without
// segment ids, every tile), and streams those tiles of rot(k) and V through
// a three-stage mbarrier ring, with each key's bias and segment id by plain
// loads. Warpgroups 1 and 2 each rotate and scale their 64 rows of q in
// place (then fence.proxy.async) and run the online softmax: S = q_r K^T is
// an SS wgmma, P stays in registers as the A operand of O += P V. Heads up
// to 32 wide take 64-byte rows with the 64-byte swizzle and 64-key tiles
// (DP = 32: the 35M tower's D = 24 pads to 32, not 64), wider ones up to 64
// take 128-byte rows and 128-key tiles. Keys past L get bias -inf (TMA's
// zero fill is no mask); queries past L are not stored. Any L >= 1.

#include <type_traits>

#include "flash_fwd.cuh"
#include "flash_mha_bwd.cuh"

namespace {

using namespace fwd;

constexpr int STAGES = 3;
constexpr int BAR_LIST = 1;   // named barrier: the tile list is ready (warp 0 and
constexpr int LISTENERS = 32 + CONSUMERS;  // the consumers)

struct Params {
  const float* bias;   // [B, L] key bias in log2 units, or null
  const int* seg;      // [B, L] segment ids (-1 on padding), or null
  __nv_bfloat16* out;  // [B, L, H*D]
  float* lse;          // [B, H, L] base 2
  int L, H, D;
  float q_pre;         // bf16(log2(e) / sqrt(D))
  bool rotary;         // cos / sin tables given
};

struct alignas(64) Args {
  CUtensorMap q, k, v, cos, sin;  // k: rot(k) with rotary
  Params p;
};

// Shared memory, in bytes from a 1024-aligned base. BK: keys a tile.
template <int DP, int BK>
struct Smem {
  using Hd = Head<DP>;
  static constexpr int TQ = Hd::bytes(BQ);
  static constexpr int TK = Hd::bytes(BK);
  static constexpr int Q = 0;        // q, then q_r
  static constexpr int CQ = Q + TQ;  // the query rows' rotary tables
  static constexpr int SQ = CQ + TQ;
  static constexpr int STAGE = SQ + TQ;  // [STAGES] x (K, V)
  static constexpr int STAGE_BYTES = 2 * TK;
  static constexpr int BIAS = STAGE + STAGES * STAGE_BYTES;  // f32 [STAGES][BK]
  static constexpr int SEG = BIAS + STAGES * BK * 4;          // int [STAGES][BK]
  static constexpr int BARS = SEG + STAGES * BK * 4;  // q_full, kv_full[STAGES], kv_empty[STAGES]
  static constexpr int COUNT = BARS + 8 * (1 + 2 * STAGES);  // the list's length
  static constexpr int LIST = COUNT + 16;                     // int [n_tiles]
  static int bytes(int n_tiles) { return LIST + 4 * n_tiles + 1024; }  // + alignment slack
};

// ---- rot(k), once ----------------------------------------------------------------

constexpr int ROTATE_THREADS = 256;

// rot(k) of every (row, head) into k_rot, both [B, L, H*D]; a thread takes
// the same W columns (4, or 8 when D / 2 is a multiple of 8: 16-byte
// accesses) of a head's two halves (mha_bwd::rot4, bf16 arithmetic as the
// consumers rotate q).
template <int W>
__global__ void __launch_bounds__(ROTATE_THREADS)
    rotate_k(const __nv_bfloat16* k, const __nv_bfloat16* cos, const __nv_bfloat16* sin,
             __nv_bfloat16* k_rot, long long n, int L, int H, int D) {
  using V = typename std::conditional<W == 8, uint4, uint2>::type;
  const long long i = (long long)blockIdx.x * ROTATE_THREADS + threadIdx.x;
  if (i >= n) return;
  const int half = D / 2, groups = half / W;
  const int g = static_cast<int>(i % groups);
  const long long rh = i / groups;  // (b * L + l) * H + h
  const int l = static_cast<int>((rh / H) % L);
  const long long lo = rh * D + W * g;  // [B, L, H*D] is [B * L * H, D]
  const int t = l * D + W * g;
  auto at = [](const __nv_bfloat16* p) { return *reinterpret_cast<const V*>(p); };
  V x_lo = at(k + lo), x_hi = at(k + lo + half);
  const V cl = at(cos + t), ch = at(cos + t + half), sl = at(sin + t), sh = at(sin + t + half);
  uint2* xl = reinterpret_cast<uint2*>(&x_lo);
  uint2* xh = reinterpret_cast<uint2*>(&x_hi);
#pragma unroll
  for (int u = 0; u < W / 4; ++u)
    mha_bwd::rot4(xl[u], xh[u], reinterpret_cast<const uint2*>(&cl)[u],
                  reinterpret_cast<const uint2*>(&ch)[u], reinterpret_cast<const uint2*>(&sl)[u],
                  reinterpret_cast<const uint2*>(&sh)[u]);
  *reinterpret_cast<V*>(k_rot + lo) = x_lo;
  *reinterpret_cast<V*>(k_rot + lo + half) = x_hi;
}

// ---- warpgroup 0 ---------------------------------------------------------------

// Warp 0: q and its rotary rows once, the tile list, then K (rot(k) with
// rotary), V, the bias and the segment ids tile by tile.
template <int DP, int BK>
__device__ __forceinline__ void producer(const Args& a, uint8_t* sm, int q0, int h, int b) {
  using S = Smem<DP, BK>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 1 + STAGES;
  const int lane = threadIdx.x % 32;
  const int L = p.L;
  if (lane == 0) {
    mbar_arrive_expect_tx(bars, (p.rotary ? 3 : 1) * S::TQ);
    tma_load_4d(sm + S::Q, &a.q, bars, 0, q0, h, b);
    if (p.rotary) {
      tma_load_4d(sm + S::CQ, &a.cos, bars, 0, q0, 0, 0);
      tma_load_4d(sm + S::SQ, &a.sin, bars, 0, q0, 0, 0);
    }
  }
  const int n_tiles = (L + BK - 1) / BK;
  int* list = reinterpret_cast<int*>(sm + S::LIST);
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (size_t)b * L;
  const int count = segtiles::build_list<BQ, BK>(seg, L, q0, n_tiles, list, lane);
  if (lane == 0) *reinterpret_cast<int*>(sm + S::COUNT) = count;
  named_bar_arrive(BAR_LIST, LISTENERS);

  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * L;
  float* bias_s = reinterpret_cast<float*>(sm + S::BIAS);
  int* seg_s = reinterpret_cast<int*>(sm + S::SEG);
  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    const int k0 = list[it] * BK;
    mbar_wait_or_trap(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
    // keys past L: bias -inf, so p = 0 there
#pragma unroll
    for (int e = 0; e < BK / 32; ++e) {
      const int i = lane + 32 * e, key = k0 + i;
      bias_s[s * BK + i] = key < L ? (bias == nullptr ? 0.f : bias[key]) : -INFINITY;
      seg_s[s * BK + i] = seg == nullptr ? 0 : seg[min(key, L - 1)];
    }
    if (lane == 0) {
      uint8_t* st = sm + S::STAGE + s * S::STAGE_BYTES;
      mbar_arrive_expect_tx(&kv_full[s], S::STAGE_BYTES);
      tma_load_4d(st, &a.k, &kv_full[s], 0, k0, h, b);
      tma_load_4d(st + S::TK, &a.v, &kv_full[s], 0, k0, h, b);
    } else {
      mbar_arrive(&kv_full[s]);
    }
  }
}

// ---- the consumers -------------------------------------------------------------

// Consumer warpgroup c (0 or 1): q_r in place on its 64 rows, the online
// softmax over the listed key tiles, then out and lse.
template <int DP, int BK>
__device__ __forceinline__ void consumer(const Args& a, uint8_t* sm, int c, int q0, int h,
                                         int b) {
  using S = Smem<DP, BK>;
  using Hd = Head<DP>;
  const Params& p = a.p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  const int tid = threadIdx.x - 128 * (c + 1);
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int rows = c * 64 * Hd::RB;  // this warpgroup's rows of a query tile

  mbar_wait_or_trap(bars, 0);  // q and the query rows' tables landed
  // 64 rows by 128 threads, as a backward CTA's consumers rotate q
  mha_bwd::rotate_rows<DP>(sm + S::Q + rows, sm + S::CQ + rows, sm + S::SQ + rows, p.D,
                           p.rotary, true, mha_bwd::bf2_splat(p.q_pre), tid);
  fence_proxy_async();  // q_r, written here, is read by wgmma
  named_bar_sync(2 + c, 128);

  const int row_a = q0 + 64 * c + 16 * warp + lane / 4;  // this thread's rows
  const bool segmented = p.seg != nullptr;
  int seg_r[2] = {0, 0};
  if (segmented) {
    seg_r[0] = p.seg[(size_t)b * p.L + min(row_a, p.L - 1)];
    seg_r[1] = p.seg[(size_t)b * p.L + min(row_a + 8, p.L - 1)];
  }
  const float* bias_s = reinterpret_cast<const float*>(sm + S::BIAS);
  const int* seg_s = reinterpret_cast<const int*>(sm + S::SEG);

  named_bar_sync(BAR_LIST, LISTENERS);
  const int count = *reinterpret_cast<const int*>(sm + S::COUNT);
  Ring ring;
  ring.k_addr = smem_u32(sm + S::STAGE);
  ring.stage_bytes = S::STAGE_BYTES;
  ring.v_off = S::TK;
  ring.ready = bars + 1;
  ring.empty = bars + 1 + STAGES;
  float o[DP / 2], m[2], l[2];
  attend<DP, BK, STAGES>(o, m, l, smem_u32(sm + S::Q + rows), ring, count,
                 [&](float (&sc)[BK / 2], int s) {
                   // s + bias (+ -1e30 across segments); keys past L at -inf
                   const float* bs = bias_s + s * BK;
                   const int* ss = seg_s + s * BK;
#pragma unroll
                   for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                     for (int e = 0; e < 4; ++e) {
                       const int kc = 8 * j + 2 * t + (e & 1);
                       float add = bs[kc];
                       if (segmented) add += ss[kc] == seg_r[e >> 1] ? 0.f : flash::SEG_MASK;
                       sc[4 * j + e] += add;
                     }
                 });

  float inv[2], lse[2];
  finish(m, l, inv, lse);
  const long long hd = (long long)p.H * p.D;
  __nv_bfloat16* oh = p.out + (size_t)b * p.L * hd + (size_t)h * p.D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= p.D) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_a + 8 * hh;
      if (row < p.L)
        *reinterpret_cast<uint32_t*>(oh + row * hd + col) =
            flash::pack_bf16(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
    }
  }
  if (t == 0) {
    float* lse_row = p.lse + ((size_t)b * p.H + h) * p.L;
    if (row_a < p.L) lse_row[row_a] = lse[0];
    if (row_a + 8 < p.L) lse_row[row_a + 8] = lse[1];
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(THREADS, 1)
    flash_mha_fwd_wgmma(const __grid_constant__ Args a) {
  using S = Smem<DP, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // q_full: the producer's expect_tx, then TMA's bytes
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);                  // kv_full: warp 0
      mbar_init(bars + 1 + STAGES + s, CONSUMERS);  // kv_empty: every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) producer<DP, BK>(a, sm, q0, h, b);
  } else {
    setmaxnreg_inc<232>();
    consumer<DP, BK>(a, sm, threadIdx.x / 128 - 1, q0, h, b);
  }
}

// The tensor map of a [B, L, H*D] projection (or, with H = B = 1 and row
// stride D, of an [L, D] rotary table), in tiles of `rows` rows x DP columns.
template <int DP>
int head_map(CUtensorMap* map, const void* base, int D, int L, int H, int B, int rows) {
  const long long hd = (long long)H * D;
  return rows_map(map, base, D, L, H, B, hd, D, L * hd, rows, Head<DP>::BOX_COLS,
                  Head<DP>::SWIZZLE);
}

template <int DP, int BK>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           __nv_bfloat16* k_rot, const Params& p, int B, cudaStream_t stream) {
  if (p.rotary) {
    const bool wide = (p.D / 2) % 8 == 0;
    const long long n = (long long)B * p.L * p.H * (p.D / (wide ? 16 : 8));
    const unsigned blocks = (unsigned)((n + ROTATE_THREADS - 1) / ROTATE_THREADS);
    auto kern = wide ? rotate_k<8> : rotate_k<4>;
    kern<<<blocks, ROTATE_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(cos),
        static_cast<const __nv_bfloat16*>(sin), k_rot, n, p.L, p.H, p.D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    k = k_rot;
  }
  Args a;
  a.p = p;
  int rc = head_map<DP>(&a.q, q, p.D, p.L, p.H, B, BQ);
  if (rc == 0) rc = head_map<DP>(&a.k, k, p.D, p.L, p.H, B, BK);
  if (rc == 0) rc = head_map<DP>(&a.v, v, p.D, p.L, p.H, B, BK);
  if (rc == 0 && p.rotary) rc = head_map<DP>(&a.cos, cos, p.D, p.L, 1, 1, BQ);
  if (rc == 0 && p.rotary) rc = head_map<DP>(&a.sin, sin, p.D, p.L, 1, 1, BQ);
  if (rc != 0) return rc;
  const int n_tiles = (p.L + BK - 1) / BK;
  const int smem = Smem<DP, BK>::bytes(n_tiles);
  auto kernel = flash_mha_fwd_wgmma<DP, BK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.L + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous bf16 [B, L, H*D]; lse: f32 [B, H, L]. bias: f32
// [B, L] in log2 units or null; cos, sin: bf16 [L, D] or both null; seg:
// int32 [B, L] or null; k_rot: scratch bf16 [B, L, H*D] for rot(k) (read
// only with the tables). q_pre = bf16(log2(e) / sqrt(D)). The caller checks
// D % 8 == 0, D <= 64 and 16-byte aligned pointers. Returns cudaGetLastError()
// after the launch, or hopper::ERR_* if a tensor map could not be made.
// `device`: the card's index.
extern "C" int oneprot_flash_mha_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* cos, const void* sin,
                                     const void* seg, void* out, void* lse, void* k_rot, int B,
                                     int L, int H, int D, float q_pre, int device,
                                     void* stream) {
  // cuTensorMapEncodeTiled needs the card's context current on this thread
  // (autograd runs a remat recompute on a thread of its own)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p = {};
  p.bias = static_cast<const float*>(bias);
  p.seg = static_cast<const int*>(seg);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.L = L;
  p.H = H;
  p.D = D;
  p.q_pre = q_pre;
  p.rotary = cos != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rot);
  return D <= 32 ? launch<32, 64>(q, k, v, cos, sin, kr, p, B, s)
                 : launch<64, 128>(q, k, v, cos, sin, kr, p, B, s);
}
