// FlashAttention-2 backward, dq pass, over [B, H, L, D] with an additive
// key bias.
//
// Replaces: oneprot_tpu/kernels/flash_attention.py:_bwd_dq_kernel (launched
// by _bwd, behind the custom vjp flash_attention). Same function: q is
// multiplied by bf16(1/sqrt(D)) and rounded to bf16; for each query row and
// key, s = (q k^T + bias) * log2(e) in f32 and p = exp2(s - lse) from the
// forward's base-2 lse; dS = p (dO v^T - delta), rounded to bf16 as the
// operand of dS k; dq = (dS k) * (1/sqrt(D) in f32), stored as bf16. delta =
// rowsum(dO * O) comes in from the caller, as the TPU kernel takes it.
//
// What bounds it on H100: three products of 2 * Lk * D flops per query row
// (q k^T, dO v^T, dS k) against 3 * D * 2 bytes of q, dO and dq per row: at
// the ESM2-15B width (D = 128, L up to 1024) far above the card's ~295
// flop/byte ridge, so tensor-core operations. What stands between the
// kernel and that bound: K and V come again from L2 for every query tile,
// mma.sync (not wgmma) runs the products, and A fragments are re-read from
// shared memory at every key tile.
//
// Design (FA-2's dq pass; not the TPU kernel's blocks, which hold a head's
// whole K and V in VMEM): one CTA of four warps per (64 query rows, head,
// batch), 16 rows a warp. The pre-scaled q tile and the dO tile sit in
// shared memory for the whole CTA; key tiles of K, V and the bias stream
// through a two-stage cp.async ring. Products are mma.sync m16n8k16 (bf16
// in, f32 accumulate) with ldmatrix fragment loads (transposed for dS k);
// p and dS stay in registers, and dq accumulates in f32 registers. Three
// compile-time head widths, 64, 128 and 256: a D in between is zero-filled
// up to the next one in shared memory, which adds nothing to any product.
// At 256 the 16 x 256 f32 dq accumulator alone is 128 registers a thread,
// so that instance streams 32-key tiles (64 at the others). Any Lq, Lk >=
// 1: queries past Lq take lse = +inf (p = 0) and keys past Lk p = 0. dq is
// written by its own (batch, head, row) strides, so it lands in the
// [B, L, H, D] order of the projections with no transpose copied.

#include "flash_attention_bwd.cuh"

namespace {

using namespace fa_bwd;

constexpr int ROWS = 64;  // query rows per CTA, 16 per warp

template <int DP, int BK>
struct Cfg {
  static constexpr int LDS = DP + 8;  // row pitch (bf16): conflict-free ldmatrix
  static constexpr int ROW_ELEMS = ROWS * LDS;
  static constexpr int KV_ELEMS = BK * LDS;
  static constexpr int STAGE_ELEMS = 2 * KV_ELEMS + 2 * BK;  // K, V, f32 bias
  // q and dO tiles, then two stages
  static constexpr size_t SMEM_BYTES = (size_t)(2 * ROW_ELEMS + 2 * STAGE_ELEMS) * 2;
};

template <typename C, int DP, int BK>
__device__ __forceinline__ void start_kv_tile(const Params& p, __nv_bfloat16* st,
                                              const __nv_bfloat16* kh,
                                              const __nv_bfloat16* vh,
                                              const float* bias, int kt) {
  const int k0 = kt * BK;
  copy_rows<DP, C::LDS, BK>(st, kh, k0, p.Lk, p.k_sl, p.D);
  copy_rows<DP, C::LDS, BK>(st + C::KV_ELEMS, vh, k0, p.Lk, p.v_sl, p.D);
  copy_words<BK>(reinterpret_cast<float*>(st + 2 * C::KV_ELEMS), bias, k0, p.Lk, kh);
}

template <int DP, int BK>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_dq_kernel(const Params p) {
  using C = Cfg<DP, BK>;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem;
  __nv_bfloat16* dOs = Qs + C::ROW_ELEMS;
  __nv_bfloat16* stages = dOs + C::ROW_ELEMS;

  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vh = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* doh = p.dout + b * p.do_sb + h * p.do_sh;
  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * p.Lk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row_a = q0 + warp * 16 + lane / 4;  // this thread's two query rows
  const int row_b = row_a + 8;
  const int n_tiles = (p.Lk + BK - 1) / BK;

  // group 0: the q and dO tiles and key tile 0
  copy_rows<DP, C::LDS, ROWS>(Qs, qh, q0, p.Lq, p.q_sl, p.D);
  copy_rows<DP, C::LDS, ROWS>(dOs, doh, q0, p.Lq, p.do_sl, p.D);
  start_kv_tile<C, DP, BK>(p, stages, kh, vh, bias, 0);
  cp_async_commit();

  const size_t lrow = ((size_t)b * p.H + h) * p.Lq;
  // rows past Lq: lse = +inf makes p = 0
  const float lse_a = row_a < p.Lq ? p.lse[lrow + row_a] : INFINITY;
  const float lse_b = row_b < p.Lq ? p.lse[lrow + row_b] : INFINITY;
  const float dl_a = row_a < p.Lq ? p.delta[lrow + row_a] : 0.f;
  const float dl_b = row_b < p.Lq ? p.delta[lrow + row_b] : 0.f;

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const __nv_bfloat16* q_warp = Qs + warp * 16 * C::LDS;
  const __nv_bfloat16* do_warp = dOs + warp * 16 * C::LDS;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const __nv_bfloat16* ks = stages + (kt & 1) * C::STAGE_ELEMS;
    const __nv_bfloat16* vs = ks + C::KV_ELEMS;
    const float* bs = reinterpret_cast<const float*>(ks + 2 * C::KV_ELEMS);
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (kt + 1 < n_tiles) {
      start_kv_tile<C, DP, BK>(p, stages + ((kt + 1) & 1) * C::STAGE_ELEMS, kh, vh,
                               bias, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt = 0 the q and dO tiles) landed
    if (kt == 0) {
      scale_rows<DP, C::LDS, ROWS>(Qs, p.qscale);
      __syncthreads();
    }
    const int k0 = kt * BK;

    // p = exp2((q k^T + bias) * log2 e - lse); keys past Lk at 0
    float s[BK / 8][4];
    mma_a_xt<DP, C::LDS, BK / 8>(s, q_warp, ks, lane);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = j * 8 + 2 * t + e;
        const bool ok = k0 + kc < p.Lk;
        const float bb = bs[kc];
        s[j][e] = ok ? exp2f((s[j][e] + bb) * LOG2E - lse_a) : 0.f;
        s[j][2 + e] = ok ? exp2f((s[j][2 + e] + bb) * LOG2E - lse_b) : 0.f;
      }
    }

    // dS = p (dO v^T - delta), then dq += dS k
    float dp[BK / 8][4];
    mma_a_xt<DP, C::LDS, BK / 8>(dp, do_warp, vs, lane);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      dp[j][0] = s[j][0] * (dp[j][0] - dl_a);
      dp[j][1] = s[j][1] * (dp[j][1] - dl_a);
      dp[j][2] = s[j][2] * (dp[j][2] - dl_b);
      dp[j][3] = s[j][3] * (dp[j][3] - dl_b);
    }
    mma_s_x<DP, C::LDS, BK>(acc, dp, ks, lane);
  }

  store_rows<DP>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sl, acc, row_a, 0, p.Lq,
                 p.D, lane, p.scale);
}

template <int DP, int BK>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<DP, BK>;
  auto kernel = flash_attention_bwd_dq_kernel<DP, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + ROWS - 1) / ROWS, p.H, B);
  kernel<<<grid, THREADS, C::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq: bf16 [B, H, L, D] at the given element strides (batch,
// head, row; unit stride over D); bias: f32 [B, Lk] contiguous or null;
// lse (base 2) and delta: f32 [B, H, Lq] contiguous. qscale =
// bf16(1/sqrt(D)) as f32, scale = 1/sqrt(D). The caller checks D % 8 == 0,
// 64 <= D <= 256, strides that are multiples of 8 and 16-byte aligned
// pointers. Returns cudaGetLastError() after the launch.
extern "C" int oneprot_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
    long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
    long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long do_sb,
    long long do_sh, long long do_sl, long long dq_sb, long long dq_sh, long long dq_sl,
    float qscale, float scale, void* stream) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
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
  p.dq_sb = dq_sb;
  p.dq_sh = dq_sh;
  p.dq_sl = dq_sl;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.qscale = qscale;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64, 64>(p, B, s);
  if (D <= 128) return launch<128, 64>(p, B, s);
  return launch<256, 32>(p, B, s);
}
