// FlashAttention-2 backward, dk/dv pass, over [B, H, L, D] with an additive
// key bias.
//
// Replaces: oneprot_tpu/kernels/flash_attention.py:_bwd_dkv_kernel (launched
// by _bwd, behind the custom vjp flash_attention). Same function: q is
// multiplied by bf16(1/sqrt(D)) and rounded to bf16; for each key and query
// row, s = (q k^T + bias) * log2(e) in f32 and p = exp2(s - lse) from the
// forward's base-2 lse; dv = bf16(p)^T dO; dS = p (dO v^T - delta), rounded
// to bf16, and dk = dS^T q_scaled with no further factor (q already carries
// 1/sqrt(D)). delta = rowsum(dO * O) comes in from the caller.
//
// What bounds it on H100: four products of 2 * Lq * D flops per key row
// (k q^T, v dO^T, p^T dO, dS^T q) against 4 * D * 2 bytes of k, v, dk and
// dv per row: tensor-core operations at the ESM2-15B width. What stands in
// the way: q and dO tiles come again from L2 for every key tile and are
// pre-scaled in shared memory each time, mma.sync (not wgmma), and A
// fragments re-read from shared memory at every query tile.
//
// Design (FA-2's dk/dv pass): one CTA of four warps per (key block, head,
// batch). The products are taken transposed, keys as rows, so p^T and dS^T
// come out of the accumulators in the A layout of the next product and
// never touch shared memory. The CTA's K and V rows sit in shared memory;
// query tiles of q, dO, lse and delta stream through a two-stage cp.async
// ring, and q is multiplied by bf16(1/sqrt(D)) in place once it lands, with
// the forward's rounding. mma.sync m16n8k16 (bf16 in, f32 accumulate);
// head widths 64, 128 and 256 at compile time, a D in between zero-filled.
// The known difficulty is registers: dk and dv accumulate in f32, 2 x 16 x
// D values a warp, which at D = 256 would be 256 registers a thread. So at
// 256 a CTA takes 32 keys and each pair of warps shares 16 of them, one
// warp for each half of the head dim: both recompute the same p and dS (the
// two products over D, so 1.5 times the work in all) and each keeps 128
// accumulator registers. At 64 and 128 each warp owns 16 keys and all of D;
// 128 streams 32-query tiles to keep p and dS at 16 registers each. Any
// Lq, Lk >= 1: queries past Lq give p = 0, keys past Lk take bias -inf.
// dk and dv are written by their own strides, in the [B, L, H, D] order of
// the projections.

#include "flash_attention_bwd.cuh"

namespace {

using namespace fa_bwd;

// DP: head width in shared memory; BQ: queries per streamed tile; DSPLIT:
// warps that share 16 keys, each with DP / DSPLIT columns of dk and dv
template <int DP, int BQ, int DSPLIT>
struct Cfg {
  static constexpr int KROWS = 4 * 16 / DSPLIT;  // keys per CTA
  static constexpr int DC = DP / DSPLIT;         // dk/dv columns per warp
  static constexpr int LDS = DP + 8;  // row pitch (bf16): conflict-free ldmatrix
  static constexpr int KV_ELEMS = KROWS * LDS;
  static constexpr int Q_ELEMS = BQ * LDS;
  static constexpr int STAGE_ELEMS = 2 * Q_ELEMS + 2 * BQ * 2;  // q, dO, f32 lse, delta
  // K and V rows, then two stages
  static constexpr size_t SMEM_BYTES = (size_t)(2 * KV_ELEMS + 2 * STAGE_ELEMS) * 2;
};

template <typename C, int DP, int BQ>
__device__ __forceinline__ void start_q_tile(const Params& p, __nv_bfloat16* st,
                                             const __nv_bfloat16* qh,
                                             const __nv_bfloat16* doh, size_t lrow,
                                             int qt) {
  const int q0 = qt * BQ;
  copy_rows<DP, C::LDS, BQ>(st, qh, q0, p.Lq, p.q_sl, p.D);
  copy_rows<DP, C::LDS, BQ>(st + C::Q_ELEMS, doh, q0, p.Lq, p.do_sl, p.D);
  float* words = reinterpret_cast<float*>(st + 2 * C::Q_ELEMS);
  copy_words<BQ>(words, p.lse + lrow, q0, p.Lq, qh);
  copy_words<BQ>(words + BQ, p.delta + lrow, q0, p.Lq, qh);
}

template <int DP, int BQ, int DSPLIT>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dkv_kernel(const Params p) {
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

  // group 0: the K and V rows and query tile 0
  copy_rows<DP, C::LDS, C::KROWS>(Ks, kh, k0, p.Lk, p.k_sl, p.D);
  copy_rows<DP, C::LDS, C::KROWS>(Vs, vh, k0, p.Lk, p.v_sl, p.D);
  start_q_tile<C, DP, BQ>(p, stages, qh, doh, lrow, 0);
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
    __nv_bfloat16* qs = stages + (qt & 1) * C::STAGE_ELEMS;
    const __nv_bfloat16* dos = qs + C::Q_ELEMS;
    const float* lse = reinterpret_cast<const float*>(qs + 2 * C::Q_ELEMS);
    const float* delta = lse + BQ;
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (qt + 1 < n_tiles) {
      start_q_tile<C, DP, BQ>(p, stages + ((qt + 1) & 1) * C::STAGE_ELEMS, qh, doh,
                              lrow, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile qt has landed for every thread
    scale_rows<DP, C::LDS, BQ>(qs, p.qscale);
    __syncthreads();
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
        s[j][e] = in ? exp2f((s[j][e] + bias_a) * LOG2E - l) : 0.f;
        s[j][2 + e] = in ? exp2f((s[j][2 + e] + bias_b) * LOG2E - l) : 0.f;
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
  auto kernel = flash_attention_bwd_dkv_kernel<DP, BQ, DSPLIT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lk + C::KROWS - 1) / C::KROWS, p.H, B);
  kernel<<<grid, THREADS, C::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dk, dv: bf16 [B, H, L, D] at the given element strides
// (batch, head, row; unit stride over D); bias: f32 [B, Lk] contiguous or
// null; lse (base 2) and delta: f32 [B, H, Lq] contiguous. qscale =
// bf16(1/sqrt(D)) as f32. The caller checks D % 8 == 0, 64 <= D <= 256,
// strides that are multiples of 8 and 16-byte aligned pointers. Returns
// cudaGetLastError() after the launch.
extern "C" int oneprot_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Lq, int Lk,
    int D, long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
    long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long do_sb,
    long long do_sh, long long do_sl, long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl, float qscale, void* stream) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
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
  p.qscale = qscale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64, 64, 1>(p, B, s);
  if (D <= 128) return launch<128, 32, 1>(p, B, s);
  return launch<256, 32, 2>(p, B, s);
}
