// FlashAttention-2 forward over [B, H, L, D] with an additive key bias.
//
// Replaces: oneprot_tpu/kernels/flash_attention.py:_fwd_kernel (launched by
// _fwd, behind the custom vjp flash_attention). Same function: q is
// multiplied by bf16(1/sqrt(D)) and rounded to bf16 before QK^T; the logits
// plus the f32 key bias are taken to base 2 (times log2(e)) under an online
// exp2 softmax started at -1e30; P is rounded to bf16 before PV; the row
// sum is clamped at 1e-30, so a row whose keys are all masked stays finite;
// out is bf16 and lse = m + log2(l) is f32, base 2.
//
// What bounds it on H100: at the ESM2-15B width (D = 128, L up to 1024) the
// two products are 4*Lk*D flops per query row against 4*D*2 bytes of q/k/v/o
// traffic per row, far above the card's ~295 flop/byte ridge, so the bound
// is tensor-core operations. What stands between the kernel and it: K and
// V come again from L2 for every query tile, and mma.sync (not wgmma) runs
// the products.
//
// Design: not the TPU kernel's blocks (it holds a head's whole K and V in
// VMEM). One CTA per (query tile, head, batch), 16 query rows per warp.
// Key tiles of K, V and the bias stream through a two-stage cp.async ring
// in shared memory, so the next tile's copy overlaps this tile's products.
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix
// fragment loads (transposed for V); the online softmax runs in f32
// registers, and the S accumulators are re-packed in registers as the A
// operand of PV. Three compile-time head widths, 64, 128 and 256: a D in
// between is zero-filled up to the next one in shared memory. At 256 the
// 16 x 256 f32 output accumulator alone is 128 registers a thread, so that
// instance takes 32-key tiles and reads q's fragments from shared memory at
// each tile instead of holding them. Any Lq, Lk >= 1: queries and keys past
// the ends are masked here. Each of q, k, v and out is read or written by
// its own (batch, head, row) strides with unit stride over D, so heads
// viewed out of a [B, L, H*D] projection need no copy. Not done yet (later
// work): wgmma, TMA, warp specialisation.

#include "flash_mha_common.cuh"

namespace {

using namespace flash;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float ROW_MAX0 = -1e30f;  // the TPU kernel's initial row max

struct Params {
  const __nv_bfloat16* q;  // [B, H, Lq, D] by the strides below
  const __nv_bfloat16* k;  // [B, H, Lk, D]
  const __nv_bfloat16* v;
  const float* bias;       // [B, Lk] contiguous, natural-log units, or null
  __nv_bfloat16* out;      // [B, H, Lq, D]
  float* lse;              // [B, H, Lq] contiguous, base 2
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh,
      o_sl;                // element strides of batch, head and row
  int H, Lq, Lk, D;
  float scale;             // bf16(1 / sqrt(D)), as f32
};

// DP: head width in shared memory; BK: keys per streamed tile; NWARPS:
// warps per CTA, 16 query rows each; QREG: hold q's fragments in registers
template <int DP, int BK, int NWARPS, bool QREG>
struct Cfg {
  static constexpr int BQ = NWARPS * 16;
  static constexpr int NT = NWARPS * 32;
  static constexpr int LDS = DP + 8;  // row pitch (bf16): conflict-free ldmatrix
  static constexpr int Q_ELEMS = BQ * LDS;
  static constexpr int KV_ELEMS = BK * LDS;
  static constexpr int STAGE_ELEMS = 2 * KV_ELEMS + 2 * BK;  // K, V, f32 bias
  static constexpr size_t SMEM_BYTES = (size_t)(Q_ELEMS + 2 * STAGE_ELEMS) * 2;
};

// Start the copies of key tile kt into stage `st`: K and V rows in 16-byte
// chunks, the bias in 4-byte words; keys past Lk and columns past D are
// zero-filled.
template <typename C, int DP, int BK>
__device__ __forceinline__ void issue_tile(const Params& p, __nv_bfloat16* st,
                                           const __nv_bfloat16* kh,
                                           const __nv_bfloat16* vh,
                                           const float* bias, int kt) {
  const int k0 = kt * BK;
  __nv_bfloat16* ks = st;
  __nv_bfloat16* vs = st + C::KV_ELEMS;
  float* bs = reinterpret_cast<float*>(st + 2 * C::KV_ELEMS);
  for (int i = threadIdx.x; i < BK * (DP / 8); i += C::NT) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int key = k0 + r;
    const bool ok = key < p.Lk && c < p.D;
    cp_async16(ks + r * C::LDS + c, ok ? kh + key * p.k_sl + c : kh, ok);
    cp_async16(vs + r * C::LDS + c, ok ? vh + key * p.v_sl + c : vh, ok);
  }
  if (threadIdx.x < BK) {
    // a copy that reads nothing still names a valid address (here kh)
    const int key = k0 + threadIdx.x;
    const bool ok = bias != nullptr && key < p.Lk;
    cp_async4(bs + threadIdx.x,
              ok ? static_cast<const void*>(bias + key) : static_cast<const void*>(kh),
              ok);
  }
}

template <int DP, int BK, int NWARPS, bool QREG>
__global__ void __launch_bounds__(NWARPS * 32, 2)
flash_attention_fwd_kernel(const Params p) {
  using C = Cfg<DP, BK, NWARPS, QREG>;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem;
  __nv_bfloat16* stages = smem + C::Q_ELEMS;

  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vh = p.v + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias == nullptr ? nullptr : p.bias + (size_t)b * p.Lk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const int n_tiles = (p.Lk + BK - 1) / BK;

  issue_tile<C, DP, BK>(p, stages, kh, vh, bias, 0);
  cp_async_commit();

  // q tile: times bf16(1/sqrt(D)) in f32, rounded once to bf16
  for (int i = threadIdx.x; i < C::BQ * (DP / 8); i += C::NT) {
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
    *reinterpret_cast<uint4*>(Qs + r * C::LDS + c) = val;
  }
  __syncthreads();

  // a0..a3 of k-step ks: rows 0-7 / 8-15 of the warp's 16, columns 0-7 /
  // 8-15 of the k-step
  const __nv_bfloat16* q_frag_base =
      Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDS + 8 * (lane >> 4);
  uint32_t qf[QREG ? DP / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) ldsm_x4(qf[ks], q_frag_base + ks * 16);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = ROW_MAX0, m_b = ROW_MAX0, l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const __nv_bfloat16* ks = stages + (kt & 1) * C::STAGE_ELEMS;
    const __nv_bfloat16* vs = ks + C::KV_ELEMS;
    const float* bs = reinterpret_cast<const float*>(ks + 2 * C::KV_ELEMS);
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (kt + 1 < n_tiles) {
      issue_tile<C, DP, BK>(p, stages + ((kt + 1) & 1) * C::STAGE_ELEMS, kh, vh, bias,
                            kt + 1);
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
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[2 * kp][e];
          qb[e] = qf[2 * kp + 1][e];
        }
      } else {
        ldsm_x4(qa, q_frag_base + 2 * kp * 16);
        ldsm_x4(qb, q_frag_base + (2 * kp + 1) * 16);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t kf[4];  // b0, b1 of k-steps 2kp and 2kp+1
        ldsm_x4(kf, ks + (j * 8 + (lane & 7)) * C::LDS + kp * 32 + 8 * (lane >> 3));
        mma16816(s[j], qa, kf[0], kf[1]);
        mma16816(s[j], qb, kf[2], kf[3]);
      }
    }

    // (logits + bias) * log2 e; keys past Lk at -inf
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = j * 8 + 2 * t + e;
        const bool ok = k0 + kc < p.Lk;
        const float bb = bs[kc];
        s[j][e] = ok ? (s[j][e] + bb) * LOG2E : -INFINITY;
        s[j][2 + e] = ok ? (s[j][2 + e] + bb) * LOG2E : -INFINITY;
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
        ldsm_x4_trans(vf, vs + key * C::LDS + 8 * (2 * jp + (lane >> 4)));
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

template <int DP, int BK, int NWARPS, bool QREG>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<DP, BK, NWARPS, QREG>;
  auto kernel = flash_attention_fwd_kernel<DP, BK, NWARPS, QREG>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + C::BQ - 1) / C::BQ, p.H, B);
  kernel<<<grid, C::NT, C::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: bf16 [B, H, L, D] at the given element strides (batch,
// head, row; unit stride over D); bias: f32 [B, Lk] contiguous or null;
// lse: f32 [B, H, Lq] contiguous. scale = bf16(1/sqrt(D)) as f32. The
// caller checks D % 8 == 0, 64 <= D <= 256, strides that are multiples of 8
// and 16-byte aligned pointers. Returns cudaGetLastError() after the launch.
extern "C" int oneprot_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int B, int H, int Lq, int Lk, int D, long long q_sb, long long q_sh,
    long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
    float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bias = static_cast<const float*>(bias);
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
  if (D <= 64) return launch<64, 64, 8, true>(p, B, s);
  if (D <= 128) return launch<128, 64, 4, true>(p, B, s);
  return launch<256, 32, 4, false>(p, B, s);
}
