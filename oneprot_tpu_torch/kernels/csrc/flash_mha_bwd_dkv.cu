// Flash multi-head attention backward, dk/dv pass, in the [B, L, H*D] layout.
//
// Replaces: oneprot_tpu/kernels/flash_mha.py:_bwd_dkv_kernel (launched by
// _bwd, behind the custom vjp of mha_attention). Same function: for each
// key row, recompute p = exp2(s - lse) over every query from the forward's
// base-2 lse (s = rot(q) rot(k)^T * scale * log2(e) + bias * log2(e),
// -1e30 across segments), then dv = p^T dO, dS = p (dO v^T - delta) and
// dk = R^T (dS^T rot(q)) * scale, with delta = rowsum(dO * O) given.
//
// What bounds it on H100: four products of 2 * L * D flops per key row and
// query tile (k q^T, v dO^T, p^T dO, dS^T q) against 2 * D * 2 bytes of k/v
// in and out: tensor-core operations. What stands in the way is moving q/dO
// tiles into shared memory and rotating and pre-scaling q there, once per
// key tile.
//
// Design (FA-2's dk/dv pass): one CTA of four warps per (64 key rows, head,
// batch); each warp owns 16 keys, holds its rotated k and its v as mma A
// fragments in registers, and accumulates dk and dv in f32 registers. The
// products are taken transposed (keys as rows), so p^T and dS^T come out of
// the accumulators in the A layout of the next product and never touch
// shared memory. 64-query tiles of q, dO, their rotary tables, lse, delta
// and segment ids stream through a two-stage cp.async ring; q is rotated
// and multiplied by scale * log2(e) in place once it lands, with the
// forward's rounding. mma.sync m16n8k16, bf16 in, f32 accumulate; the head
// dim is padded to DP = 32 or 64 with zeros in shared memory. At the end dk
// goes through shared memory in f32 for the transpose rotation; dv needs
// none. p is clamped as in the dq pass (see flash_mha_bwd_dq.cu).

#include "flash_mha_common.cuh"

namespace {

using namespace flash;

template <int DP>
struct Layout {
  static constexpr int LDS = DP + 8;  // row pitch (bf16): conflict-free ldmatrix
  static constexpr int TILE = BWD_TILE * LDS;
  static constexpr int TAB = BWD_TILE * DP;
  // q, dO, cos, sin tiles + lse, delta, segment ids (as 32-bit words)
  static constexpr int STAGE = 2 * TILE + 2 * TAB + 3 * BWD_TILE * 2;
  // k and v tiles, then two stages; dk (f32) reuses the stages at the end
  static constexpr size_t SMEM_BYTES = (size_t)(2 * BWD_ROWS * LDS + 2 * STAGE) * 2;
  static_assert(BWD_ROWS * DP * 4 <= 2 * STAGE * 2, "dk tile must fit the stages");
  static_assert((STAGE * 2) % 16 == 0, "stages must stay 16-byte aligned");
};

struct Stage {
  __nv_bfloat16* q;
  __nv_bfloat16* dout;
  __nv_bfloat16* cos;
  __nv_bfloat16* sin;
  float* lse;
  float* delta;
  int* seg;
};

template <int DP>
__device__ __forceinline__ Stage stage_at(__nv_bfloat16* base, int s) {
  using Lay = Layout<DP>;
  Stage st;
  st.q = base + s * Lay::STAGE;
  st.dout = st.q + Lay::TILE;
  st.cos = st.dout + Lay::TILE;
  st.sin = st.cos + Lay::TAB;
  st.lse = reinterpret_cast<float*>(st.sin + Lay::TAB);
  st.delta = st.lse + BWD_TILE;
  st.seg = reinterpret_cast<int*>(st.delta + BWD_TILE);
  return st;
}

template <int DP>
__device__ __forceinline__ void copy_q_tile(const BwdParams& p, const Stage& st, int b,
                                            int h, size_t head_off, int qt) {
  constexpr int LDS = Layout<DP>::LDS;
  const int q0 = qt * BWD_TILE, HD = p.H * p.D;
  copy_head_rows<DP, LDS>(st.q, p.q, head_off, q0, p.L, HD, p.D);
  copy_head_rows<DP, LDS>(st.dout, p.dout, head_off, q0, p.L, HD, p.D);
  if (p.cos != nullptr) {
    copy_table_rows<DP>(st.cos, p.cos, q0, p.L, p.D);
    copy_table_rows<DP>(st.sin, p.sin, q0, p.L, p.D);
  }
  const size_t lrow = ((size_t)b * p.H + h) * p.L;
  copy_row_words(st.lse, p.lse + lrow, q0, p.L, p.q);
  copy_row_words(st.delta, p.delta + lrow, q0, p.L, p.q);
  copy_row_words(st.seg, p.seg == nullptr ? nullptr : p.seg + (size_t)b * p.L, q0, p.L,
                 p.q);
}

template <int DP>
__global__ void __launch_bounds__(BWD_THREADS) flash_mha_bwd_dkv_kernel(const BwdParams p) {
  using Lay = Layout<DP>;
  constexpr int LDS = Lay::LDS;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Ks = smem;
  __nv_bfloat16* Vs = Ks + BWD_ROWS * LDS;
  __nv_bfloat16* stages = Vs + BWD_ROWS * LDS;

  const int k0 = blockIdx.x * BWD_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L, D = p.D, HD = p.H * p.D;
  const size_t head_off = (size_t)b * L * HD + (size_t)h * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int key_a = k0 + warp * 16 + g;  // this thread's two key rows
  const int key_b = key_a + 8;
  const int n_tiles = (L + BWD_TILE - 1) / BWD_TILE;
  const bool rotary = p.cos != nullptr;

  // group 0: k, v, the keys' rotary tables (in stage 1, free until query
  // tile 1) and query tile 0
  const Stage st1 = stage_at<DP>(stages, 1);
  copy_head_rows<DP, LDS>(Ks, p.k, head_off, k0, L, HD, D);
  copy_head_rows<DP, LDS>(Vs, p.v, head_off, k0, L, HD, D);
  if (rotary) {
    copy_table_rows<DP>(st1.cos, p.cos, k0, L, D);
    copy_table_rows<DP>(st1.sin, p.sin, k0, L, D);
  }
  copy_q_tile<DP>(p, stage_at<DP>(stages, 0), b, h, head_off, 0);
  cp_async_commit();

  // keys past L: bias -inf makes p = 0
  float bias_a = -INFINITY, bias_b = -INFINITY;
  if (key_a < L) bias_a = p.bias == nullptr ? 0.f : p.bias[(size_t)b * L + key_a];
  if (key_b < L) bias_b = p.bias == nullptr ? 0.f : p.bias[(size_t)b * L + key_b];
  int segk_a = 0, segk_b = 0;
  if (p.seg != nullptr) {
    segk_a = p.seg[(size_t)b * L + min(key_a, L - 1)];
    segk_b = p.seg[(size_t)b * L + min(key_b, L - 1)];
  }

  cp_async_wait<0>();
  __syncthreads();
  if (rotary) {
    rotate_scale_tile<DP, LDS>(Ks, st1.cos, st1.sin, D, true, false, 1.f);
    __syncthreads();
  }
  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  load_a_frags<DP, LDS>(kf, Ks, warp * 16, lane);
  load_a_frags<DP, LDS>(vf, Vs, warp * 16, lane);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int qt = 0; qt < n_tiles; ++qt) {
    const Stage st = stage_at<DP>(stages, qt & 1);
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (qt + 1 < n_tiles) {
      copy_q_tile<DP>(p, stage_at<DP>(stages, (qt + 1) & 1), b, h, head_off, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile qt has landed for every thread
    rotate_scale_tile<DP, LDS>(st.q, st.cos, st.sin, D, rotary, true, p.q_pre);
    __syncthreads();
    const int q0 = qt * BWD_TILE;

    // p^T: keys as rows, this tile's 64 queries as columns
    float s[BWD_TILE / 8][4];
    mma_rows_t<DP, LDS>(s, kf, st.q, lane);
#pragma unroll
    for (int j = 0; j < BWD_TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;
        float add_a = bias_a, add_b = bias_b;
        if (p.seg != nullptr) {
          const int sq = st.seg[qc];
          add_a += sq == segk_a ? 0.f : SEG_MASK;
          add_b += sq == segk_b ? 0.f : SEG_MASK;
        }
        const bool in = q0 + qc < L;
        const float lse = st.lse[qc];
        s[j][e] = in ? exp2f(fminf(s[j][e] + add_a - lse, 0.f)) : 0.f;
        s[j][2 + e] = in ? exp2f(fminf(s[j][2 + e] + add_b - lse, 0.f)) : 0.f;
      }
    }
    mma_acc<DP, LDS>(dv, s, st.dout, lane);  // dv += p^T dO

    float dp[BWD_TILE / 8][4];
    mma_rows_t<DP, LDS>(dp, vf, st.dout, lane);  // (dO v^T)^T
#pragma unroll
    for (int j = 0; j < BWD_TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = st.delta[j * 8 + 2 * t + e];
        dp[j][e] = s[j][e] * (dp[j][e] - dl);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - dl);
      }
    }
    mma_acc<DP, LDS>(dk, dp, st.q, lane);  // dk += dS^T (q * scale * log2 e)
  }

  // dv: no rotation, straight from the registers
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < D) {
      if (key_a < L)
        *reinterpret_cast<uint32_t*>(p.dv + head_off + (size_t)key_a * HD + col) =
            pack_bf16(dv[j][0], dv[j][1]);
      if (key_b < L)
        *reinterpret_cast<uint32_t*>(p.dv + head_off + (size_t)key_b * HD + col) =
            pack_bf16(dv[j][2], dv[j][3]);
    }
  }
  __syncthreads();  // the stages are free: dk goes through them in f32
  float* g_s = reinterpret_cast<float*>(stages);
  // q carried scale * log2(e); dk needs scale only: times ln 2
  acc_to_smem<DP>(g_s, dk, warp * 16, lane, LN2);
  __syncthreads();
  write_rotated_back<DP>(p.dk, g_s, p, head_off, k0);
}

template <int DP>
int launch(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = Layout<DP>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mha_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.L + BWD_ROWS - 1) / BWD_ROWS, p.H, B);
  flash_mha_bwd_dkv_kernel<DP><<<grid, BWD_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dk, dv: contiguous bf16 [B, L, H*D]; lse, delta: f32
// [B, H, L]; bias: f32 [B, L] in log2 units or null; cos, sin: bf16 [L, D]
// or both null; seg: int32 [B, L] or null. q_pre = log2(e) / sqrt(D). The
// caller checks D % 8 == 0, D <= 64 and 16-byte aligned pointers. Returns
// cudaGetLastError() after the launch.
extern "C" int oneprot_flash_mha_bwd_dkv(const void* q, const void* k, const void* v,
                                         const void* bias, const void* cos,
                                         const void* sin, const void* seg,
                                         const void* dout, const void* lse,
                                         const void* delta, void* dk, void* dv, int B,
                                         int L, int H, int D, float q_pre,
                                         void* stream) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.bias = static_cast<const float*>(bias);
  p.cos = static_cast<const __nv_bfloat16*>(cos);
  p.sin = static_cast<const __nv_bfloat16*>(sin);
  p.seg = static_cast<const int*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.L = L;
  p.H = H;
  p.D = D;
  p.q_pre = q_pre;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 32 ? launch<32>(p, B, s) : launch<64>(p, B, s);
}
