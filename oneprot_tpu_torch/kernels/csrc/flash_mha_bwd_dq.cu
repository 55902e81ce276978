// Flash multi-head attention backward, dq pass, in the [B, L, H*D] layout.
//
// Replaces: oneprot_tpu/kernels/flash_mha.py:_bwd_dq_kernel (launched by
// _bwd, behind the custom vjp of mha_attention). Same function: for each
// query row, recompute the scaled logits s = rot(q) rot(k)^T * scale *
// log2(e) + bias * log2(e) (-1e30 across segments) and p = exp2(s - lse)
// from the forward's base-2 lse, then dS = p (dO v^T - delta) and
// dq = R^T (dS rot(k)) * scale, with delta = rowsum(dO * O) given.
//
// What bounds it on H100: three products of 2 * L * D flops per query row
// and key tile (q k^T, dO v^T, dS k) against 2 * D * 2 bytes of q/dO in and
// D * 2 of dq out: tensor-core operations, as for the forward. What stands
// in the way is moving K/V tiles into shared memory and rotating K there
// once per query tile.
//
// Design (FA-2's dq pass): one CTA of four warps per (64 query rows, head,
// batch); each warp owns 16 rows, holds its rotated, pre-scaled q and its
// dO as mma A fragments in registers, and accumulates dq in f32 registers.
// 64-key tiles of K, V, the rotary tables, bias and segment ids stream
// through a two-stage cp.async ring; K is rotated in place once it lands.
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulate); p and dS stay
// in registers, and dS is rounded to bf16 only as the A operand of dS k.
// The head dim is padded to DP = 32 or 64 in shared memory with zeros, so
// the padding adds nothing to any product. At the end dq goes through
// shared memory in f32 for the transpose rotation. p is exp2 of a value
// clamped at 0: the logits are recomputed as the forward computed them, so
// the clamp changes nothing but keeps padding rows of packed batches (whose
// logits sit at -1e9 and whose lse kept none of their digits) finite.

#include "flash_mha_common.cuh"

namespace {

using namespace flash;

template <int DP>
struct Layout {
  static constexpr int LDS = DP + 8;  // row pitch (bf16): conflict-free ldmatrix
  static constexpr int TILE = BWD_TILE * LDS;
  static constexpr int TAB = BWD_TILE * DP;
  // K, V, cos, sin tiles + bias and segment ids (as 32-bit words)
  static constexpr int STAGE = 2 * TILE + 2 * TAB + 2 * BWD_TILE * 2;
  // q and dO tiles, then two stages; dq (f32) reuses the stages at the end
  static constexpr size_t SMEM_BYTES = (size_t)(2 * BWD_ROWS * LDS + 2 * STAGE) * 2;
  static_assert(BWD_ROWS * DP * 4 <= 2 * STAGE * 2, "dq tile must fit the stages");
};

struct Stage {
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  __nv_bfloat16* cos;
  __nv_bfloat16* sin;
  float* bias;
  int* seg;
};

template <int DP>
__device__ __forceinline__ Stage stage_at(__nv_bfloat16* base, int s) {
  using Lay = Layout<DP>;
  Stage st;
  st.k = base + s * Lay::STAGE;
  st.v = st.k + Lay::TILE;
  st.cos = st.v + Lay::TILE;
  st.sin = st.cos + Lay::TAB;
  st.bias = reinterpret_cast<float*>(st.sin + Lay::TAB);
  st.seg = reinterpret_cast<int*>(st.bias + BWD_TILE);
  return st;
}

template <int DP>
__device__ __forceinline__ void copy_kv_tile(const BwdParams& p, const Stage& st, int b,
                                             size_t head_off, int kt) {
  constexpr int LDS = Layout<DP>::LDS;
  const int k0 = kt * BWD_TILE, HD = p.H * p.D;
  copy_head_rows<DP, LDS>(st.k, p.k, head_off, k0, p.L, HD, p.D);
  copy_head_rows<DP, LDS>(st.v, p.v, head_off, k0, p.L, HD, p.D);
  if (p.cos != nullptr) {
    copy_table_rows<DP>(st.cos, p.cos, k0, p.L, p.D);
    copy_table_rows<DP>(st.sin, p.sin, k0, p.L, p.D);
  }
  const size_t row_off = (size_t)b * p.L;
  copy_row_words(st.bias, p.bias == nullptr ? nullptr : p.bias + row_off, k0, p.L, p.k);
  copy_row_words(st.seg, p.seg == nullptr ? nullptr : p.seg + row_off, k0, p.L, p.k);
}

template <int DP>
__global__ void __launch_bounds__(BWD_THREADS) flash_mha_bwd_dq_kernel(const BwdParams p) {
  using Lay = Layout<DP>;
  constexpr int LDS = Lay::LDS;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem;
  __nv_bfloat16* dOs = Qs + BWD_ROWS * LDS;
  __nv_bfloat16* stages = dOs + BWD_ROWS * LDS;

  const int q0 = blockIdx.x * BWD_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L, D = p.D, HD = p.H * p.D;
  const size_t head_off = (size_t)b * L * HD + (size_t)h * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const int n_tiles = (L + BWD_TILE - 1) / BWD_TILE;
  const bool rotary = p.cos != nullptr;

  // group 0: q, dO, their rotary tables (in stage 1, free until tile 1) and
  // key tile 0
  const Stage st1 = stage_at<DP>(stages, 1);
  copy_head_rows<DP, LDS>(Qs, p.q, head_off, q0, L, HD, D);
  copy_head_rows<DP, LDS>(dOs, p.dout, head_off, q0, L, HD, D);
  if (rotary) {
    copy_table_rows<DP>(st1.cos, p.cos, q0, L, D);
    copy_table_rows<DP>(st1.sin, p.sin, q0, L, D);
  }
  copy_kv_tile<DP>(p, stage_at<DP>(stages, 0), b, head_off, 0);
  cp_async_commit();

  const size_t lrow = ((size_t)b * p.H + h) * L;
  // rows past L: lse = +inf makes p = 0
  const float lse_a = row_a < L ? p.lse[lrow + row_a] : INFINITY;
  const float lse_b = row_b < L ? p.lse[lrow + row_b] : INFINITY;
  const float dl_a = row_a < L ? p.delta[lrow + row_a] : 0.f;
  const float dl_b = row_b < L ? p.delta[lrow + row_b] : 0.f;
  int segq_a = 0, segq_b = 0;
  if (p.seg != nullptr) {
    segq_a = p.seg[(size_t)b * L + min(row_a, L - 1)];
    segq_b = p.seg[(size_t)b * L + min(row_b, L - 1)];
  }

  cp_async_wait<0>();
  __syncthreads();
  rotate_scale_tile<DP, LDS>(Qs, st1.cos, st1.sin, D, rotary, true, p.q_pre);
  __syncthreads();
  uint32_t qf[DP / 16][4], dof[DP / 16][4];
  load_a_frags<DP, LDS>(qf, Qs, warp * 16, lane);
  load_a_frags<DP, LDS>(dof, dOs, warp * 16, lane);

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const Stage st = stage_at<DP>(stages, kt & 1);
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (kt + 1 < n_tiles) {
      copy_kv_tile<DP>(p, stage_at<DP>(stages, (kt + 1) & 1), b, head_off, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    if (rotary) {
      rotate_scale_tile<DP, LDS>(st.k, st.cos, st.sin, D, true, false, 1.f);
      __syncthreads();
    }
    const int k0 = kt * BWD_TILE;

    float s[BWD_TILE / 8][4];
    mma_rows_t<DP, LDS>(s, qf, st.k, lane);
#pragma unroll
    for (int j = 0; j < BWD_TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = j * 8 + 2 * t + e;
        float add_a = -INFINITY, add_b = -INFINITY;
        if (k0 + kc < L) {
          add_a = add_b = st.bias[kc];
          if (p.seg != nullptr) {
            const int sk = st.seg[kc];
            add_a += sk == segq_a ? 0.f : SEG_MASK;
            add_b += sk == segq_b ? 0.f : SEG_MASK;
          }
        }
        s[j][e] = exp2f(fminf(s[j][e] + add_a - lse_a, 0.f));
        s[j][2 + e] = exp2f(fminf(s[j][2 + e] + add_b - lse_b, 0.f));
      }
    }

    float dp[BWD_TILE / 8][4];
    mma_rows_t<DP, LDS>(dp, dof, st.v, lane);
#pragma unroll
    for (int j = 0; j < BWD_TILE / 8; ++j) {
      dp[j][0] = s[j][0] * (dp[j][0] - dl_a);
      dp[j][1] = s[j][1] * (dp[j][1] - dl_a);
      dp[j][2] = s[j][2] * (dp[j][2] - dl_b);
      dp[j][3] = s[j][3] * (dp[j][3] - dl_b);
    }
    mma_acc<DP, LDS>(acc, dp, st.k, lane);
  }

  __syncthreads();  // the stages are free: dq goes through them in f32
  float* g_s = reinterpret_cast<float*>(stages);
  acc_to_smem<DP>(g_s, acc, warp * 16, lane, p.scale);
  __syncthreads();
  write_rotated_back<DP>(p.dq, g_s, p, head_off, q0);
}

template <int DP>
int launch(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = Layout<DP>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mha_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.L + BWD_ROWS - 1) / BWD_ROWS, p.H, B);
  flash_mha_bwd_dq_kernel<DP><<<grid, BWD_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq: contiguous bf16 [B, L, H*D]; lse, delta: f32
// [B, H, L]; bias: f32 [B, L] in log2 units or null; cos, sin: bf16 [L, D]
// or both null; seg: int32 [B, L] or null. q_pre = log2(e) / sqrt(D),
// scale = 1 / sqrt(D). The caller checks D % 8 == 0, D <= 64 and 16-byte
// aligned pointers. Returns cudaGetLastError() after the launch.
extern "C" int oneprot_flash_mha_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* bias, const void* cos,
                                        const void* sin, const void* seg,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dq, int B, int L,
                                        int H, int D, float q_pre, float scale,
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
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.L = L;
  p.H = H;
  p.D = D;
  p.q_pre = q_pre;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 32 ? launch<32>(p, B, s) : launch<64>(p, B, s);
}
