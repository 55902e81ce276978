// Flash multi-head attention, forward only, in the [B, L, H*D] layout.
//
// Replaces: oneprot_tpu/kernels/flash_mha.py:_fwd_kernel (launched by _fwd,
// behind mha_attention). Same function: rotary applied to q and k inside the
// kernel from [L, D] tables, softmax in base 2 with scale*log2(e) folded into
// q and an additive key bias already in log2 units, a block-diagonal mask
// built from segment ids, and the base-2 log-sum-exp written beside the
// output for the backward pass.
//
// What bounds it on H100: at the hub's shapes (D = 64, L = 256..1024) the
// two products QK^T and PV are 4*L*D flops per query row against 4*D*2
// bytes of q/o traffic, far above the card's ~295 flop/byte ridge, so the
// bound is tensor-core operations. What stands in the way of it is moving
// K/V tiles into shared memory and rotating K there, once per query tile.
//
// Design: one CTA of eight warps per (query tile of 128 rows, head, batch).
// Each warp owns 16 query rows. 64-key tiles of K, V and the rotary tables
// stream through a two-stage cp.async ring in shared memory, so the next
// tile's copy overlaps this tile's products; K is rotated in place in f32
// once it lands. Products are mma.sync m16n8k16 (bf16 in, f32 accumulate)
// with ldmatrix fragment loads (transposed for V), the online softmax is in
// f32 registers, and the S accumulator fragments are re-packed in registers
// as the A operand of the PV product, so probabilities never touch shared
// memory. Heads are read straight from the [B, L, H*D] rows by stride (no
// transposes in device memory). Keys and queries past L are masked here
// (no padding of L to a tile multiple is needed), and head dims below 64
// are zero-filled in shared memory. Not done yet (later work): wgmma, TMA,
// warp specialisation.

#include "flash_mha_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 128;       // query rows per CTA, 16 per warp
constexpr int BK = 64;        // keys per streamed tile
constexpr int DP = 64;        // head width padded in shared memory
constexpr int LDS = DP + 8;   // row pitch (bf16) of q/k/v tiles: conflict-free ldmatrix
constexpr int NTHREADS = 256;

// shared memory layout, in bf16 elements (bias and segment ids as 32-bit
// words): two stages; the q tile shares the second one, whose first copy
// starts only after every warp holds its q fragments in registers
constexpr int Q_ELEMS = BQ * LDS;
constexpr int KV_ELEMS = BK * LDS;
constexpr int TAB_ELEMS = BK * DP;
constexpr int STAGE_ELEMS = 2 * KV_ELEMS + 2 * TAB_ELEMS + 2 * BK * 2;  // + bias, seg
static_assert(Q_ELEMS <= STAGE_ELEMS, "q tile must fit in a stage");
constexpr size_t SMEM_BYTES = (size_t)(2 * STAGE_ELEMS) * 2;

struct Stage {
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  __nv_bfloat16* cos;
  __nv_bfloat16* sin;
  float* bias;
  int* seg;
};

__device__ __forceinline__ Stage stage_at(__nv_bfloat16* smem, int s) {
  __nv_bfloat16* base = smem + s * STAGE_ELEMS;
  Stage st;
  st.k = base;
  st.v = st.k + KV_ELEMS;
  st.cos = st.v + KV_ELEMS;
  st.sin = st.cos + TAB_ELEMS;
  st.bias = reinterpret_cast<float*>(st.sin + TAB_ELEMS);
  st.seg = reinterpret_cast<int*>(st.bias + BK);
  return st;
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;          // [B, L] log2 units, or null
  const __nv_bfloat16* cos;   // [L, D] or null
  const __nv_bfloat16* sin;
  const int* seg;             // [B, L] or null
  __nv_bfloat16* out;         // [B, L, H*D]
  float* lse;                 // [B, H, L] base 2
  int L, H, D;
  float q_pre;                // log2(e) / sqrt(D)
};

// Start the copies of key tile kt into stage st: K, V and the rotary tables
// in 16-byte chunks, bias and segment ids in 4-byte words; rows past L and
// columns past D are zero-filled.
__device__ __forceinline__ void issue_tile(const Params& p, const Stage& st, int b,
                                           size_t head_off, int kt) {
  const int k0 = kt * BK;
  const int HD = p.H * p.D;
  for (int i = threadIdx.x; i < BK * (DP / 8); i += NTHREADS) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int key = k0 + r;
    const bool ok = key < p.L && c < p.D;
    const size_t off = ok ? head_off + (size_t)key * HD + c : 0;
    cp_async16(st.k + r * LDS + c, p.k + off, ok);
    cp_async16(st.v + r * LDS + c, p.v + off, ok);
    if (p.cos != nullptr) {
      const size_t toff = ok ? (size_t)key * p.D + c : 0;
      cp_async16(st.cos + r * DP + c, p.cos + toff, ok);
      cp_async16(st.sin + r * DP + c, p.sin + toff, ok);
    }
  }
  if (threadIdx.x < BK) {
    // a copy that reads nothing still names a valid address (here p.k)
    const int key = k0 + threadIdx.x;
    const size_t off = key < p.L ? (size_t)b * p.L + key : 0;
    const bool has_bias = key < p.L && p.bias != nullptr;
    const bool has_seg = key < p.L && p.seg != nullptr;
    cp_async4(st.bias + threadIdx.x,
              has_bias ? static_cast<const void*>(p.bias + off) : p.k, has_bias);
    cp_async4(st.seg + threadIdx.x,
              has_seg ? static_cast<const void*>(p.seg + off) : p.k, has_seg);
  }
}

// two CTAs per SM (at most 128 registers a thread), so one CTA's
// barriers overlap the other's products
__global__ void __launch_bounds__(NTHREADS, 2)
flash_mha_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem + STAGE_ELEMS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L, D = p.D, half = p.D / 2;
  const int HD = p.H * D;
  const size_t head_off = (size_t)b * L * HD + (size_t)h * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const int n_tiles = (L + BK - 1) / BK;

  issue_tile(p, stage_at(smem, 0), b, head_off, 0);
  cp_async_commit();

  // q tile: rotary in f32, times scale*log2(e), to bf16 in shared memory
  for (int i = threadIdx.x; i < BQ * (DP / 4); i += NTHREADS) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    const int row = q0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < L && c < D) {
      const __nv_bfloat16* qr = p.q + head_off + (size_t)row * HD;
      unpack4(*reinterpret_cast<const uint2*>(qr + c), x);
      if (p.cos != nullptr) {
        const bool low = c < half;
        const int pc = low ? c + half : c - half;
        float o[4];
        unpack4(*reinterpret_cast<const uint2*>(qr + pc), o);
        const size_t tr = (size_t)row * D;
        const uint2 cs = *reinterpret_cast<const uint2*>(p.cos + tr + c);
        const uint2 sn = *reinterpret_cast<const uint2*>(p.sin + tr + c);
        if (low) {
          rotate4(x, o, cs, cs, sn, sn);  // o's outputs are dropped
        } else {
          rotate4(o, x, cs, cs, sn, sn);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= p.q_pre;
    }
    *reinterpret_cast<uint2*>(Qs + r * LDS + c) = pack4(x);
  }
  int segq_a = 0, segq_b = 0;
  if (p.seg != nullptr) {
    segq_a = p.seg[(size_t)b * L + min(row_a, L - 1)];
    segq_b = p.seg[(size_t)b * L + min(row_b, L - 1)];
  }
  __syncthreads();

  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    // a0..a3: rows 0-7 / 8-15 of the warp's 16, columns 0-7 / 8-15 of the k-step
    const int r = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    ldsm_x4(qf[ks], Qs + r * LDS + ks * 16 + 8 * (lane >> 4));
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const Stage st = stage_at(smem, kt & 1);
    __syncthreads();  // every warp is done with the stage the next copy overwrites
    if (kt + 1 < n_tiles) {
      issue_tile(p, stage_at(smem, (kt + 1) & 1), b, head_off, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    if (p.cos != nullptr) {
      for (int i = threadIdx.x; i < BK * (half / 4); i += NTHREADS) {
        const int r = i / (half / 4), c = (i % (half / 4)) * 4;
        uint2* lo_p = reinterpret_cast<uint2*>(st.k + r * LDS + c);
        uint2* hi_p = reinterpret_cast<uint2*>(st.k + r * LDS + c + half);
        float lo[4], hi[4];
        unpack4(*lo_p, lo);
        unpack4(*hi_p, hi);
        const __nv_bfloat16* cr = st.cos + r * DP;
        const __nv_bfloat16* sr = st.sin + r * DP;
        rotate4(lo, hi, *reinterpret_cast<const uint2*>(cr + c),
                *reinterpret_cast<const uint2*>(cr + c + half),
                *reinterpret_cast<const uint2*>(sr + c),
                *reinterpret_cast<const uint2*>(sr + c + half));
        *lo_p = pack4(lo);
        *hi_p = pack4(hi);
      }
      __syncthreads();
    }
    const int k0 = kt * BK;

    // S = (q * scale * log2 e) K^T for this warp's 16 rows and 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < DP / 32; ++kp) {
        uint32_t kf[4];  // b0, b1 of k-steps 2kp and 2kp+1
        ldsm_x4(kf, st.k + (j * 8 + (lane & 7)) * LDS + kp * 32 + 8 * (lane >> 3));
        mma16816(s[j], qf[2 * kp], kf[0], kf[1]);
        mma16816(s[j], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
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
        s[j][e] += add_a;
        s[j][2 + e] += add_b;
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
    // a row with every logit at -inf so far keeps a finite reference point
    const float ref_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float ref_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = exp2f(m_a - ref_a), corr_b = exp2f(m_b - ref_b);
    m_a = mn_a;
    m_b = mn_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - ref_a);
      s[j][1] = exp2f(s[j][1] - ref_a);
      s[j][2] = exp2f(s[j][2] - ref_b);
      s[j][3] = exp2f(s[j][3] - ref_b);
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
        ldsm_x4_trans(vf, st.v + key * LDS + 8 * (2 * jp + (lane >> 4)));
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
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < D) {
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(p.out + head_off + (size_t)row_a * HD + col) =
            pack_bf16(acc[j][0] * inv_a, acc[j][1] * inv_a);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(p.out + head_off + (size_t)row_b * HD + col) =
            pack_bf16(acc[j][2] * inv_b, acc[j][3] * inv_b);
    }
  }
  if (t == 0) {
    float* lse_row = p.lse + ((size_t)b * p.H + h) * L;
    if (row_a < L) lse_row[row_a] = m_a + log2f(l_a);
    if (row_b < L) lse_row[row_b] = m_b + log2f(l_b);
  }
}

}  // namespace

// q, k, v, out: contiguous bf16 [B, L, H*D]; lse: f32 [B, H, L].
// bias: f32 [B, L] in log2 units or null; cos, sin: bf16 [L, D] or both
// null; seg: int32 [B, L] or null. q_pre = log2(e) / sqrt(D). The caller
// checks D % 8 == 0, D <= 64 and 16-byte aligned pointers. Returns
// cudaGetLastError() after the launch.
extern "C" int oneprot_flash_mha_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* cos,
                                     const void* sin, const void* seg, void* out,
                                     void* lse, int B, int L, int H, int D,
                                     float q_pre, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.cos = static_cast<const __nv_bfloat16*>(cos);
  p.sin = static_cast<const __nv_bfloat16*>(sin);
  p.seg = static_cast<const int*>(seg);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.L = L;
  p.H = H;
  p.D = D;
  p.q_pre = q_pre;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_mha_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
