// Tied-row attention of the MSA Transformer, forward only, in the
// [B, R, L, H*64] layout of the q/k/v projections.
//
// Replaces: oneprot_tpu/kernels/tied_row_attention.py:_kernel (launched by
// tied_row_attention). Same function: one attention map per (batch, head)
// shared by all R rows of the MSA,
//   logits[i, j] = scale * sum_r q[r, i, :] . k[r, j, :] + bias[j]
//   out[r, i, :] = sum_j softmax_j(logits)[i, j] * v[r, j, :],
// logits in f32, the softmax in base 2 (scale and bias come in log2 units),
// probabilities rounded to bf16 before the PV product, out in bf16. No
// [B, H, L, L] tensor goes to device memory.
//
// What bounds it on H100: 4 * L^2 * R * 64 flops per (batch, head) against
// 4 * R * L * 64 * 2 bytes of q/k/v/out, so the card's bound is tensor-core
// operations (0.21 ms at B=4 R=16 L=1024 H=12). What stands in the way of
// it here is the tied sum: a query column's logits need every row's keys,
// so the head dim of this attention is R*64 (1024 at R=16, 3200 at R=50),
// and a flash layout's f32 PV accumulators for all R rows of a query block
// (R x 64 x 64 x 4 bytes = 256 KB at R=16) do not fit in shared memory.
//
// Design: one CTA of eight warps per (block of 32 query columns, head,
// batch), for L <= 1024 (the model's max_positions). Three phases:
//   1. the [32, L] logit strip, accumulated in registers over the R rows
//      of one 128-key tile at a time (q and k tiles of each row stream
//      through a three-stage cp.async ring, two tiles in flight while one
//      is multiplied), scaled, biased and stored as f32 in shared memory
//      (128 KB at L = 1024);
//   2. the exact softmax of each strip row (one warp a row), normalised and
//      rounded to bf16 in place over the f32 row;
//   3. per MSA row r, out[r] = P . V[r] with V tiles streaming through the
//      same ring and one [32, 64] f32 accumulator in registers.
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix
// fragment loads. Every CTA reads all of its head's K and V, so K and V
// are read L/32 times from L2; a wider query block (or a cluster sharing
// K/V tiles through TMA multicast) is the lever for a later change, as is
// wgmma.

#include "flash_mha_common.cuh"

namespace {

using namespace flash;

constexpr int D = 64;           // head dim: MSA-1b's, and the only one taken
constexpr int BQ = 32;          // query columns per CTA, 16 per row group
constexpr int BK = 128;         // keys per streamed tile
constexpr int LDS = D + 8;      // bf16 row pitch of q/k/v tiles: conflict-free ldmatrix
constexpr int NTHREADS = 256;   // 8 warps: 2 row groups x 4 column groups
constexpr int MAX_L = 1024;
constexpr int Q_ELEMS = BQ * LDS;
constexpr int KV_ELEMS = BK * LDS;
constexpr int STAGE_ELEMS = Q_ELEMS + KV_ELEMS;
constexpr int NSTAGE = 3;       // ring depth: NSTAGE - 1 tiles in flight

// f32 pitch of the logit strip: L rounded up to a tile, + 4 floats so the
// bf16 rows of P (16 bytes past a multiple of 128 apart) load conflict-free
__host__ __device__ constexpr int strip_pitch(int L) { return (L + BK - 1) / BK * BK + 4; }

__host__ __device__ constexpr size_t smem_bytes(int L) {
  return (size_t)BQ * strip_pitch(L) * 4 + (size_t)NSTAGE * STAGE_ELEMS * 2;
}

struct Params {
  const __nv_bfloat16* q;  // [B, R, L, H*64]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;       // [B, L] log2 units, or null
  __nv_bfloat16* out;      // [B, R, L, H*64]
  int R, L, H;
  float qk_scale;          // scale * log2(e)
};

// Copy rows [row0, row0 + nrows) of one head of MSA row r into a
// [nrows][LDS] tile, 16 bytes a copy; rows past L are zero-filled.
template <int NROWS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          const Params& p, int b, int r, int h,
                                          int row0) {
  const size_t HD = (size_t)p.H * D;
  const size_t base = (((size_t)b * p.R + r) * p.L) * HD + (size_t)h * D;
  for (int i = threadIdx.x; i < NROWS * (D / 8); i += NTHREADS) {
    const int rr = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + rr;
    const bool ok = row < p.L;
    cp_async16(dst + rr * LDS + c, ok ? src + base + (size_t)row * HD + c : src, ok);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
tied_row_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = p.L, R = p.R;
  const int pitch = strip_pitch(L);
  float* strip = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* stages =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (size_t)BQ * pitch * 4);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp & 1;   // row group: strip rows wr*16 .. wr*16+15
  const int wc = warp >> 1;  // column group: 32 keys (phase 1) or 16 head dims (phase 3)
  const int n_kt = (L + BK - 1) / BK;

  // ---- phase 1: logits of the 32 query columns against every key --------
  // item it = kt * R + r: q rows [q0, q0+32) and k rows of key tile kt, MSA row r
  const int n_qk = n_kt * R;
  auto fetch_qk = [&](int it) {
    __nv_bfloat16* st = stages + (it % NSTAGE) * STAGE_ELEMS;
    const int kt = it / R, r = it % R;
    copy_rows<BQ>(st, p.q, p, b, r, h, q0);
    copy_rows<BK>(st + Q_ELEMS, p.k, p, b, r, h, kt * BK);
  };
#pragma unroll
  for (int it = 0; it < NSTAGE - 1; ++it) {
    if (it < n_qk) fetch_qk(it);
    cp_async_commit();  // an empty group past the end keeps the count uniform
  }
  float s[BK / 32][4];  // the warp's 16 rows x 32 keys: 4 blocks of 8
#pragma unroll
  for (int j = 0; j < BK / 32; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int it = 0; it < n_qk; ++it) {
    cp_async_wait<NSTAGE - 2>();  // item it has landed for this thread
    __syncthreads();  // ... for every thread; and item it-1's stage is free
    if (it + NSTAGE - 1 < n_qk) fetch_qk(it + NSTAGE - 1);
    cp_async_commit();
    const __nv_bfloat16* qs = stages + (it % NSTAGE) * STAGE_ELEMS;
    const __nv_bfloat16* ks = qs + Q_ELEMS;
    uint32_t qf[D / 16][4];
    load_a_frags<D, LDS>(qf, qs, wr * 16, lane);
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t kf[4];  // b0, b1 of k-steps 2kp and 2kp+1
        ldsm_x4(kf, ks + (wc * (BK / 4) + j * 8 + (lane & 7)) * LDS + kp * 32 +
                        8 * (lane >> 3));
        mma16816(s[j], qf[2 * kp], kf[0], kf[1]);
        mma16816(s[j], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }
    if (it % R == R - 1) {  // the tile's sum over rows is complete: store it
      const int k0 = (it / R) * BK + wc * (BK / 4);
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int col = k0 + j * 8 + 2 * t;
        float add[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          add[e] = (p.bias != nullptr && col + e < L) ? p.bias[(size_t)b * L + col + e] : 0.f;
        float* ra = strip + (wr * 16 + g) * pitch + col;
        float* rb = ra + 8 * pitch;
        *reinterpret_cast<float2*>(ra) =
            make_float2(s[j][0] * p.qk_scale + add[0], s[j][1] * p.qk_scale + add[1]);
        *reinterpret_cast<float2*>(rb) =
            make_float2(s[j][2] * p.qk_scale + add[0], s[j][3] * p.qk_scale + add[1]);
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the strip is complete and the ring is free

  // ---- phase 3's first V tiles, in flight during the softmax -------------
  // item it = r * n_kt + kt: v rows of key tile kt, MSA row r
  const int n_pv = R * n_kt;
  auto fetch_pv = [&](int it) {
    __nv_bfloat16* st = stages + (it % NSTAGE) * STAGE_ELEMS;
    copy_rows<BK>(st + Q_ELEMS, p.v, p, b, it / n_kt, h, (it % n_kt) * BK);
  };
#pragma unroll
  for (int it = 0; it < NSTAGE - 1; ++it) {
    if (it < n_pv) fetch_pv(it);
    cp_async_commit();
  }

  // ---- phase 2: exact softmax per strip row, bf16 P in place -------------
  // P row i is the first half of f32 row i: pitch * 2 bf16 apart. A warp
  // reads its whole row into registers before it writes any of it.
  for (int i = warp; i < BQ; i += NTHREADS / 32) {
    float* row = strip + i * pitch;
    float x[MAX_L / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < MAX_L / 32; ++m) {
      const int j = lane + 32 * m;
      x[m] = j < L ? row[j] : -INFINITY;
      mx = fmaxf(mx, x[m]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < MAX_L / 32; ++m) {
      x[m] = lane + 32 * m < L ? exp2f(x[m] - mx) : 0.f;
      sum += x[m];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.f / sum;
    __syncwarp();
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(row);
#pragma unroll
    for (int m = 0; m < MAX_L / 32; ++m) {
      const int j = lane + 32 * m;
      if (j < n_kt * BK) prow[j] = __float2bfloat16(x[m] * inv);  // 0 past L
    }
  }

  // ---- phase 3: out[r] = P . V[r], one MSA row at a time -----------------
  const __nv_bfloat16* P = reinterpret_cast<const __nv_bfloat16*>(strip);
  const int pp = 2 * pitch;  // bf16 pitch of P
  const size_t HD = (size_t)p.H * D;
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int it = 0; it < n_pv; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // P is written (first item); item it-1's stage is free
    if (it + NSTAGE - 1 < n_pv) fetch_pv(it + NSTAGE - 1);
    cp_async_commit();
    const int kt = it % n_kt;
    const __nv_bfloat16* vs = stages + (it % NSTAGE) * STAGE_ELEMS + Q_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4], vf[4];
      const int prow = wr * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      ldsm_x4(pf, P + prow * pp + kt * BK + kk * 16 + 8 * (lane >> 4));
      const int key = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      ldsm_x4_trans(vf, vs + key * LDS + wc * 16 + 8 * (lane >> 4));
      mma16816(acc[0], pf, vf[0], vf[1]);
      mma16816(acc[1], pf, vf[2], vf[3]);
    }
    if (kt == n_kt - 1) {  // row r is complete: write it
      const int r = it / n_kt;
      const size_t base = (((size_t)b * R + r) * L) * HD + (size_t)h * D;
      const int row_a = q0 + wr * 16 + g, row_b = row_a + 8;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wc * 16 + j * 8 + 2 * t;
        if (row_a < L)
          *reinterpret_cast<uint32_t*>(p.out + base + (size_t)row_a * HD + col) =
              pack_bf16(acc[j][0], acc[j][1]);
        if (row_b < L)
          *reinterpret_cast<uint32_t*>(p.out + base + (size_t)row_b * HD + col) =
              pack_bf16(acc[j][2], acc[j][3]);
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
    }
  }
}

}  // namespace

// q, k, v, out: contiguous bf16 [B, R, L, H*64], 16-byte aligned; bias: f32
// [B, L] in log2 units or null; qk_scale = scale * log2(e). The caller
// checks 1 <= L <= 1024. Returns cudaGetLastError() after the launch.
extern "C" int oneprot_tied_row_attention(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int B, int R,
                                          int L, int H, float qk_scale, void* stream) {
  if (L < 1 || L > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L);
  const cudaError_t err = cudaFuncSetAttribute(
      tied_row_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.R = R;
  p.L = L;
  p.H = H;
  p.qk_scale = qk_scale;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  tied_row_attention_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
