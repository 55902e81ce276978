// Flash multi-head attention in float32, forward and backward, in the
// [B, L, H*D] layout: the f32 instances of kernels #1-#3.
//
// Replaces, for float32 inputs: oneprot_tpu/kernels/flash_mha.py:_fwd_kernel,
// _bwd_dq_kernel and _bwd_dkv_kernel, which are generic in the input dtype
// (`in_dtype = q_ref.dtype`, f32 accumulation). Same function as the bf16
// kernels, in f32 throughout: q_r = rot(q) * (log2(e) / sqrt(D)), base-2
// logits s = q_r . rot(k) + bias (already in log2 units) - 1e30 across
// segments, the row max started at -1e30 and the row sum clamped at 1e-30,
// the base-2 log-sum-exp beside the output; the backward recomputes
// p = exp2(min(s - lse, 0)) and dS = p (dO . v - delta).
//
// What bounds it on H100: wgmma has no f32 operand and tf32 keeps ~1e-3,
// so the products run as f32 FMA on the CUDA cores (67 TFLOP/s). At the
// debug hubs' heads of 16 that is 4 L D flops per query row against a few
// hundred bytes, far above the CUDA cores' ridge: operations bound it.
// Only the tiny float32 debug models take this path; speed is not its
// point (PERF.md has its times beside its bound).
//
// Design: one thread per row, 64 rows a block (one (batch, head) each). The
// thread keeps its own row's vectors and accumulators in registers (D is a
// template argument, a multiple of 8 up to 64); the other side's rows are
// staged a tile at a time in shared memory, where every thread of the
// block reads the same element (a broadcast). A tile whose segment range
// [min, max] of ids other than -1 meets the block's, or which holds padding
// (-1) where the block does too, is visited; the others hold no pair of
// equal ids and are skipped, as the bf16 kernels skip them
// (`segment_tile_hits`). Keys past L get bias -inf.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace f32mha {

constexpr int ROWS = 64;          // rows of a block, one thread each
constexpr float SEG_MASK = -1e30f;  // cross-segment logit, as the TPU kernel
constexpr float M_INIT = -1e30f;    // the running max's start

struct Side {
  const float* bias;  // [B, L] key bias in log2 units, or null
  const float* cos;   // [L, D] rotary tables, or null
  const float* sin;
  const int* seg;     // [B, L] segment ids (-1 on padding), or null
  int L, H;
};

// element d of rot(x) for a row x of D values at position `pos`
template <int D>
__device__ __forceinline__ float rot_elem(const float* x, const Side& sd, int pos, int d) {
  if (sd.cos == nullptr) return x[d];
  constexpr int h = D / 2;
  const float pair = d < h ? -x[d + h] : x[d - h];
  return x[d] * sd.cos[(long)pos * D + d] + pair * sd.sin[(long)pos * D + d];
}

// g <- R^T g = g cos - rotate_half(g) sin at position `pos` (rotary off: g)
template <int D>
__device__ __forceinline__ void rot_t(float (&g)[D], const Side& sd, int pos) {
  if (sd.cos == nullptr) return;
  constexpr int h = D / 2;
  float r[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float c = sd.cos[(long)pos * D + d], s = sd.sin[(long)pos * D + d];
    r[d] = d < h ? g[d] * c + g[d + h] * s : g[d] * c - g[d - h] * s;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) g[d] = r[d];
}

// The segment range of `n` staged ids (rows past L excluded by the caller):
// min and max of the ids other than -1, and whether -1 occurs.
struct Span {
  int lo = INT_MAX, hi = INT_MIN;
  bool pad = false;
};
__device__ __forceinline__ Span span_of(const int* ids, int n) {
  Span s;
  for (int r = 0; r < n; ++r) {
    const int x = ids[r];
    if (x == -1) {
      s.pad = true;
    } else {
      s.lo = min(s.lo, x);
      s.hi = max(s.hi, x);
    }
  }
  return s;
}
__device__ __forceinline__ bool visits(const Span& a, const Span& b) {
  return (a.pad && b.pad) || (a.lo <= b.hi && b.lo <= a.hi);
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Forward: out [B, L, H*D] and lse [B, H, L]. Grid (ceil(L/64), H, B).
template <int D>
__global__ void __launch_bounds__(ROWS)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, Side sd, float* __restrict__ out,
               float* __restrict__ lse, float q_pre) {
  // keys of one online-softmax step: 16 took ptxas ~3x as long over the
  // eight head-dim instances (about a minute) for no fewer registers
  constexpr int CH = 8;
  __shared__ float ks[ROWS][D], vs[ROWS][D], bs[ROWS];
  __shared__ int ss[ROWS], own_ids[ROWS];
  const int b = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * ROWS, t = threadIdx.x;
  const int L = sd.L, H = sd.H;
  const long HD = (long)H * D, base = (long)b * L * HD + (long)hh * D;
  const int i = q0 + t;
  const bool live = i < L;
  const int n_own = min(ROWS, L - q0);

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? rot_elem<D>(q + base + (long)i * HD, sd, i, d) * q_pre : 0.f;
    acc[d] = 0.f;
  }
  const int my_seg = (sd.seg != nullptr && live) ? sd.seg[(long)b * L + i] : 0;
  own_ids[t] = my_seg;
  __syncthreads();
  const Span own = sd.seg != nullptr ? span_of(own_ids, n_own) : Span();

  float m = M_INIT, l = 0.f;
  for (int k0 = 0; k0 < L; k0 += ROWS) {
    __syncthreads();  // the last tile is consumed
    const int j = k0 + t;
    ss[t] = (sd.seg != nullptr && j < L) ? sd.seg[(long)b * L + j] : 0;
    bs[t] = j < L ? (sd.bias != nullptr ? sd.bias[(long)b * L + j] : 0.f) : -INFINITY;
    __syncthreads();
    if (sd.seg != nullptr && !visits(own, span_of(ss, min(ROWS, L - k0)))) continue;
    for (int e = t; e < ROWS * D; e += ROWS) {
      const int r = e / D, d = e % D, jj = k0 + r;
      const bool in = jj < L;
      ks[r][d] = in ? rot_elem<D>(k + base + (long)jj * HD, sd, jj, d) : 0.f;
      vs[r][d] = in ? v[base + (long)jj * HD + d] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < ROWS; j0 += CH) {
      float s[CH];
      float mx = m;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int jj = j0 + c;
        float x = dot<D>(qr, ks[jj]) + bs[jj];
        if (sd.seg != nullptr && ss[jj] != my_seg) x += SEG_MASK;
        s[c] = x;
        mx = fmaxf(mx, x);
      }
      const float sc = exp2f(m - mx);
      l *= sc;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= sc;
      m = mx;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float p = exp2f(s[c] - m);
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j0 + c][d], acc[d]);
      }
    }
  }
  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) out[base + (long)i * HD + d] = acc[d] / lc;
  lse[((long)b * H + hh) * L + i] = m + log2f(lc);
}

// Backward, dq (with the prologue): q_r = rot(q) * q_pre and delta =
// rowsum(dO * O) are written for the dk/dv kernel. Grid (ceil(L/64), H, B).
template <int D>
__global__ void __launch_bounds__(ROWS)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, Side sd, const float* __restrict__ lse,
              float* __restrict__ dq, float* __restrict__ q_r, float* __restrict__ delta,
              float q_pre, float dq_scale) {
  __shared__ float ks[ROWS][D], vs[ROWS][D], bs[ROWS];
  __shared__ int ss[ROWS], own_ids[ROWS];
  const int b = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * ROWS, t = threadIdx.x;
  const int L = sd.L, H = sd.H;
  const long HD = (long)H * D, base = (long)b * L * HD + (long)hh * D;
  const int i = q0 + t;
  const bool live = i < L;
  const int n_own = min(ROWS, L - q0);
  const long row = base + (long)i * HD, stat = ((long)b * H + hh) * L + i;

  float qr[D], dov[D], acc[D];
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? rot_elem<D>(q + row, sd, i, d) * q_pre : 0.f;
    dov[d] = live ? dout[row + d] : 0.f;
    if (live) dl = fmaf(dov[d], o[row + d], dl);
    acc[d] = 0.f;
  }
  const float lse_i = live ? lse[stat] : 0.f;
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) q_r[row + d] = qr[d];
    delta[stat] = dl;
  }
  const int my_seg = (sd.seg != nullptr && live) ? sd.seg[(long)b * L + i] : 0;
  own_ids[t] = my_seg;
  __syncthreads();
  const Span own = sd.seg != nullptr ? span_of(own_ids, n_own) : Span();

  for (int k0 = 0; k0 < L; k0 += ROWS) {
    __syncthreads();
    const int j = k0 + t;
    ss[t] = (sd.seg != nullptr && j < L) ? sd.seg[(long)b * L + j] : 0;
    bs[t] = j < L ? (sd.bias != nullptr ? sd.bias[(long)b * L + j] : 0.f) : -INFINITY;
    __syncthreads();
    if (sd.seg != nullptr && !visits(own, span_of(ss, min(ROWS, L - k0)))) continue;
    for (int e = t; e < ROWS * D; e += ROWS) {
      const int r = e / D, d = e % D, jj = k0 + r;
      const bool in = jj < L;
      ks[r][d] = in ? rot_elem<D>(k + base + (long)jj * HD, sd, jj, d) : 0.f;
      vs[r][d] = in ? v[base + (long)jj * HD + d] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < ROWS; ++jj) {
      float s = dot<D>(qr, ks[jj]) + bs[jj];
      if (sd.seg != nullptr && ss[jj] != my_seg) s += SEG_MASK;
      const float p = exp2f(fminf(s - lse_i, 0.f));
      const float ds = p * (dot<D>(dov, vs[jj]) - dl);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[jj][d], acc[d]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= dq_scale;
  rot_t<D>(acc, sd, i);
#pragma unroll
  for (int d = 0; d < D; ++d) dq[row + d] = acc[d];
}

// Backward, dk and dv on the dq kernel's q_r and delta. One thread per key
// row; query tiles of 32 rows (q_r, dO and the row statistics) in shared
// memory beside the block's own v rows (stride D + 1: each thread reads its
// own row, conflict-free). Grid (ceil(L/64), H, B).
template <int D>
__global__ void __launch_bounds__(ROWS)
    dkv_kernel(const float* __restrict__ q_r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout, Side sd,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, float dk_scale) {
  constexpr int QT = 32;
  __shared__ float qs[QT][D], dos[QT][D], ls[QT], dls[QT];
  __shared__ float vown[ROWS][D + 1];
  __shared__ int ss[QT], own_ids[ROWS];
  const int b = blockIdx.z, hh = blockIdx.y, k0 = blockIdx.x * ROWS, t = threadIdx.x;
  const int L = sd.L, H = sd.H;
  const long HD = (long)H * D, base = (long)b * L * HD + (long)hh * D;
  const int j = k0 + t;
  const bool live = j < L;
  const int n_own = min(ROWS, L - k0);
  const long row = base + (long)j * HD, stats = ((long)b * H + hh) * L;

  float kr[D], dkv[D], dvv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = live ? rot_elem<D>(k + row, sd, j, d) : 0.f;
    vown[t][d] = live ? v[row + d] : 0.f;
    dkv[d] = 0.f;
    dvv[d] = 0.f;
  }
  const float bias_j = live ? (sd.bias != nullptr ? sd.bias[(long)b * L + j] : 0.f) : -INFINITY;
  const int my_seg = (sd.seg != nullptr && live) ? sd.seg[(long)b * L + j] : 0;
  own_ids[t] = my_seg;
  __syncthreads();
  const Span own = sd.seg != nullptr ? span_of(own_ids, n_own) : Span();

  for (int i0 = 0; i0 < L; i0 += QT) {
    __syncthreads();
    if (t < QT) {
      const int i = i0 + t;
      ss[t] = (sd.seg != nullptr && i < L) ? sd.seg[(long)b * L + i] : 0;
      ls[t] = i < L ? lse[stats + i] : 0.f;
      dls[t] = i < L ? delta[stats + i] : 0.f;
    }
    __syncthreads();
    const int n_q = min(QT, L - i0);
    if (sd.seg != nullptr && !visits(own, span_of(ss, n_q))) continue;
    for (int e = t; e < QT * D; e += ROWS) {
      const int r = e / D, d = e % D, ii = i0 + r;
      const bool in = ii < L;
      qs[r][d] = in ? q_r[base + (long)ii * HD + d] : 0.f;
      dos[r][d] = in ? dout[base + (long)ii * HD + d] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int ii = 0; ii < n_q; ++ii) {
      float s = dot<D>(kr, qs[ii]) + bias_j;
      if (sd.seg != nullptr && ss[ii] != my_seg) s += SEG_MASK;
      const float p = exp2f(fminf(s - ls[ii], 0.f));
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dp = fmaf(dos[ii][d], vown[t][d], dp);
      const float ds = p * (dp - dls[ii]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dvv[d] = fmaf(p, dos[ii][d], dvv[d]);
        dkv[d] = fmaf(ds, qs[ii][d], dkv[d]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) dkv[d] *= dk_scale;
  rot_t<D>(dkv, sd, j);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[row + d] = dkv[d];
    dv[row + d] = dvv[d];
  }
}

inline Side make_side(const void* bias, const void* cos, const void* sin, const void* seg, int L,
                      int H) {
  Side sd;
  sd.bias = static_cast<const float*>(bias);
  sd.cos = static_cast<const float*>(cos);
  sd.sin = static_cast<const float*>(sin);
  sd.seg = static_cast<const int*>(seg);
  sd.L = L;
  sd.H = H;
  return sd;
}

inline dim3 grid_of(int B, int L, int H) { return dim3((L + ROWS - 1) / ROWS, H, B); }

// Call f.template operator()<D>() for the head dim D (a multiple of 8 up to
// 64); returns cudaErrorInvalidValue for any other.
template <typename F>
int dispatch_d(int D, F&& f) {
  switch (D) {
    case 8: return f.template operator()<8>();
    case 16: return f.template operator()<16>();
    case 24: return f.template operator()<24>();
    case 32: return f.template operator()<32>();
    case 40: return f.template operator()<40>();
    case 48: return f.template operator()<48>();
    case 56: return f.template operator()<56>();
    case 64: return f.template operator()<64>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f32mha
