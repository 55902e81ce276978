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
// What bounds them on H100: wgmma has no f32 operand, and TF32 (or a 3xTF32
// split) does not keep the digits of the f32 bar (1e-4), so every product is
// exact f32 FMA on the CUDA cores: 67 TFLOP/s, 128 FMAs a clock on each SM.
// At heads of 16-64 that is 4 D flops (forward) or 8 D (dk/dv) per logit
// pair against a few hundred bytes per row: operations bound the work. Shared
// memory gives each SM 128 bytes a clock, a quarter of a float per FMA, so
// the FMA units set the pace only where each float loaded from shared memory
// feeds several FMAs.
//
// The forward (#1) and dk/dv (#3): register-tiled products, FA-2 style. A
// block of 128 threads owns a tile of 64 rows: query rows in #1, key rows in
// #3 (the grid is (ceil(L/64), H, B) for all three kernels).
//  - The first products are tiles: S = Q K^T in #1; S^T = K q_r^T and
//    dP^T = V dO^T in #3. Thread (ty, tx) of a 16 x 8 grid holds rows
//    4ty..4ty+3 against the other side's rows tx + 8c (c < 8; c < 4 for #3's
//    query tiles of 32 at D > 32), both read as float4 along d from row-major
//    tiles whose row stride of DP + 4 floats puts a quarter-warp's 8 lanes on
//    distinct banks: 12 loads of 16 bytes feed 128 FMAs. Each logit is one
//    fma chain in d order.
//  - Softmax: the row max is reduced by shuffles among the 8 lanes of a row;
//    each lane keeps its part of the row sum, added up once at the end;
//    exp2 is the SFU's (MUFU.EX2) without exp2f's rescaling of results
//    below 2^-126 around it.
//  - P (#1), P^T and dS^T (#3) are staged in shared memory as [k][row] (16
//    KB at 64 x 64) for the second products P V, P^T dO and dS^T q_r. Their
//    output tile, 64 rows x DP columns (the head dim rounded up to 8, 16, 32
//    or 64), is spread over the threads at 32 accumulators each (16 at D=8):
//    below DP=64 the block's warps split the reduction over k into KS groups
//    whose partial sums meet once, through shared memory, at the end. No
//    thread keeps a whole D-vector, so no instance from D=8 to 64 spills.
//  - Staging: the K/V tiles of #1 (with the key bias and the segment ids)
//    and the q_r/dO/lse/delta tiles of #3 arrive by cp.async into a ring of
//    2 stages: the next visited tile loads while this one computes. The
//    block's own rows (Q in #1; K and V in #3) are loaded once, Q while the
//    block lists its tiles. Shared memory above 48 KB is set with
//    cudaFuncSetAttribute.
//  - Rotary: #1 first writes q_r = rot(q) * q_pre and rot(k) once per row
//    into scratch (`rotate_qk`), and its tiled loop stages those as they
//    are. Rotating each K tile where it is staged instead repeats the
//    rotation for every query tile that stages it (16 at L = 1024) and
//    stages the rotary tables with every tile, which costs more than the
//    pass (PERF.md), as the bf16 #1's `rotate_k` pass found. #3 rotates its
//    own K rows once per block as it loads them and takes dk back through
//    rot^T once, in its epilogue.
//  - The tiles to visit are listed once per block (8 threads a tile, each
//    loading its share of the ids at once): a tile whose segment range
//    [min, max] of ids other than -1 meets the block's, or which holds
//    padding (-1) where the block does too; the others hold no pair of equal
//    ids and are skipped, as the bf16 kernels skip them
//    (`segment_tile_hits`). Keys past L get bias -inf and query rows past
//    L an lse of +inf: both give p = 0.
//  - Registers: 134-254 a thread, none spilled at any head dim
//    (`Tiles::*_MIN_BLOCKS`); 2-3 blocks share an SM.
//
// The dq kernel (#2) keeps its first design: one thread per query row, 64
// rows a block, key tiles of 64 in shared memory read as broadcasts; its
// prologue writes q_r = rot(q) * q_pre and delta = rowsum(dO * O) for #3.
//
// The launches of all three (`fwd`, `bwd_dq`, `bwd_dkv`, at the end) take a
// `launch` callable: the entry points pass <<<>>> on their stream
// (`CudaLaunch`), the tests' CPU emulation its own.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <type_traits>

namespace f32mha {

constexpr int ROWS = 64;            // rows of a block
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

// ---------------------------------------------------------------------------
// The tiled forward (#1) and dk/dv (#3)

constexpr int THREADS = 128;
constexpr int PSTRIDE = ROWS + 4;  // row stride of a staged P / dS tile [k][row]

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The tiling of head dim D (a multiple of 8 up to 64).
template <int D>
struct Tiles {
  // the second products' output width, and the row stride of staged tiles
  static constexpr int DP = D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 64;
  static constexpr int SD = DP + 4;
  // groups of threads that split the second products' reduction, and the
  // threads of one group, which cover its 64 x DP output tile
  static constexpr int KS = DP == 64 ? 1 : DP == 32 ? 2 : 4;
  static constexpr int G = THREADS / KS;
  // a thread's columns (float4s at cg*4, and 32 + cg*4 at DP=64) and rows
  static constexpr int CG = DP == 8 ? 2 : DP == 16 ? 4 : 8;
  static constexpr int CT = DP == 64 ? 8 : 4;
  static constexpr int RT = ROWS * CG / G;
  // query rows of a #3 tile: 64 keeps 12 loads to 128 FMAs; 32 at D > 32
  // keeps #3 at two blocks an SM
  static constexpr int QT = D <= 32 ? 64 : 32;
  // blocks an SM that ptxas must leave room for (__launch_bounds__): 3
  // holds a thread to 168 registers, 2 to 255. Left to itself ptxas aims at
  // 3 (4 at D=8) and spills a few bytes where the tiles need more. #1 at
  // heads of 8-16 fits 168 without spilling, and 3 blocks share an SM
  // (their shared memory allows it); wider #1 and every #3 take 2
  // (CUDA 12.9's ptxas; `chip_smoke.py` gates the spills).
  static constexpr int FWD_MIN_BLOCKS = D <= 16 ? 3 : 2;
  static constexpr int DKV_MIN_BLOCKS = 2;
  static_assert(D % 8 == 0 && D <= 64, "head dim: a multiple of 8 up to 64");
  static_assert(RT % 4 == 0 && CG * CT == DP, "tiling");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// element-wise a * c + b * s (the rotary's two terms, rot_elem's order)
__device__ __forceinline__ float4 rot4(float4 a, float4 c, float4 b, float4 s) {
  return make_float4(a.x * c.x + b.x * s.x, a.y * c.y + b.y * s.y, a.z * c.z + b.z * s.z,
                     a.w * c.w + b.w * s.w);
}
__device__ __forceinline__ float4 neg4(float4 a) { return make_float4(-a.x, -a.y, -a.z, -a.w); }
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, or 16 zero bytes where !full
__device__ __forceinline__ void cp16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the SFU (MUFU.EX2, the instruction exp2f rounds through) without
// exp2f's rescaling around it: a result below 2^-126 flushes to 0, a
// probability that adds nothing in f32 to the sums it enters
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// f(e) for this thread's units e < N (threadIdx.x + i * THREADS): a loop
// of compile-time trips, unrolled, the same units in every call
template <int N, class F>
__device__ __forceinline__ void for_units(F&& f) {
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (N % THREADS == 0 || e < N) f(e);
  }
}

// Rows r0..r0+N-1 of the head at `src` (its row 0; row stride HD; an [L, D]
// table with HD = D) into dst [N][SD] by cp.async; rows past L are zeros.
template <int D, int SD, int N>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long HD, int r0, int L) {
  constexpr int C4 = D / 4;
  for_units<N * C4>([&](int e) {
    const int r = e / C4, c = (e % C4) * 4, i = r0 + r;
    const bool in = i < L;
    cp16(dst + r * SD + c, src + (long)(in ? i : 0) * HD + c, in);
  });
}

// Zero columns D..DP-1 of a staged tile [N][SD], which the second products
// read and whose results are not stored.
template <int D, int SD, int DP, int N>
__device__ __forceinline__ void zero_pad(float* x) {
  if constexpr (DP > D) {
    constexpr int P4 = (DP - D) / 4;
    for_units<N * P4>([&](int e) {
      st4(x + (e / P4) * SD + D + (e % P4) * 4, make_float4(0.f, 0.f, 0.f, 0.f));
    });
  }
}

// rows r0..r0+63 of a head (at `src`, its row 0) as rot(x) into dst
// [64][SD] (plain loads, once per block); rows past L are zeros
template <int D, int SD>
__device__ __forceinline__ void load_rotated(float* dst, const float* src, long HD,
                                             const Side& sd, int r0, int L) {
  if (sd.cos != nullptr) {
    constexpr int HF = D / 2, H4 = D / 8;
    for_units<ROWS * H4>([&](int e) {
      const int r = e / H4, c = (e % H4) * 4, i = r0 + r;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (i < L) {
        const float* x = src + (long)i * HD;
        const float* cs = sd.cos + (long)i * D;
        const float* sn = sd.sin + (long)i * D;
        const float4 x1 = ldg4(x + c), x2 = ldg4(x + c + HF);
        lo = rot4(x1, ldg4(cs + c), neg4(x2), ldg4(sn + c));
        hi = rot4(x2, ldg4(cs + c + HF), x1, ldg4(sn + c + HF));
      }
      st4(dst + r * SD + c, lo);
      st4(dst + r * SD + c + HF, hi);
    });
  } else {
    constexpr int C4 = D / 4;
    for_units<ROWS * C4>([&](int e) {
      const int r = e / C4, c = (e % C4) * 4, i = r0 + r;
      st4(dst + r * SD + c,
          i < L ? ldg4(src + (long)i * HD + c) : make_float4(0.f, 0.f, 0.f, 0.f));
    });
  }
}

// x * scale in place for the rows this thread staged with `stage_rows`
template <int D, int SD>
__device__ __forceinline__ void scale_own(float* x, float scale) {
  constexpr int C4 = D / 4;
  for_units<ROWS * C4>([&](int e) {
    const int o = (e / C4) * SD + (e % C4) * 4;
    st4(x + o, scale4(ld4(x + o), scale));
  });
}

// The tiles of `tile` rows (32 or 64; n_tiles of them over the batch row's
// ids [L]) that the block's own rows own0..own0+63 visit, in order, into
// list; returns their number (all threads). spans [3][n_tiles] holds each
// tile's segment range: 8 threads a tile, each loading its tile / 8 ids at
// once, then 3 shuffles; the block's own range is the union of its tiles'.
__device__ __forceinline__ int visit_list(int* list, int* spans, const int* ids, int L, int own0,
                                          int tile, int n_tiles) {
  const int t = threadIdx.x, part = t & 7, per = tile / 8;
  int* const lo_of = spans;
  int* const hi_of = spans + n_tiles;
  int* const pad_of = spans + 2 * n_tiles;
  for (int i0 = 0; i0 < n_tiles; i0 += THREADS / 8) {  // the same trips in every lane
    const int i = i0 + (t >> 3), r0 = i * tile + part * per;
    const int n = i < n_tiles ? min(per, L - r0) : 0;
    int x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = r < n ? ids[r0 + r] : INT_MIN;
    int lo = INT_MAX, hi = INT_MIN, pad = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < n && x[r] == -1) pad = 1;
      if (r < n && x[r] != -1) lo = min(lo, x[r]), hi = max(hi, x[r]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      pad |= __shfl_xor_sync(0xffffffffu, pad, o);
    }
    if (part == 0 && i < n_tiles) lo_of[i] = lo, hi_of[i] = hi, pad_of[i] = pad;
  }
  __syncthreads();
  Span own;
  for (int i = own0 / tile; i < min(n_tiles, (own0 + ROWS) / tile); ++i) {
    own.lo = min(own.lo, lo_of[i]);
    own.hi = max(own.hi, hi_of[i]);
    own.pad = own.pad || pad_of[i];
  }
  for (int i = t; i < n_tiles; i += THREADS) {
    Span s;
    s.lo = lo_of[i], s.hi = hi_of[i], s.pad = pad_of[i] != 0;
    list[i] = visits(own, s);
  }
  __syncthreads();
  if (t < 32) {  // compact the flags in place, 32 at a time
    int n = 0;
    for (int i0 = 0; i0 < n_tiles; i0 += 32) {
      const int i = i0 + t;
      const int flag = i < n_tiles ? list[i] : 0;
      const unsigned m = __ballot_sync(0xffffffffu, flag != 0);
      if (flag != 0) list[n + __popc(m & ((1u << t) - 1u))] = i;
      n += __popc(m);
    }
    if (t == 0) spans[0] = n;
  }
  __syncthreads();
  return spans[0];
}

// The forward's logits: s += the key's bias, and SEG_MASK where the key's
// id is not the row's (segs: the batch has segment ids).
__device__ __forceinline__ void key_terms(float (&s)[4][8], const float* bs, const int* ss,
                                          const int (&own)[4], int tx, bool segs) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 8 * c;
      float x = s[r][c] + bs[j];
      if (segs && ss[j] != own[r]) x += SEG_MASK;
      s[r][c] = x;
    }
  }
}

// dk/dv's probabilities: p = exp2(min(s + the key row's bias (+ SEG_MASK
// where the query's id is not the key's) - lse, 0)).
template <int NC>
__device__ __forceinline__ void query_terms(float (&p)[4][NC], const float (&bias)[4],
                                            const int* ss, const int (&own)[4], const float* ls,
                                            int tx, bool segs) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = tx + 8 * c;
      float x = p[r][c] + bias[r];
      if (segs && ss[i] != own[r]) x += SEG_MASK;
      p[r][c] = ex2(fminf(x - ls[i], 0.f));
    }
  }
}

// s[r][c] = a_r . b_{8c} over d < D for the rows a + r*SD (r < 4) and
// b + 8c*SD (c < NC): one fma chain in d order for each pair.
template <int D, int SD, int NC>
__device__ __forceinline__ void first_product(float (&s)[4][NC], const float* a, const float* b) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) s[r][c] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ld4(a + r * SD + d);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 y = ld4(b + c * 8 * SD + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[r][c] = fmaf(x[r].x, y.x, s[r][c]);
        s[r][c] = fmaf(x[r].y, y.y, s[r][c]);
        s[r][c] = fmaf(x[r].z, y.z, s[r][c]);
        s[r][c] = fmaf(x[r].w, y.w, s[r][c]);
      }
    }
  }
}

// Stage a thread's 4 x NC tile (rows 4ty.., columns tx + 8c) transposed,
// as [column][row], for a second product.
template <int NC>
__device__ __forceinline__ void stage_t(float* dst, const float (&s)[4][NC], int ty, int tx) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    st4(dst + (tx + 8 * c) * PSTRIDE + 4 * ty, make_float4(s[0][c], s[1][c], s[2][c], s[3][c]));
  }
}

// acc[r][c] += sum over k0 <= k < k0 + NK of at[k][row0 + r] * bt[k][col c]
// (at: a staged [k][row] tile; bt: a row-major [k][SD] tile; the columns
// cg*4.. and, at DP=64, 32 + cg*4..)
template <int D, int NK>
__device__ __forceinline__ void second_product(float (&acc)[Tiles<D>::RT][Tiles<D>::CT],
                                               const float* at, const float* bt, int k0, int row0,
                                               int cg) {
  using T = Tiles<D>;
#pragma unroll 4
  for (int k = k0; k < k0 + NK; ++k) {
    float x[T::RT], y[T::CT];
#pragma unroll
    for (int r = 0; r < T::RT; r += 4) {
      const float4 a = ld4(at + k * PSTRIDE + row0 + r);
      x[r] = a.x, x[r + 1] = a.y, x[r + 2] = a.z, x[r + 3] = a.w;
    }
#pragma unroll
    for (int c = 0; c < T::CT; c += 4) {
      const float4 b = ld4(bt + k * T::SD + cg * 4 + 8 * c);
      y[c] = b.x, y[c + 1] = b.y, y[c + 2] = b.z, y[c + 3] = b.w;
    }
#pragma unroll
    for (int r = 0; r < T::RT; ++r) {
#pragma unroll
      for (int c = 0; c < T::CT; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
    }
  }
}

// A group's partial sums acc into red [KS][ROWS][SD] (its own slice).
template <int D>
__device__ __forceinline__ void store_partial(float* red,
                                              const float (&acc)[Tiles<D>::RT][Tiles<D>::CT],
                                              int grp, int row0, int cg) {
  using T = Tiles<D>;
#pragma unroll
  for (int r = 0; r < T::RT; ++r) {
#pragma unroll
    for (int c = 0; c < T::CT; c += 4) {
      st4(red + (grp * ROWS + row0 + r) * T::SD + cg * 4 + 8 * c,
          make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]));
    }
  }
}

// The sum over the KS groups of red's float4 at (row r, column c).
template <int D>
__device__ __forceinline__ float4 sum_partials(const float* red, int r, int c) {
  using T = Tiles<D>;
  float4 s = ld4(red + r * T::SD + c);
#pragma unroll
  for (int g = 1; g < T::KS; ++g) s = add4(s, ld4(red + (g * ROWS + r) * T::SD + c));
  return s;
}

// #1's rotary pass: q_r = rot(q) * q_pre and rot(k), [B, L, H*D] each,
// once per row into scratch before the tiled forward, which then stages
// them as they are. A thread takes 4 columns of one (row, head) and their
// rotary pairs, D / 2 on.
constexpr int ROTATE_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(ROTATE_THREADS)
    rotate_qk(const float* __restrict__ q, const float* __restrict__ k, Side sd,
              float* __restrict__ q_r, float* __restrict__ k_r, long n, float q_pre) {
  constexpr int HF = D / 2, H4 = D / 8;
  const long e = (long)blockIdx.x * ROTATE_THREADS + threadIdx.x;
  if (e >= n) return;
  const int c = (int)(e % H4) * 4;
  const long head_row = e / H4;  // (b * L + position) * H + head
  const long o = head_row * D + c, t = (head_row / sd.H % sd.L) * D + c;
  const float4 c1 = ldg4(sd.cos + t), s1 = ldg4(sd.sin + t);
  const float4 c2 = ldg4(sd.cos + t + HF), s2 = ldg4(sd.sin + t + HF);
  float4 x1 = ldg4(q + o), x2 = ldg4(q + o + HF);
  st4(q_r + o, scale4(rot4(x1, c1, neg4(x2), s1), q_pre));
  st4(q_r + o + HF, scale4(rot4(x2, c2, x1, s2), q_pre));
  x1 = ldg4(k + o), x2 = ldg4(k + o + HF);
  st4(k_r + o, rot4(x1, c1, neg4(x2), s1));
  st4(k_r + o + HF, rot4(x2, c2, x1, s2));
}

// Shared memory of the forward, in floats: q [ROWS][SD] | p [ROWS][PSTRIDE]
// ([key][query row]) | stat [ROWS] (the tile's rescale factors, then the
// row sums) | the ring: 2 stages of {k, v [ROWS][SD], bias, ids [ROWS]},
// which the epilogue's partial sums [KS][ROWS][SD] reuse | the visited
// tiles' list, then the tiles' segment ranges [3][n_tiles] (ints).
template <int D>
struct FwdSmem {
  using T = Tiles<D>;
  static constexpr int P = ROWS * T::SD, STAT = P + ROWS * PSTRIDE, RING = STAT + ROWS,
                       STAGE = 2 * ROWS * T::SD + 2 * ROWS,
                       LIST = RING + cmax(2 * STAGE, T::KS * ROWS * T::SD);
  static int bytes(int n_tiles) { return 4 * (LIST + 4 * n_tiles); }
};

// Forward: out [B, L, H*D] and lse [B, H, L] from q * q_pre, k and v as
// they are (with rotary, `rotate_qk`'s q_r and rot(k), and q_pre = 1; sd
// without tables). Grid (ceil(L/64), H, B).
template <int D>
__global__ void __launch_bounds__(THREADS, Tiles<D>::FWD_MIN_BLOCKS)
    fwd_tiled(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, Side sd, float* __restrict__ out,
              float* __restrict__ lse, float q_pre) {
  using T = Tiles<D>;
  using SM = FwdSmem<D>;
  constexpr int SD = T::SD, KPG = ROWS / T::KS;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const bool segs = sd.seg != nullptr;
  float* const qs = sm;
  float* const ps = sm + SM::P;
  float* const stat = sm + SM::STAT;
  float* const ring = sm + SM::RING;
  constexpr int stage = SM::STAGE;
  int* const list = reinterpret_cast<int*>(sm + SM::LIST);
  const int b = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * ROWS, t = threadIdx.x;
  const int L = sd.L, H = sd.H;
  const long HD = (long)H * D, base = (long)b * L * HD + (long)hh * D;
  const int n_tiles = (L + ROWS - 1) / ROWS;
  const int* const ids = segs ? sd.seg + (long)b * L : nullptr;

  // the query tile by cp.async, landing while the tile list is made
  stage_rows<D, SD, ROWS>(qs, q + base, HD, q0, L);
  cp_commit();
  zero_pad<D, SD, T::DP, ROWS>(ring + ROWS * SD);
  zero_pad<D, SD, T::DP, ROWS>(ring + stage + ROWS * SD);
  const int n_vis = segs ? visit_list(list, list + n_tiles, ids, L, q0, ROWS, n_tiles) : n_tiles;
  auto tile_of = [&](int it) { return segs ? list[it] : it; };

  // key tile kt into ring stage s: k, v, bias, ids
  auto load_tile = [&](int s, int kt) {
    float* const st = ring + s * stage;
    const int k0 = kt * ROWS;
    float* const bs = st + 2 * ROWS * SD;
    int* const ss = reinterpret_cast<int*>(bs + ROWS);
    stage_rows<D, SD, ROWS>(st, k + base, HD, k0, L);
    stage_rows<D, SD, ROWS>(st + ROWS * SD, v + base, HD, k0, L);
    if (t < ROWS) {
      const int j = k0 + t;
      if (j < L) {
        if (sd.bias != nullptr) {
          cp4(bs + t, sd.bias + (long)b * L + j);
        } else {
          bs[t] = 0.f;
        }
        if (segs) cp4(ss + t, ids + j);
      } else {
        bs[t] = -INFINITY;
        ss[t] = 0;
      }
    }
    cp_commit();
  };

  if (n_vis > 0) load_tile(0, tile_of(0));
  cp_wait_all();
  scale_own<D, SD>(qs, q_pre);  // the loop's first barrier publishes it

  const int ty = t >> 3, tx = t & 7;  // the first product's rows 4ty.., keys tx + 8c
  int own_id[4];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    own_id[r] = (segs && i < L) ? ids[i] : 0;
    m[r] = M_INIT;
    l[r] = 0.f;  // this lane's part of the row sum
  }
  const int grp = t / T::G, u = t % T::G, cg = u % T::CG, row0 = (u / T::CG) * T::RT;
  float acc[T::RT][T::CT];
#pragma unroll
  for (int r = 0; r < T::RT; ++r) {
#pragma unroll
    for (int c = 0; c < T::CT; ++c) acc[r][c] = 0.f;
  }

  for (int it = 0; it < n_vis; ++it) {
    float* const ks = ring + (it & 1) * stage;
    const float* const vs = ks + ROWS * SD;
    const float* const bs = vs + ROWS * SD;
    const int* const ss = reinterpret_cast<const int*>(bs + ROWS);
    cp_wait_all();
    __syncthreads();  // tile `it` has arrived; the last second product is done
    if (it + 1 < n_vis) load_tile((it + 1) & 1, tile_of(it + 1));
    float s[4][8];
    first_product<D, SD, 8>(s, qs + 4 * ty * SD, ks + tx * SD);
    key_terms(s, bs, ss, own_id, tx, segs);
    float mx[4], alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      mx[r] = m[r];
#pragma unroll
      for (int c = 0; c < 8; ++c) mx[r] = fmaxf(mx[r], s[r][c]);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[r][c] = ex2(s[r][c] - mx[r]);
        sum += s[r][c];
      }
      l[r] = l[r] * alpha[r] + sum;
    }
    stage_t<8>(ps, s, ty, tx);
    if (tx == 0) st4(stat + 4 * ty, make_float4(alpha[0], alpha[1], alpha[2], alpha[3]));
    __syncthreads();
#pragma unroll
    for (int r = 0; r < T::RT; ++r) {
      const float a = stat[row0 + r];
#pragma unroll
      for (int c = 0; c < T::CT; ++c) acc[r][c] *= a;
    }
    second_product<D, KPG>(acc, ps, vs, grp * KPG, row0, cg);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  }
  __syncthreads();  // the ring is free: the partial sums go there
  float* const red = ring;
  store_partial<D>(red, acc, grp, row0, cg);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * ty + r;
      const float lc = fmaxf(l[r], 1e-30f);
      stat[4 * ty + r] = lc;
      if (i < L) lse[((long)b * H + hh) * L + i] = m[r] + log2f(lc);
    }
  }
  __syncthreads();
  constexpr int C4 = D / 4;
  for (int e = t; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, i = q0 + r;
    if (i >= L) continue;
    const float4 o = sum_partials<D>(red, r, c);
    const float lc = stat[r];
    st4(out + base + (long)i * HD + c, make_float4(o.x / lc, o.y / lc, o.z / lc, o.w / lc));
  }
}

// Shared memory of dk/dv, in floats: k (rotated), v [ROWS][SD] | p, ds
// [QT][PSTRIDE] ([query row][key row]) | the ring: 2 stages of {q_r, dO
// [QT][SD], lse, delta, ids [QT]}, which the epilogue's partial sums
// [KS][ROWS][SD] reuse | the visited tiles' list, then the tiles' segment
// ranges [3][n_tiles] (ints).
template <int D>
struct DkvSmem {
  using T = Tiles<D>;
  static constexpr int V = ROWS * T::SD, P = 2 * ROWS * T::SD, DS = P + T::QT * PSTRIDE,
                       RING = DS + T::QT * PSTRIDE, STAGE = 2 * T::QT * T::SD + 3 * T::QT,
                       LIST = RING + cmax(2 * STAGE, T::KS * ROWS * T::SD);
  static int bytes(int n_tiles) { return 4 * (LIST + 4 * n_tiles); }
};

// Backward, dk and dv on the dq kernel's q_r and delta. Grid (ceil(L/64),
// H, B): a block's 64 key rows against the visited query tiles of QT rows.
template <int D>
__global__ void __launch_bounds__(THREADS, Tiles<D>::DKV_MIN_BLOCKS)
    dkv_tiled(const float* __restrict__ q_r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout, Side sd,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, float dk_scale) {
  using T = Tiles<D>;
  using SM = DkvSmem<D>;
  constexpr int SD = T::SD, QT = T::QT, NC = QT / 8, KPG = QT / T::KS;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const bool rotary = sd.cos != nullptr, segs = sd.seg != nullptr;
  float* const ks = sm;
  float* const vs = sm + SM::V;
  float* const pst = sm + SM::P;
  float* const dst = sm + SM::DS;
  float* const ring = sm + SM::RING;
  int* const list = reinterpret_cast<int*>(sm + SM::LIST);
  const int b = blockIdx.z, hh = blockIdx.y, j0 = blockIdx.x * ROWS, t = threadIdx.x;
  const int L = sd.L, H = sd.H;
  const long HD = (long)H * D, base = (long)b * L * HD + (long)hh * D;
  const long stats = ((long)b * H + hh) * L;
  const int n_tiles = (L + QT - 1) / QT;
  const int* const ids = segs ? sd.seg + (long)b * L : nullptr;

  zero_pad<D, SD, T::DP, 2 * QT>(ring);  // q_r and dO of stage 0
  zero_pad<D, SD, T::DP, 2 * QT>(ring + SM::STAGE);
  const int n_vis = segs ? visit_list(list, list + n_tiles, ids, L, j0, QT, n_tiles) : n_tiles;
  auto tile_of = [&](int it) { return segs ? list[it] : it; };

  // query tile qt into ring stage s: q_r, dO, lse, delta, ids
  auto load_tile = [&](int s, int qt) {
    float* const st = ring + s * SM::STAGE;
    const int i0 = qt * QT;
    stage_rows<D, SD, QT>(st, q_r + base, HD, i0, L);
    stage_rows<D, SD, QT>(st + QT * SD, dout + base, HD, i0, L);
    float* const ls = st + 2 * QT * SD;
    float* const dls = ls + QT;
    int* const ss = reinterpret_cast<int*>(dls + QT);
    if (t < QT) {
      const int i = i0 + t;
      if (i < L) {
        cp4(ls + t, lse + stats + i);
        cp4(dls + t, delta + stats + i);
        if (segs) cp4(ss + t, ids + i);
      } else {  // p = exp2(min(s - inf, 0)) = 0 on rows past L
        ls[t] = INFINITY;
        dls[t] = 0.f;
        ss[t] = 0;
      }
    }
    cp_commit();
  };

  stage_rows<D, SD, ROWS>(vs, v + base, HD, j0, L);  // with the first tile's group
  zero_pad<D, SD, T::DP, ROWS>(vs);
  if (n_vis > 0) load_tile(0, tile_of(0));
  load_rotated<D, SD>(ks, k + base, HD, sd, j0, L);

  const int ty = t >> 3, tx = t & 7;  // the first products' key rows 4ty.., query rows tx + 8c
  float bias_j[4];
  int own_id[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    bias_j[r] = j < L ? (sd.bias != nullptr ? sd.bias[(long)b * L + j] : 0.f) : -INFINITY;
    own_id[r] = (segs && j < L) ? ids[j] : 0;
  }
  const int grp = t / T::G, u = t % T::G, cg = u % T::CG, row0 = (u / T::CG) * T::RT;
  float dka[T::RT][T::CT], dva[T::RT][T::CT];
#pragma unroll
  for (int r = 0; r < T::RT; ++r) {
#pragma unroll
    for (int c = 0; c < T::CT; ++c) dka[r][c] = dva[r][c] = 0.f;
  }

  for (int it = 0; it < n_vis; ++it) {
    cp_wait_all();
    __syncthreads();  // tile `it` (and v) has arrived; the last second products are done
    if (it + 1 < n_vis) load_tile((it + 1) & 1, tile_of(it + 1));
    const float* const qs = ring + (it & 1) * SM::STAGE;
    const float* const dos = qs + QT * SD;
    const float* const ls = dos + QT * SD;
    const float* const dls = ls + QT;
    const int* const ss = reinterpret_cast<const int*>(dls + QT);
    {  // P^T, staged at once: its registers are free for dP^T
      float p[4][NC];
      first_product<D, SD, NC>(p, ks + 4 * ty * SD, qs + tx * SD);
      query_terms(p, bias_j, ss, own_id, ls, tx, segs);
      stage_t<NC>(pst, p, ty, tx);
    }
    float ds[4][NC];
    first_product<D, SD, NC>(ds, vs + 4 * ty * SD, dos + tx * SD);
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // this thread's own staged p, read back
      const float4 p = ld4(pst + (tx + 8 * c) * PSTRIDE + 4 * ty);
      const float dl = dls[tx + 8 * c];
      ds[0][c] = p.x * (ds[0][c] - dl);
      ds[1][c] = p.y * (ds[1][c] - dl);
      ds[2][c] = p.z * (ds[2][c] - dl);
      ds[3][c] = p.w * (ds[3][c] - dl);
    }
    stage_t<NC>(dst, ds, ty, tx);
    __syncthreads();
    second_product<D, KPG>(dva, pst, dos, grp * KPG, row0, cg);
    second_product<D, KPG>(dka, dst, qs, grp * KPG, row0, cg);
  }

  // epilogue: the groups' partial sums through the ring; dk scaled and taken
  // back through rot^T from k's buffer
  constexpr int C4 = D / 4, HF = D / 2;
  float* const red = ring;
  __syncthreads();
  store_partial<D>(red, dka, grp, row0, cg);
  __syncthreads();
  for (int e = t; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    st4(ks + r * SD + c, scale4(sum_partials<D>(red, r, c), dk_scale));
  }
  __syncthreads();
  store_partial<D>(red, dva, grp, row0, cg);
  for (int e = t; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, j = j0 + r;
    if (j >= L) continue;
    float4 g = ld4(ks + r * SD + c);
    if (rotary) {
      const float4 cs = ldg4(sd.cos + (long)j * D + c), sn = ldg4(sd.sin + (long)j * D + c);
      g = c < HF ? rot4(g, cs, ld4(ks + r * SD + c + HF), sn)
                 : rot4(g, cs, neg4(ld4(ks + r * SD + c - HF)), sn);
    }
    st4(dk + base + (long)j * HD + c, g);
  }
  __syncthreads();
  for (int e = t; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, j = j0 + r;
    if (j < L) st4(dv + base + (long)j * HD + c, sum_partials<D>(red, r, c));
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

// f(std::integral_constant<int, D>()) for the head dim D (a multiple of 8 up
// to 64); returns cudaErrorInvalidValue for any other.
template <typename F>
int dispatch_d(int D, F&& f) {
  switch (D) {
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 24: return f(std::integral_constant<int, 24>());
    case 32: return f(std::integral_constant<int, 32>());
    case 40: return f(std::integral_constant<int, 40>());
    case 48: return f(std::integral_constant<int, 48>());
    case 56: return f(std::integral_constant<int, 56>());
    case 64: return f(std::integral_constant<int, 64>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The launches of each entry point (csrc/flash_mha_*_f32.cu), written once
// for the card and for the tests' CPU emulation: `launch(kernel, grid,
// threads, dynamic shared bytes, arguments...)` runs the kernel and returns
// 0 or an error code. The pointers are the entry points' (layouts there).

inline const float* in_f32(const void* p) { return static_cast<const float*>(p); }
inline float* out_f32(void* p) { return static_cast<float*>(p); }

// #1: with rotary, `rotate_qk` writes q_r and rot(k) into the scratch
// q_rot, k_rot, and the tiled forward runs on them with q_pre = 1.
template <class Launch>
int fwd(const Launch& launch, const void* q, const void* k, const void* v, const void* bias,
        const void* cos, const void* sin, const void* seg, void* out, void* lse, void* q_rot,
        void* k_rot, int B, int L, int H, int head_dim, float q_pre) {
  const Side sd = make_side(bias, cos, sin, seg, L, H);
  return dispatch_d(head_dim, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    Side tiled = sd;
    const void *qs = q, *ks = k;
    float pre = q_pre;
    if (sd.cos != nullptr) {
      const long n = (long)B * L * H * (D / 8);
      const dim3 blocks((unsigned)((n + ROTATE_THREADS - 1) / ROTATE_THREADS));
      const int rc = launch(rotate_qk<D>, blocks, ROTATE_THREADS, 0, in_f32(q), in_f32(k), sd,
                            out_f32(q_rot), out_f32(k_rot), n, q_pre);
      if (rc != 0) return rc;
      tiled.cos = tiled.sin = nullptr;
      qs = q_rot, ks = k_rot, pre = 1.f;
    }
    return launch(fwd_tiled<D>, grid_of(B, L, H), THREADS, FwdSmem<D>::bytes((L + ROWS - 1) / ROWS),
                  in_f32(qs), in_f32(ks), in_f32(v), tiled, out_f32(out), out_f32(lse), pre);
  });
}

// #2 with its prologue
template <class Launch>
int bwd_dq(const Launch& launch, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* bias, const void* cos, const void* sin, const void* seg,
           const void* lse, void* dq, void* q_r, void* delta, int B, int L, int H, int head_dim,
           float q_pre, float dq_scale) {
  const Side sd = make_side(bias, cos, sin, seg, L, H);
  return dispatch_d(head_dim, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch(dq_kernel<D>, grid_of(B, L, H), ROWS, 0, in_f32(q), in_f32(k), in_f32(v),
                  in_f32(o), in_f32(dout), sd, in_f32(lse), out_f32(dq), out_f32(q_r),
                  out_f32(delta), q_pre, dq_scale);
  });
}

// #3 on #2's q_r and delta
template <class Launch>
int bwd_dkv(const Launch& launch, const void* q_r, const void* k, const void* v,
            const void* dout, const void* bias, const void* cos, const void* sin,
            const void* seg, const void* lse, const void* delta, void* dk, void* dv, int B, int L,
            int H, int head_dim, float dk_scale) {
  const Side sd = make_side(bias, cos, sin, seg, L, H);
  return dispatch_d(head_dim, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch(dkv_tiled<D>, grid_of(B, L, H), THREADS,
                  DkvSmem<D>::bytes((L + Tiles<D>::QT - 1) / Tiles<D>::QT), in_f32(q_r),
                  in_f32(k), in_f32(v), in_f32(dout), sd, in_f32(lse), in_f32(delta),
                  out_f32(dk), out_f32(dv), dk_scale);
  });
}

#ifdef __CUDACC__
// `launch` on the card: <<<>>> on a stream, the kernel's dynamic shared
// memory allowed first
struct CudaLaunch {
  cudaStream_t stream;
  template <class... P, class... A>
  int operator()(void (*kernel)(P...), dim3 grid, int threads, int smem, A... args) const {
    if (smem > 0) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, threads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
};
#endif

}  // namespace f32mha
