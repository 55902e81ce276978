// Fused exact GELU -> per-row symmetric int8 quantization.
//
// Replaces: oneprot_tpu/kernels/gelu_quant.py:_kernel (launched by
// gelu_quant_pallas, behind fused_gelu_quant). Same function: for each row
// of y [M, N], g = gelu(y) in f32, s = max(max|g|, 1e-12) / 127,
// q = round_half_even(g / s) as int8; outputs q [M, N] and s [M]. Like the
// TPU kernel, erf is Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7, four orders
// below the int8 step): one reciprocal and one exp2 on the special-function
// units and five fused multiply-adds, where libdevice's erff branches and
// takes some 25 instructions. q is g times one reciprocal of s a row,
// rounded to nearest even by adding 1.5 * 2^23 (the code lands in the low
// byte), so a code may differ by one from round(g / s) where g / s sits
// within an ulp or two of a .5 tie.
//
// What bounds it on H100: bytes, 3 a value (bf16 in, int8 out), against
// some 20 instructions a value: 0.075 ms at M=16384 N=5120, 0.30 ms at
// N=20480. The first version (erff, an IEEE division a value) issued ~50
// instructions a value, and that, not memory, set its pace.
//
// Design: TPR threads a row (32 to 512: the fewest that leave a thread at
// most 5 vectors of 16 bytes), max(256, TPR) threads a block, so narrow rows
// share a block and a wide row's gelu(y) fits in 64 registers a thread. A
// thread loads its V vectors (vector v at column 8 (lane_in_row + v TPR)),
// all before any arithmetic, unpacks bf16 by shifts, keeps gelu(y) in
// registers through the row's abs-max (warp shuffles, then one shared word
// a warp and one barrier), and stores 8 codes a vector as one 8-byte word
// packed by byte permutes. Rows of up to 20480 bf16 values (the ESM2-15B
// width's fc1: 512 threads of 5 vectors) are read once. Rows whose width is
// no multiple of a vector, misaligned pointers and wider rows take a scalar
// path that reads the row twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;  // a block's threads, for rows of up to 256 threads
constexpr int MAX_V = 5;       // vectors a thread on the one-read path
constexpr int MAX_TPR = 512;

// Abramowitz-Stegun 7.1.26: erf(z) = 1 - poly(t) e^(-z^2), t = 1 / (1 + p z)
constexpr float AS_P = 0.3275911f;
constexpr float AS_A1 = 0.254829592f, AS_A2 = -0.284496736f, AS_A3 = 1.421413741f,
                AS_A4 = -1.453152027f, AS_A5 = 1.061405429f;
constexpr float P_OVER_SQRT2 = AS_P * 0.70710678118654752440f;
constexpr float NEG_HALF_LOG2E = -0.72134752044448170368f;  // e^(-x^2/2) = 2^(-x^2 log2(e) / 2)
constexpr float ROUND_MAGIC = 12582912.f;                   // 1.5 * 2^23

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// gelu(x) = x (1 + erf(x / sqrt 2)) / 2 = x - c (x >= 0) or c (x < 0), with
// c = x poly(t) e^(-x^2 / 2) / 2 and t = 1 / (1 + p |x| / sqrt 2)
__device__ __forceinline__ float gelu_as(float x) {
  const float t = rcp_approx(fmaf(fabsf(x), P_OVER_SQRT2, 1.f));
  const float poly = t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, AS_A5, AS_A4), AS_A3), AS_A2), AS_A1);
  const float c = (0.5f * x) * (poly * ex2_approx(x * x * NEG_HALF_LOG2E));
  return x >= 0.f ? x - c : c;
}

// round_half_even(g * inv) in the low byte (|g * inv| <= 127 + an ulp)
__device__ __forceinline__ uint32_t code_bits(float g, float inv) {
  return __float_as_uint(fmaf(g, inv, ROUND_MAGIC));
}
// the low bytes of a, b, c, d as one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {  // 8 bf16: the high or low half of a word, shifted
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(int8_t* dst, const uint32_t (&c)[8]) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]));
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void store(int8_t* dst, const uint32_t (&c)[4]) {
    *reinterpret_cast<uint32_t*>(dst) = pack4(c[0], c[1], c[2], c[3]);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The one-read path: each row's 16-byte vectors split over tpr threads
// (THREADS / tpr rows a block), at most V vectors a thread.
template <typename T, int V, int THREADS>
__global__ void __launch_bounds__(THREADS)
    gelu_quant_rows(const T* __restrict__ y, int8_t* __restrict__ q, float* __restrict__ scale,
                    long long M, int N, int tpr) {
  using W = Vec<T>;
  constexpr int E = W::N;
  __shared__ float warp_max[THREADS / 32];
  const int in_row = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * (THREADS / tpr) + threadIdx.x / tpr;
  const bool active = row < M;
  const int nvec = N / E;
  const T* yr = y + row * N;
  uint4 raw[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int vec = in_row + v * tpr;
    raw[v] = active && vec < nvec ? __ldcs(reinterpret_cast<const uint4*>(yr) + vec)
                                  : make_uint4(0u, 0u, 0u, 0u);
  }
  float g[V][E];
  float amax = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    W::unpack(raw[v], g[v]);
    const bool ok = active && in_row + v * tpr < nvec;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      g[v][e] = gelu_as(g[v][e]);
      if (ok) amax = fmaxf(amax, fabsf(g[v][e]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  const int w0 = (threadIdx.x / tpr) * (tpr / 32);
  for (int w = 0; w < tpr / 32; ++w) amax = fmaxf(amax, warp_max[w0 + w]);
  if (!active) return;
  const float s = fmaxf(amax, 1e-12f) / 127.f;
  const float inv = 1.f / s;
  if (in_row == 0) scale[row] = s;
  int8_t* qr = q + row * N;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int vec = in_row + v * tpr;
    if (vec < nvec) {
      uint32_t c[E];
#pragma unroll
      for (int e = 0; e < E; ++e) c[e] = code_bits(g[v][e], inv);
      W::store(qr + vec * E, c);
    }
  }
}

// Any row: one block a row, one element a step, the row read twice (the
// second time from L1/L2).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gelu_quant_any(const T* __restrict__ y, int8_t* __restrict__ q, float* __restrict__ scale,
                   int N) {
  __shared__ float warp_max[NTHREADS / 32];
  const T* yr = y + (size_t)blockIdx.x * N;
  int8_t* qr = q + (size_t)blockIdx.x * N;
  float amax = 0.f;
  for (int i = threadIdx.x; i < N; i += NTHREADS) amax = fmaxf(amax, fabsf(gelu_as(to_f32(yr[i]))));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  for (int w = 0; w < NTHREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = fmaxf(amax, 1e-12f) / 127.f;
  const float inv = 1.f / s;
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
  for (int i = threadIdx.x; i < N; i += NTHREADS)
    qr[i] = static_cast<int8_t>(code_bits(gelu_as(to_f32(yr[i])), inv) & 0xff);
}

template <typename T, int THREADS>
void launch_rows(const void* y, void* q, void* scale, long long M, int N, int tpr, int v,
                 cudaStream_t stream) {
  const long long rows_per_block = THREADS / tpr;
  const dim3 grid(static_cast<unsigned>((M + rows_per_block - 1) / rows_per_block));
  auto kernel = v <= 1   ? gelu_quant_rows<T, 1, THREADS>
                : v == 2 ? gelu_quant_rows<T, 2, THREADS>
                : v == 3 ? gelu_quant_rows<T, 3, THREADS>
                : v == 4 ? gelu_quant_rows<T, 4, THREADS>
                         : gelu_quant_rows<T, MAX_V, THREADS>;
  kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(y), static_cast<int8_t*>(q),
                                       static_cast<float*>(scale), M, N, tpr);
}

template <typename T>
int launch(const void* y, void* q, void* scale, long long M, int N, cudaStream_t stream) {
  constexpr int E = Vec<T>::N;
  const int nvec = N / E;
  const bool aligned = N % E == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 8 == 0;
  if (!aligned || nvec > MAX_TPR * MAX_V) {
    gelu_quant_any<T><<<dim3(static_cast<unsigned>(M)), NTHREADS, 0, stream>>>(
        static_cast<const T*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale), N);
    return static_cast<int>(cudaGetLastError());
  }
  // the fewest threads a row (a warp at least) that keep V <= MAX_V, then V
  int tpr = 32;
  while (nvec > MAX_V * tpr) tpr *= 2;
  const int v = (nvec + tpr - 1) / tpr;
  if (tpr <= NTHREADS)
    launch_rows<T, NTHREADS>(y, q, scale, M, N, tpr, v, stream);
  else
    launch_rows<T, MAX_TPR>(y, q, scale, M, N, tpr, v, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: contiguous [M, N], bf16 (y_is_f32 = 0) or f32 (y_is_f32 = 1);
// q: int8 [M, N]; scale: f32 [M]. Returns cudaGetLastError() after launch.
extern "C" int oneprot_gelu_quant(const void* y, int y_is_f32, void* q,
                                  void* scale, long long M, int N,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return y_is_f32 ? launch<float>(y, q, scale, M, N, s)
                  : launch<__nv_bfloat16>(y, q, scale, M, N, s);
}
