// Fused exact GELU -> per-row symmetric int8 quantization.
//
// Replaces: oneprot_tpu/kernels/gelu_quant.py:_kernel (launched by
// gelu_quant_pallas, behind fused_gelu_quant). Same function: for each row
// of y [M, N], g = gelu(y) in f32 with the exact erf, s = max(max|g|, 1e-12)
// / 127, q = round_half_even(g / s) as int8; outputs q [M, N] and s [M].
// CUDA has erff, so the TPU kernel's polynomial erf is not carried over.
//
// What bounds it on H100: bytes. Each element is read once (2 bytes in
// bf16) and written once (1 byte), against ~20 f32 operations, far below
// the card's flop/byte ridge.
//
// Design: one block per row, so the row's abs-max is a block reduction
// (warp shuffles, then one shared word per warp) and no second kernel or
// atomic is needed. Loads are 16-byte vectors when the row length and the
// pointers allow it. A row of up to 8 vectors a thread (8192 bf16 values,
// the hub's 5120 among them) is read once, all loads issued before any
// math, and gelu(y) stays in registers until it is quantized. A longer row
// takes two passes, the second reading the row again from L1/L2 and
// recomputing gelu, so the kernel takes any N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// VEC consecutive elements starting at i (VEC * sizeof(T) is 16 bytes, or VEC = 1)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_f32(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f32(e[i]);
  }
}

__device__ __forceinline__ int8_t quantize(float g, float s) {
  // IEEE division and round-half-even, as the reference's round(g / s)
  const float r = rintf(__fdiv_rn(g, s));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* dst, const int8_t (&c)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(c);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(c);
  } else {
    dst[0] = c[0];
  }
}

// max over the block; every thread gets it
__device__ __forceinline__ float block_max(float v, float* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  v = warp_max[0];
#pragma unroll
  for (int w = 1; w < NTHREADS / 32; ++w) v = fmaxf(v, warp_max[w]);
  return v;
}

// Rows of up to MAXV vectors a thread keep gelu(y) in registers: one read,
// all loads in flight at once. Longer rows (or VEC = 1) take two passes.
template <typename T, int VEC, int MAXV>
__global__ void __launch_bounds__(NTHREADS)
gelu_quant_kernel(const T* __restrict__ y, int8_t* __restrict__ q,
                  float* __restrict__ scale, int N) {
  __shared__ float warp_max[NTHREADS / 32];
  const size_t row = blockIdx.x;
  const T* yr = y + row * N;
  int8_t* qr = q + row * N;

  if constexpr (VEC > 1) {
    if (N <= MAXV * NTHREADS * VEC) {
      uint4 raw[MAXV];
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        const int i = (threadIdx.x + v * NTHREADS) * VEC;
        if (i < N) raw[v] = *reinterpret_cast<const uint4*>(yr + i);
      }
      float g[MAXV][VEC];
      float amax = 0.f;
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        if ((threadIdx.x + v * NTHREADS) * VEC >= N) continue;
        const T* e = reinterpret_cast<const T*>(&raw[v]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          g[v][k] = gelu_exact(to_f32(e[k]));
          amax = fmaxf(amax, fabsf(g[v][k]));
        }
      }
      const float s = fmaxf(block_max(amax, warp_max), 1e-12f) / 127.f;
      if (threadIdx.x == 0) scale[row] = s;
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        const int i = (threadIdx.x + v * NTHREADS) * VEC;
        if (i < N) {
          alignas(8) int8_t c[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) c[k] = quantize(g[v][k], s);
          store_codes<VEC>(qr + i, c);
        }
      }
      return;
    }
  }

  float amax = 0.f;
  for (int i = threadIdx.x * VEC; i < N; i += NTHREADS * VEC) {
    float x[VEC];
    load_vec<T, VEC>(yr + i, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(gelu_exact(x[e])));
  }
  const float s = fmaxf(block_max(amax, warp_max), 1e-12f) / 127.f;
  if (threadIdx.x == 0) scale[row] = s;
  // second pass: the row is still in L1/L2, so device memory sees it once
  for (int i = threadIdx.x * VEC; i < N; i += NTHREADS * VEC) {
    float x[VEC];
    load_vec<T, VEC>(yr + i, x);
    alignas(8) int8_t c[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) c[e] = quantize(gelu_exact(x[e]), s);
    store_codes<VEC>(qr + i, c);
  }
}

template <typename T>
int launch(const void* y, void* q, void* scale, long long M, int N,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = N % VEC == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(M));
  if (aligned)
    gelu_quant_kernel<T, VEC, 8><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(y), static_cast<int8_t*>(q),
        static_cast<float*>(scale), N);
  else
    gelu_quant_kernel<T, 1, 1><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(y), static_cast<int8_t*>(q),
        static_cast<float*>(scale), N);
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
