// Device helpers shared by the attention kernels (the FlashAttention-2
// forward and backward, the flash-MHA forward and backward): the segment
// mask, bf16 packing, dot8 and row_sum. The wgmma, TMA and mbarrier
// primitives and the accumulator's fragment layout are hopper.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float SEG_MASK = -1e30f;  // cross-segment logit, as the TPU kernel

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// sum of the products of 8 bf16 pairs, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fx = __bfloat1622float2(x[e]), fy = __bfloat1622float2(y[e]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

// Sum over the N lanes (a power of two up to 32, aligned) that share a row.
template <int N>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = N / 2; m > 0; m /= 2) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

}  // namespace flash
