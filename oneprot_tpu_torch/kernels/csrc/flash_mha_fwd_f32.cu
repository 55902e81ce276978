// Flash multi-head attention forward in float32: the f32 instance of #1.
//
// Replaces, for float32 inputs: oneprot_tpu/kernels/flash_mha.py:_fwd_kernel.
// The kernel, what bounds it, its design and its launches: flash_mha_f32.cuh.

#include "flash_mha_f32.cuh"

// q, k, v, out: contiguous f32 [B, L, H*D]; lse: f32 [B, H, L]. bias: f32
// [B, L] in log2 units or null; cos, sin: f32 [L, D] or both null; seg:
// int32 [B, L] or null. q_rot, k_rot: f32 [B, L, H*D] scratch, used with
// rotary only (null without).
extern "C" int oneprot_flash_mha_fwd_f32(const void* q, const void* k, const void* v,
                                         const void* bias, const void* cos, const void* sin,
                                         const void* seg, void* out, void* lse, void* q_rot,
                                         void* k_rot, int B, int L, int H, int D, float q_pre,
                                         int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return f32mha::fwd(f32mha::CudaLaunch{static_cast<cudaStream_t>(stream)}, q, k, v, bias, cos,
                     sin, seg, out, lse, q_rot, k_rot, B, L, H, D, q_pre);
}
