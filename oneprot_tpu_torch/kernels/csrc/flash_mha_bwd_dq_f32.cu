// Flash multi-head attention backward, dq, in float32: the f32 instance of
// #2, with the prologue that writes q_r = rot(q) * q_pre and delta =
// rowsum(dO * O) for the dk/dv kernel.
//
// Replaces, for float32 inputs: oneprot_tpu/kernels/flash_mha.py:
// _bwd_dq_kernel. The kernel, what bounds it, its design and its launch:
// flash_mha_f32.cuh.

#include "flash_mha_f32.cuh"

// q, k, v, out, dout, dq, q_r: contiguous f32 [B, L, H*D]; lse, delta: f32
// [B, H, L]. bias: f32 [B, L] in log2 units or null; cos, sin: f32 [L, D]
// or both null; seg: int32 [B, L] or null. k_rot: f32 [B, L, H*D] scratch,
// used with rotary only (null without).
extern "C" int oneprot_flash_mha_bwd_dq_f32(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const void* bias,
                                            const void* cos, const void* sin, const void* seg,
                                            const void* lse, void* dq, void* q_r, void* delta,
                                            void* k_rot, int B, int L, int H, int D, float q_pre,
                                            float dq_scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return f32mha::bwd_dq(f32mha::CudaLaunch{static_cast<cudaStream_t>(stream)}, q, k, v, out,
                        dout, bias, cos, sin, seg, lse, dq, q_r, delta, k_rot, B, L, H, D,
                        q_pre, dq_scale);
}
