// Flash multi-head attention backward, dk and dv, in float32: the f32
// instance of #3, on q_r and delta as the f32 dq kernel writes them.
//
// Replaces, for float32 inputs: oneprot_tpu/kernels/flash_mha.py:
// _bwd_dkv_kernel. The kernel, what bounds it, its design and its launch:
// flash_mha_f32.cuh.

#include "flash_mha_f32.cuh"

extern "C" int oneprot_flash_mha_bwd_dkv_f32(const void* q_r, const void* k, const void* v,
                                             const void* dout, const void* bias, const void* cos,
                                             const void* sin, const void* seg, const void* lse,
                                             const void* delta, void* dk, void* dv, int B, int L,
                                             int H, int D, float dk_scale, int device,
                                             void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return f32mha::bwd_dkv(f32mha::CudaLaunch{static_cast<cudaStream_t>(stream)}, q_r, k, v, dout,
                         bias, cos, sin, seg, lse, delta, dk, dv, B, L, H, D, dk_scale);
}
