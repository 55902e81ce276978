// Flash multi-head attention forward in float32: the f32 instance of #1.
//
// Replaces, for float32 inputs: oneprot_tpu/kernels/flash_mha.py:_fwd_kernel.
// The kernel, what bounds it and its design: flash_mha_f32.cuh.

#include "flash_mha_f32.cuh"

namespace {

struct Fwd {
  const float *q, *k, *v;
  f32mha::Side sd;
  float *out, *lse;
  float q_pre;
  int B;
  cudaStream_t stream;
  template <int D>
  int operator()() const {
    f32mha::fwd_kernel<D><<<f32mha::grid_of(B, sd.L, sd.H), f32mha::ROWS, 0, stream>>>(
        q, k, v, sd, out, lse, q_pre);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int oneprot_flash_mha_fwd_f32(const void* q, const void* k, const void* v,
                                         const void* bias, const void* cos, const void* sin,
                                         const void* seg, void* out, void* lse, int B, int L,
                                         int H, int D, float q_pre, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Fwd f{static_cast<const float*>(q),
              static_cast<const float*>(k),
              static_cast<const float*>(v),
              f32mha::make_side(bias, cos, sin, seg, L, H),
              static_cast<float*>(out),
              static_cast<float*>(lse),
              q_pre,
              B,
              static_cast<cudaStream_t>(stream)};
  return f32mha::dispatch_d(D, f);
}
