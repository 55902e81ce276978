// Flash multi-head attention backward, dk and dv, in float32: the f32
// instance of #3, on q_r and delta as the f32 dq kernel writes them.
//
// Replaces, for float32 inputs: oneprot_tpu/kernels/flash_mha.py:
// _bwd_dkv_kernel. The kernel, what bounds it and its design:
// flash_mha_f32.cuh.

#include "flash_mha_f32.cuh"

namespace {

struct Dkv {
  const float *q_r, *k, *v, *dout;
  f32mha::Side sd;
  const float *lse, *delta;
  float *dk, *dv;
  float dk_scale;
  int B;
  cudaStream_t stream;
  template <int D>
  int operator()() const {
    f32mha::dkv_kernel<D><<<f32mha::grid_of(B, sd.L, sd.H), f32mha::ROWS, 0, stream>>>(
        q_r, k, v, dout, sd, lse, delta, dk, dv, dk_scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int oneprot_flash_mha_bwd_dkv_f32(const void* q_r, const void* k, const void* v,
                                             const void* dout, const void* bias, const void* cos,
                                             const void* sin, const void* seg, const void* lse,
                                             const void* delta, void* dk, void* dv, int B, int L,
                                             int H, int D, float dk_scale, int device,
                                             void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dkv f{static_cast<const float*>(q_r),
              static_cast<const float*>(k),
              static_cast<const float*>(v),
              static_cast<const float*>(dout),
              f32mha::make_side(bias, cos, sin, seg, L, H),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<float*>(dk),
              static_cast<float*>(dv),
              dk_scale,
              B,
              static_cast<cudaStream_t>(stream)};
  return f32mha::dispatch_d(D, f);
}
