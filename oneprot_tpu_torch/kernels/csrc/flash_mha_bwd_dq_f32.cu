// Flash multi-head attention backward, dq, in float32: the f32 instance of
// #2, with the prologue that writes q_r = rot(q) * q_pre and delta =
// rowsum(dO * O) for the dk/dv kernel.
//
// Replaces, for float32 inputs: oneprot_tpu/kernels/flash_mha.py:
// _bwd_dq_kernel. The kernel, what bounds it and its design:
// flash_mha_f32.cuh.

#include "flash_mha_f32.cuh"

namespace {

struct Dq {
  const float *q, *k, *v, *o, *dout;
  f32mha::Side sd;
  const float* lse;
  float *dq, *q_r, *delta;
  float q_pre, dq_scale;
  int B;
  cudaStream_t stream;
  template <int D>
  int operator()() const {
    f32mha::dq_kernel<D><<<f32mha::grid_of(B, sd.L, sd.H), f32mha::ROWS, 0, stream>>>(
        q, k, v, o, dout, sd, lse, dq, q_r, delta, q_pre, dq_scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int oneprot_flash_mha_bwd_dq_f32(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const void* bias,
                                            const void* cos, const void* sin, const void* seg,
                                            const void* lse, void* dq, void* q_r, void* delta,
                                            int B, int L, int H, int D, float q_pre,
                                            float dq_scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dq f{static_cast<const float*>(q),
             static_cast<const float*>(k),
             static_cast<const float*>(v),
             static_cast<const float*>(out),
             static_cast<const float*>(dout),
             f32mha::make_side(bias, cos, sin, seg, L, H),
             static_cast<const float*>(lse),
             static_cast<float*>(dq),
             static_cast<float*>(q_r),
             static_cast<float*>(delta),
             q_pre,
             dq_scale,
             B,
             static_cast<cudaStream_t>(stream)};
  return f32mha::dispatch_d(D, f);
}
