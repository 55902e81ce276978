// C entry points over the emulated f32 flash-MHA kernels (see cuda_emu.h):
// csrc/flash_mha_*_f32.cu's, on host pointers, through the header's own
// launch plans (f32mha::fwd, bwd_dq, bwd_dkv) with emu_launch in place of
// <<<>>>. Each returns the largest dynamic shared memory of its launches in
// bytes (0 for the dq kernel, whose shared arrays are static), or minus the
// plan's error code. Compiled by test_torch_f32_emulated.py against its
// emulation copy of flash_mha_f32.cuh.
#include "f32_emu.cuh"

namespace {

struct EmuLaunch {
  int* smem;
  template <class K, class... A>
  int operator()(K kernel, dim3 grid, int threads, int bytes, A... args) const {
    *smem = max(*smem, bytes);
    emu_launch(grid, threads, bytes, [&] { kernel(args...); });
    return 0;
  }
};

template <class Plan>
int smem_of(Plan&& plan) {
  int smem = 0;
  const int rc = plan(EmuLaunch{&smem});
  return rc != 0 ? -rc : smem;
}

}  // namespace

extern "C" int emu_flash_mha_fwd_f32(const float* q, const float* k, const float* v,
                                     const float* bias, const float* cos, const float* sin,
                                     const int* seg, float* out, float* lse, float* q_rot,
                                     float* k_rot, int B, int L, int H, int D, float q_pre) {
  return smem_of([&](const EmuLaunch& launch) {
    return f32mha::fwd(launch, q, k, v, bias, cos, sin, seg, out, lse, q_rot, k_rot, B, L, H, D,
                       q_pre);
  });
}

extern "C" int emu_flash_mha_bwd_dq_f32(const float* q, const float* k, const float* v,
                                        const float* o, const float* dout, const float* bias,
                                        const float* cos, const float* sin, const int* seg,
                                        const float* lse, float* dq, float* q_r, float* delta,
                                        int B, int L, int H, int D, float q_pre,
                                        float dq_scale) {
  return smem_of([&](const EmuLaunch& launch) {
    return f32mha::bwd_dq(launch, q, k, v, o, dout, bias, cos, sin, seg, lse, dq, q_r, delta, B,
                          L, H, D, q_pre, dq_scale);
  });
}

extern "C" int emu_flash_mha_bwd_dkv_f32(const float* q_r, const float* k, const float* v,
                                         const float* dout, const float* bias, const float* cos,
                                         const float* sin, const int* seg, const float* lse,
                                         const float* delta, float* dk, float* dv, int B, int L,
                                         int H, int D, float dk_scale) {
  return smem_of([&](const EmuLaunch& launch) {
    return f32mha::bwd_dkv(launch, q_r, k, v, dout, bias, cos, sin, seg, lse, delta, dk, dv, B,
                           L, H, D, dk_scale);
  });
}
