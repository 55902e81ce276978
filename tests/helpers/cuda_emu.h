// A CPU emulation of the CUDA that the f32 flash-MHA kernels
// (oneprot_tpu_torch/kernels/csrc/flash_mha_f32.cuh) use, so their source
// can be compiled by the host's C++ compiler and run on CPU tensors:
// one std::thread per CUDA thread, the blocks of a grid one after another,
// std::barrier for __syncthreads and for the warp collectives (shuffles,
// ballots), static shared arrays as statics (one block runs at a time) and
// dynamic shared memory as a buffer filled with NaN, so a read of a word
// that no thread wrote shows in the result. test_torch_f32_emulated.py
// replaces its inline PTX (the cp.async helpers, the SFU exp2) before
// compiling.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <math.h>

using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;

inline thread_local dim3 threadIdx;
inline dim3 blockIdx;

// the running block: its barriers, the warps' exchange words, shared memory
struct EmuBlock {
  std::barrier<> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  unsigned xch[1024];
  std::vector<float4> dyn;
  EmuBlock(int threads, int smem_bytes)
      : block(threads), dyn(smem_bytes / 16 + 1, float4{NAN, NAN, NAN, NAN}) {
    for (int w = 0; w < (threads + 31) / 32; ++w) warps.emplace_back(new std::barrier<>(32));
  }
};
inline EmuBlock* emu_block = nullptr;

inline void __syncthreads() { emu_block->block.arrive_and_wait(); }
inline void emu_warp_wait() { emu_block->warps[threadIdx.x / 32]->arrive_and_wait(); }

template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles");
  const unsigned t = threadIdx.x;
  std::memcpy(&emu_block->xch[t], &v, 4);
  emu_warp_wait();
  T r;
  std::memcpy(&r, &emu_block->xch[t ^ lane_mask], 4);
  emu_warp_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  const unsigned t = threadIdx.x, w0 = t / 32 * 32;
  emu_block->xch[t] = p;
  emu_warp_wait();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m |= (emu_block->xch[w0 + i] ? 1u : 0u) << i;
  emu_warp_wait();
  return m;
}
inline bool __any_sync(unsigned mask, bool p) { return __ballot_sync(mask, p) != 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float4 __ldg(const float4* p) { return *p; }
inline float4* emu_dynamic_smem() { return emu_block->dyn.data(); }

// Run kern() as every thread of every block of `grid`, `threads` a block,
// with `smem_bytes` of dynamic shared memory.
template <class F>
void emu_launch(dim3 grid, int threads, int smem_bytes, const F& kern) {
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      for (unsigned x = 0; x < grid.x; ++x) {
        EmuBlock blk(threads, smem_bytes);
        emu_block = &blk;
        blockIdx = dim3(x, y, z);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t) {
          ts.emplace_back([t, &kern] {
            threadIdx = dim3(t);
            kern();
          });
        }
        for (auto& th : ts) th.join();
        emu_block = nullptr;
      }
    }
  }
}
