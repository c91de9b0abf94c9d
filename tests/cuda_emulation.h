// A stand-in for the CUDA toolkit's headers that lets g++ compile the
// port's kernels (`vss_tpu_torch/csrc/*.cu`) and run them on the CPU, so
// that a kernel's control flow and index arithmetic can be tested where
// there is no nvcc and no card (`tests/test_torch_beam_emulated.py`).
//
// A block's threads are cooperative fibers (ucontext) run in turn by
// `emu_launch`; a fiber runs until it reaches a barrier, then the next one
// does. Every barrier, shuffle, ballot and warp reduction is a switch
// point, so the emulation is only valid for kernels in which all threads
// of a block reach the same sequence of such calls (uniform control flow
// around them): the launcher counts a divergence (`emu_divergences`) and
// gives the block up when some fibers end while others wait. Blocks run
// one after another. It shows what a kernel computes, never how fast, and
// it cannot show a missing barrier: between two switch points a fiber
// runs alone.
#pragma once
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

using std::isfinite;
using std::isnan;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __align__(x)
#define CUDART_INF_F (__builtin_inff())

struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
inline EmuDim threadIdx, blockIdx, blockDim, gridDim;

struct uint4 {
  uint32_t x, y, z, w;
};
struct uint2 {
  uint32_t x, y;
};
struct float4 {
  float x, y, z, w;
};
struct __nv_bfloat16 {
  uint16_t v;
};

inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __bfloat162float(__nv_bfloat16 b) {
  return __uint_as_float(uint32_t(b.v) << 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
// compile with -ffp-contract=off: each of these rounds on its own
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// ---- the block being run
struct Emu {
  std::vector<ucontext_t> fibers;
  ucontext_t scheduler;
  int current = 0;  // the running fiber == threadIdx.x
  int threads = 0;
  std::vector<char> ended;
  std::vector<uint32_t> slots;  // one value per thread, for warp exchanges
  std::vector<char*> stacks;
  std::function<void()> body;
  unsigned char* smem = nullptr;  // the block's dynamic shared memory
};
inline Emu emu;
inline int emu_divergences = 0;

inline void emu_switch() {
  swapcontext(&emu.fibers[emu.current], &emu.scheduler);
}
inline void __syncthreads() { emu_switch(); }
inline void __syncwarp() { emu_switch(); }

template <typename V>
inline V __shfl_xor_sync(unsigned, V v, int lane_mask) {
  static_assert(sizeof(V) == 4, "32-bit values only");
  const int t = emu.current;
  memcpy(&emu.slots[t], &v, 4);
  emu_switch();
  const uint32_t got = emu.slots[t ^ lane_mask];
  emu_switch();
  V out;
  memcpy(&out, &got, 4);
  return out;
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int t = emu.current;
  emu.slots[t] = pred;
  emu_switch();
  unsigned mask = 0;
  const int first = t & ~31;
  for (int l = 0; l < 32 && first + l < emu.threads; ++l)
    if (emu.slots[first + l]) mask |= 1u << l;
  emu_switch();
  return mask;
}
inline int __any_sync(unsigned m, bool pred) {
  return __ballot_sync(m, pred) != 0;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const int t = emu.current;
  emu.slots[t] = v;
  emu_switch();
  unsigned least = 0xffffffffu;
  const int first = t & ~31;
  for (int l = 0; l < 32 && first + l < emu.threads; ++l)
    if (emu.slots[first + l] < least) least = emu.slots[first + l];
  emu_switch();
  return least;
}
// one fiber runs at a time: plain read-modify-write is atomic
template <typename V>
inline V atomicAdd(V* p, V v) {
  const V old = *p;
  *p += v;
  return old;
}
template <typename V>
inline V atomicMax(V* p, V v) {
  const V old = *p;
  if (v > old) *p = v;
  return old;
}

static void emu_fiber_main() {
  emu.body();
  emu.ended[emu.current] = 1;
  emu_switch();
}

// kernel<<<grid, block, smem>>>(args...) as a call: the test rewrites the
// launch syntax to this.
template <typename K, typename... A>
inline void emu_launch(K kernel, int grid, int block, size_t smem, A... args) {
  const size_t stack_bytes = 512 * 1024;
  emu.threads = block;
  emu.fibers.resize(block);
  emu.slots.assign(block + 32, 0);
  while (static_cast<int>(emu.stacks.size()) < block)
    emu.stacks.push_back(static_cast<char*>(malloc(stack_bytes)));
  const size_t smem_bytes = (smem + 127) / 128 * 128 + 128;
  emu.smem = static_cast<unsigned char*>(aligned_alloc(128, smem_bytes));
  blockDim.x = block;
  gridDim.x = grid;
  emu.body = [&]() { kernel(args...); };
  for (int b = 0; b < grid; ++b) {
    memset(emu.smem, 0xAB, smem_bytes);  // uninitialised, as on the card
    blockIdx.x = b;
    emu.ended.assign(block, 0);
    for (int t = 0; t < block; ++t) {
      getcontext(&emu.fibers[t]);
      emu.fibers[t].uc_stack.ss_sp = emu.stacks[t];
      emu.fibers[t].uc_stack.ss_size = stack_bytes;
      emu.fibers[t].uc_link = &emu.scheduler;
      makecontext(&emu.fibers[t], emu_fiber_main, 0);
    }
    for (;;) {
      int waiting = 0, ended = 0;
      for (int t = 0; t < block; ++t) {
        if (emu.ended[t]) continue;
        emu.current = t;
        threadIdx.x = t;
        swapcontext(&emu.scheduler, &emu.fibers[t]);
        if (emu.ended[t])
          ++ended;
        else
          ++waiting;
      }
      if (waiting && ended) {
        fprintf(stderr, "emulation: %d threads wait at a barrier that %d "
                        "threads never reach\n", waiting, ended);
        ++emu_divergences;
        break;
      }
      if (!waiting) break;
    }
  }
  free(emu.smem);
  emu.smem = nullptr;
}
