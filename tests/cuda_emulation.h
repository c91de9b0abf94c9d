// A stand-in for the CUDA toolkit's headers that lets g++ compile the
// port's kernels (`vss_tpu_torch/csrc/*.cu`) and run them on the CPU, so
// that a kernel's control flow and index arithmetic can be tested where
// there is no nvcc and no card (`tests/test_torch_*_emulated.py`, built by
// `tests/emulation.py`).
//
// A block's threads are cooperative fibers (ucontext) run in turn by
// `emu_launch`; a fiber runs until it reaches a barrier, then the next one
// does. Every barrier, shuffle, ballot, warp reduction, `ldmatrix` and
// `mma` (the stand-ins for csrc/mma.cuh) is a switch point, so the
// emulation is only valid for kernels in which all threads of a warp
// reach the same sequence of such calls (uniform control flow around
// them). `__syncthreads` waits for every thread of the block: warps may
// pass different numbers of warp-level switch points between two block
// barriers (a warp that sorts alone, say). The launcher counts a
// divergence (`emu_divergences`) and gives the block up when some fibers
// end while others wait. Blocks run one after another. `cp.async` copies
// (the stand-ins for csrc/cpasync.cuh) land only when their group is
// awaited, so a read of a stage that was not awaited sees the old bytes.
// It shows what a kernel computes, never how fast, and it cannot show a
// missing barrier: between two switch points a fiber runs alone.
#pragma once
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <vector>

using std::isfinite;
using std::isnan;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x)
// a block's static shared memory: blocks run one after another, so one
// function-static object per declaration serves each block in turn (it
// keeps the last block's bytes, as the card's holds stale ones)
#define __shared__ static
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
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
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
// the card's rsqrtf is within 2 ulp of this: tests compare with a tolerance
inline float rsqrtf(float a) { return 1.0f / sqrtf(a); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __clzll(long long v) { return v == 0 ? 64 : __builtin_clzll(static_cast<unsigned long long>(v)); }
// four signed 8-bit products of a and b, summed into c
inline int __dp4a(int a, int b, int c) {
  for (int i = 0; i < 4; ++i)
    c += static_cast<int8_t>(a >> (8 * i)) * static_cast<int8_t>(b >> (8 * i));
  return c;
}

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaSharedmemCarveoutMaxShared = 100
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
  std::vector<uint32_t> frags;  // kFragWords per thread, for ldmatrix / mma
  std::vector<const void*> rows;  // one address per thread, for ldmatrix
  std::vector<char*> stacks;
  std::function<void()> body;
  unsigned char* smem = nullptr;  // the block's dynamic shared memory
  std::vector<char> at_barrier;   // waits at __syncthreads
  // each thread's cp.async copies: the open group, then the committed ones
  struct Copy {
    void* dst;
    const void* src;
    int bytes;
  };
  std::vector<std::vector<Copy>> open;
  std::vector<std::deque<std::vector<Copy>>> committed;
};
constexpr int kFragWords = 6;  // an mma's A (4 words) and B (2 words)
inline Emu emu;
inline int emu_divergences = 0;

inline void emu_switch() {
  swapcontext(&emu.fibers[emu.current], &emu.scheduler);
}
// the launcher lets a round's waiters go once every live thread waits
inline void __syncthreads() {
  emu.at_barrier[emu.current] = 1;
  do emu_switch();
  while (emu.at_barrier[emu.current]);
}
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
template <typename V>
inline V __shfl_sync(unsigned, V v, int src) {
  static_assert(sizeof(V) == 4, "32-bit values only");
  const int t = emu.current;
  memcpy(&emu.slots[t], &v, 4);
  emu_switch();
  const uint32_t got = emu.slots[(t & ~31) + (src & 31)];
  emu_switch();
  V out;
  memcpy(&out, &got, 4);
  return out;
}
template <typename V>
inline V __shfl_up_sync(unsigned, V v, unsigned delta) {
  static_assert(sizeof(V) == 4, "32-bit values only");
  const int t = emu.current;
  memcpy(&emu.slots[t], &v, 4);
  emu_switch();
  const uint32_t got = emu.slots[(t & 31) >= static_cast<int>(delta) ? t - delta : t];
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
template <typename V>
inline V atomicMin(V* p, V v) {
  const V old = *p;
  if (v < old) *p = v;
  return old;
}

// one fiber runs at a time and memory is the host's: a fence orders
// nothing that is not already in order, and a load past L1 is a load
inline void __threadfence() {}
template <typename V>
inline V __ldcg(const V* p) {
  return *p;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}

// ---- cp.async (the functions of csrc/cpasync.cuh): a copy waits in its
// thread's open group; a commit closes the group; wait<N> lands every
// committed group but the newest N, in order.
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  emu.open[emu.current].push_back({dst, src, src_bytes});
}
inline void cp_async_commit() {
  const int t = emu.current;
  emu.committed[t].push_back(std::move(emu.open[t]));
  emu.open[t].clear();
}
template <int N>
inline void cp_async_wait() {
  auto& groups = emu.committed[emu.current];
  while (static_cast<int>(groups.size()) > N) {
    for (const Emu::Copy& c : groups.front()) {
      memcpy(c.dst, c.src, c.bytes);
      memset(static_cast<char*>(c.dst) + c.bytes, 0, 16 - c.bytes);
    }
    groups.pop_front();
  }
}

// ---- warp-level matrix instructions, the two functions of csrc/mma.cuh,
// written from the PTX ISA's tables (not from any kernel). A lane's
// 32-bit register holds two b16 values, the lower-indexed one in its low
// half. lane = 4 g + t.

inline uint16_t emu_b16(uint32_t word, int half) {
  return static_cast<uint16_t>(half ? word >> 16 : word & 0xffffu);
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16: lanes 8i..8i+7 give the
// addresses of rows 0..7 of matrix i; each lane then receives, in
// register i, row g of matrix i, elements 2t and 2t+1.
inline void ldmatrix_x4(uint32_t r[4], const void* row) {
  const int self = emu.current;
  const int first = self & ~31;
  const int g = (self & 31) >> 2, t = self & 3;
  emu.rows[self] = row;
  emu_switch();
  for (int i = 0; i < 4; ++i) {
    const unsigned char* src = static_cast<const unsigned char*>(emu.rows[first + 8 * i + g]);
    memcpy(&r[i], src + 4 * t, 4);
  }
  emu_switch();
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d = a * b + c:
//   A element i (i = 0..7, register i/2, half i%2) sits at
//     row g for i in {0, 1, 4, 5}, else g + 8; column 2t + (i & 1) + (i >= 4 ? 8 : 0);
//   B element i (i = 0..3, register i/2, half i%2) sits at
//     row (k) 2t + (i & 1) + (i >= 2 ? 8 : 0), column (n) g;
//   C / D element i (i = 0..3) sits at row g + (i >= 2 ? 8 : 0),
//     column 2t + (i & 1).
// The products of bf16 values are exact; each output is summed in double
// and rounded to f32 once (the card's adder tree may round differently,
// which integer-valued test data cannot show).
inline void mma_bf16_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  const int self = emu.current;
  const int first = self & ~31;
  uint32_t* mine = &emu.frags[static_cast<size_t>(self) * kFragWords];
  memcpy(mine, a, 16);
  memcpy(mine + 4, b, 8);
  emu_switch();
  float A[16][16], B[16][8];
  for (int lane = 0; lane < 32; ++lane) {
    const uint32_t* f = &emu.frags[static_cast<size_t>(first + lane) * kFragWords];
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < 8; ++i) {
      const int row = (i < 2 || (i >= 4 && i < 6)) ? g : g + 8;
      const int col = 2 * t + (i & 1) + (i >= 4 ? 8 : 0);
      A[row][col] = __bfloat162float({emu_b16(f[i / 2], i & 1)});
    }
    for (int i = 0; i < 4; ++i) {
      const int k = 2 * t + (i & 1) + (i >= 2 ? 8 : 0);
      B[k][g] = __bfloat162float({emu_b16(f[4 + i / 2], i & 1)});
    }
  }
  const int g = (self & 31) >> 2, t = self & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = 2 * t + (i & 1);
    double s = c[i];
    for (int k = 0; k < 16; ++k) s += static_cast<double>(A[row][k]) * B[k][col];
    c[i] = static_cast<float>(s);
  }
  emu_switch();
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
  emu.frags.assign((block + 32) * kFragWords, 0);
  emu.rows.assign(block + 32, nullptr);
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
    emu.at_barrier.assign(block, 0);
    emu.open.assign(block, {});
    emu.committed.assign(block, {});
    for (int t = 0; t < block; ++t) {
      getcontext(&emu.fibers[t]);
      emu.fibers[t].uc_stack.ss_sp = emu.stacks[t];
      emu.fibers[t].uc_stack.ss_size = stack_bytes;
      emu.fibers[t].uc_link = &emu.scheduler;
      makecontext(&emu.fibers[t], emu_fiber_main, 0);
    }
    for (;;) {
      int waiting = 0, ended = 0, barred = 0;
      for (int t = 0; t < block; ++t) {
        if (emu.ended[t]) continue;
        emu.current = t;
        threadIdx.x = t;
        swapcontext(&emu.scheduler, &emu.fibers[t]);
        if (emu.ended[t]) {
          ++ended;
        } else {
          ++waiting;
          barred += emu.at_barrier[t];
        }
      }
      if (waiting && ended) {
        fprintf(stderr, "emulation: %d threads wait at a barrier that %d "
                        "threads never reach\n", waiting, ended);
        ++emu_divergences;
        break;
      }
      if (!waiting) break;
      if (barred == waiting) emu.at_barrier.assign(block, 0);
    }
  }
  free(emu.smem);
  emu.smem = nullptr;
}
