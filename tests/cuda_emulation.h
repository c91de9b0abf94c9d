// A stand-in for the CUDA toolkit's headers that lets g++ compile the
// port's kernels (`vss_tpu_torch/csrc/*.cu`) and run them on the CPU, so
// that a kernel's control flow and index arithmetic can be tested where
// there is no nvcc and no card (`tests/test_torch_*_emulated.py`, built by
// `tests/emulation.py`).
//
// A block's threads are cooperative fibers (ucontext) run in turn by
// `emu_launch`; a fiber runs until it reaches a barrier, then the next one
// does. Every barrier, shuffle, ballot, warp reduction and `wgmma` wait
// (the stand-ins for csrc/wgmma.cuh) is a switch point, so the emulation
// is only valid for kernels in which all threads of a warp (of a
// warpgroup, around `wgmma`) reach the same sequence of such calls
// (uniform control flow around them). `__syncthreads` waits for every
// thread of the block: warps may pass different numbers of warp-level
// switch points between two block barriers (a warp that sorts alone,
// say). A thread that waits on an mbarrier or a warpgroup's named barrier
// spins, switching, until it completes. Warps may end while others go on
// (a producer warp that ends first); the launcher counts a divergence
// (`emu_divergences`) and gives the block up when threads end while a
// thread of their warp, or a thread at `__syncthreads`, waits. Blocks run
// one after another. `cp.async` copies (the stand-ins for
// csrc/cpasync.cuh) land only when their group is awaited, bulk copies
// only when a thread waits on their mbarrier, and `wgmma` products only at
// the `wgmma_wait` that covers them, so a read of a stage or of an
// accumulator that was not awaited sees the old bytes. It shows what a
// kernel computes, never how fast, and it cannot show a missing barrier:
// between two switch points a fiber runs alone.
#pragma once
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <set>
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
struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
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

// byte i of the result: byte (nibble i of sel) of the 8 bytes b:a
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned sel) {
  const uint64_t v = (static_cast<uint64_t>(b) << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>((v >> (8 * ((sel >> (4 * i)) & 7))) & 0xffu) << (8 * i);
  return r;
}

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaSharedmemCarveoutMaxShared = 100,
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
// the emulated card: 4 SMs (so that a persistent grid's blocks each take
// several tiles at test sizes) and the H100's shared memory a block
constexpr int kEmuSms = 4;
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? kEmuSms : 232448;
  return cudaSuccess;
}
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
  std::vector<char> at_barrier;   // waits at __syncthreads
  // each thread's cp.async copies: the open group, then the committed ones
  struct Copy {
    void* dst;
    const void* src;
    int bytes;
  };
  std::vector<std::vector<Copy>> open;
  std::vector<std::deque<std::vector<Copy>>> committed;
  // each thread's wgmma products: the open group, then the committed ones
  struct Product {
    float* d;
    uint32_t a[4];
    uint64_t desc;
    int scale_d;
  };
  std::vector<std::vector<Product>> wg_open;
  std::vector<std::deque<std::vector<Product>>> wg_committed;
  // mbarriers by address: arrivals a phase, arrivals pending, bytes
  // announced and not landed, phases completed, bulk copies not landed
  struct Barrier {
    int count = 0, pending = 0;
    int64_t tx = 0;
    int64_t phases = 0;
    int64_t completed_round = -1;  // the launcher's round of the last completion
    std::vector<Copy> copies;        // bulk copies, counted in tx
    std::vector<Copy> async_copies;  // cp.async copies reported by an arrival
    std::map<int, int> last_parity;  // each thread's last wait
    std::set<int> waiting;           // the threads in mbar_wait now
  };
  std::map<const void*, Barrier> bars;
  // named barriers (bar.sync id, 128): arrivals, completions
  int named_count[16] = {};
  int64_t named_gen[16] = {};
  int64_t spins = 0;  // switches of threads waiting on a barrier, this block
  int64_t round = 0;  // the launcher's rounds, this block
};
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

// ---- the warp vote, shared addresses and barrier waits of K2

inline int __all_sync(unsigned m, bool pred) { return __ballot_sync(m, !pred) == 0; }

// a shared address is the offset into the block's dynamic shared memory
inline unsigned __cvta_generic_to_shared(const void* p) {
  return static_cast<unsigned>(static_cast<const unsigned char*>(p) - emu.smem);
}

// a thread waiting on a barrier switches; the launcher gives up a block
// whose waiting threads switch kSpinLimit times (a barrier that never
// completes) and the blocks after it
constexpr int64_t kSpinLimit = 20000000;
inline void emu_spin() {
  ++emu.spins;
  emu_switch();
}

// ---- mbarriers and bulk copies (the functions of csrc/cpasync.cuh): a
// phase completes once its arrivals are in and the bytes announced for it
// have landed; a bulk copy lands when every live thread of a warp waits on
// its barrier (so that a warp that reads a stage before its wait reads it
// stale, whichever lane comes first).

inline unsigned smem_addr(const void* p) { return __cvta_generic_to_shared(p); }

inline Emu::Barrier& emu_bar(const void* bar) {
  auto it = emu.bars.find(bar);
  if (it == emu.bars.end()) {
    fprintf(stderr, "emulation: an mbarrier used before its init\n");
    abort();
  }
  return it->second;
}

inline void emu_bar_complete(Emu::Barrier& b, bool land) {
  if (b.pending > 0) return;
  if (land) {
    for (const Emu::Copy& c : b.copies) {
      memcpy(c.dst, c.src, c.bytes);
      b.tx -= c.bytes;
    }
    b.copies.clear();
    for (const Emu::Copy& c : b.async_copies) {
      memcpy(c.dst, c.src, c.bytes);
      memset(static_cast<char*>(c.dst) + c.bytes, 0, 16 - c.bytes);
    }
    b.async_copies.clear();
  }
  if (b.tx == 0 && b.copies.empty() && b.async_copies.empty()) {
    ++b.phases;
    b.pending = b.count;
    b.completed_round = emu.round;
  }
}

inline void mbar_init(uint64_t* bar, int count) {
  Emu::Barrier b;
  b.count = b.pending = count;
  emu.bars[bar] = b;
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  Emu::Barrier& b = emu_bar(bar);
  --b.pending;
  emu_bar_complete(b, false);
}
inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  Emu::Barrier& b = emu_bar(bar);
  b.tx += bytes;
  --b.pending;
  emu_bar_complete(b, false);
}
// the phase of parity `parity` has completed once the phases completed
// so far are of the other parity; its waiters leave in a round after the
// one it completed in, all lanes of a warp together. A thread's successive waits on one
// barrier must alternate parity: the wait tells a phase only by its
// parity, so one that repeats its last is for a phase two ahead, which
// can pass at once (counted as a divergence).
inline void mbar_wait(uint64_t* bar, int parity) {
  auto last = emu_bar(bar).last_parity.find(emu.current);
  if (last != emu_bar(bar).last_parity.end() && last->second == parity) {
    fprintf(stderr, "emulation: thread %d waits on an mbarrier for parity %d twice in a row\n",
            emu.current, parity);
    ++emu_divergences;
  }
  emu_bar(bar).last_parity[emu.current] = parity;
  emu_bar(bar).waiting.insert(emu.current);
  const int first = emu.current & ~31;
  for (;;) {
    Emu::Barrier& b = emu_bar(bar);
    bool warp_waits = true;
    for (int t = first; t < first + 32 && t < emu.threads; ++t)
      warp_waits = warp_waits && (emu.ended[t] || b.waiting.count(t));
    emu_bar_complete(b, warp_waits);
    if (static_cast<int>(b.phases & 1) != parity && b.completed_round < emu.round) {
      b.waiting.erase(emu.current);
      return;
    }
    emu_spin();
  }
}
// every cp.async this thread issued and has not awaited lands with the
// barrier's phase; then one arrival
inline void cp_async_arrive(uint64_t* bar) {
  Emu::Barrier& b = emu_bar(bar);
  const int t = emu.current;
  for (auto& group : emu.committed[t])
    b.async_copies.insert(b.async_copies.end(), group.begin(), group.end());
  emu.committed[t].clear();
  b.async_copies.insert(b.async_copies.end(), emu.open[t].begin(), emu.open[t].end());
  emu.open[t].clear();
  --b.pending;
  emu_bar_complete(b, false);
}
inline void bulk_copy(void* smem, const void* gmem, unsigned bytes, uint64_t* bar) {
  if (bytes % 16 || reinterpret_cast<uintptr_t>(smem) % 16 ||
      reinterpret_cast<uintptr_t>(gmem) % 16) {
    fprintf(stderr, "emulation: a bulk copy of %u bytes not 16-byte aligned\n", bytes);
    abort();
  }
  emu_bar(bar).copies.push_back({smem, gmem, static_cast<int>(bytes)});
}

// ---- wgmma (the functions of csrc/wgmma.cuh), written from the PTX
// ISA's tables (not from any kernel): wgmma.mma_async m64n64k16, bf16
// inputs, f32 accumulators, A from registers, B by descriptor. A
// warpgroup is 128 threads, the first a multiple of 128; lane = 4 g + t;
// warp w of the warpgroup holds rows 16 w .. 16 w + 15 of A and D:
//   A element i (i = 0..7, register i/2, half i%2, the lower k in the low
//     half) sits at row 16 w + g + 8 ((i / 2) & 1), column (k)
//     2 t + (i & 1) + 8 (i / 4);
//   D element 4 j + i sits at row 16 w + g + 8 (i / 2), column (n)
//     8 j + 2 t + (i & 1);
//   B element (n, k), k = 0..15, n = 0..63, at the shared address
//     `emu_b_addr` gives.
// The products of bf16 values are exact; each output is summed in double
// and rounded to f32 once (the card's adder tree may round differently,
// which integer-valued test data cannot show). A product is computed only
// at the `wgmma_wait` that covers its group, with the accumulator's value
// at that time, as the card leaves it undefined before.

inline uint16_t emu_b16(uint32_t word, int half) {
  return static_cast<uint16_t>(half ? word >> 16 : word & 0xffffu);
}

// The matrix descriptor (PTX ISA, "Matrix Descriptor Format"): start
// address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride
// byte offset >> 4 in 32-45, base offset in 49-51, swizzle mode in 62-63.
// B is K-major (each n's k values consecutive) in the canonical layouts:
// no swizzle (mode 0), core matrices of 8 rows (n) x 16 bytes (8 k), the
// two along k LBO apart, consecutive 8-n groups SBO apart; 128-byte
// swizzle (mode 1), rows of 128 bytes, 8-n groups SBO apart, LBO unused,
// the 16-byte chunk (address bits 4-6) XORed with the row within the
// 1024-byte atom (bits 7-9).
inline unsigned emu_b_addr(uint64_t desc, int n, int k) {
  const unsigned start = static_cast<unsigned>(desc & 0x3FFF) << 4;
  const unsigned lbo = static_cast<unsigned>((desc >> 16) & 0x3FFF) << 4;
  const unsigned sbo = static_cast<unsigned>((desc >> 32) & 0x3FFF) << 4;
  const unsigned base_offset = static_cast<unsigned>((desc >> 49) & 7);
  const unsigned mode = static_cast<unsigned>(desc >> 62);
  if (base_offset == 0 && mode == 0)
    return start + (n / 8) * sbo + (k / 8) * lbo + (n % 8) * 16 + (k % 8) * 2;
  if (base_offset == 0 && mode == 1) {
    const unsigned a = start + (n / 8) * sbo + (n % 8) * 128 + k * 2;
    return a ^ (((a >> 7) & 7) << 4);
  }
  fprintf(stderr, "emulation: descriptor mode %u, base offset %u not emulated\n", mode,
          base_offset);
  abort();
}

inline void wgmma_fence() {}
inline void fence_operand(float&) {}
inline void fence_proxy_async() {}
template <int N>
inline void setmaxnreg_inc() {}
template <int N>
inline void setmaxnreg_dec() {}

inline void emu_wgmma(float d[32], const uint32_t a[4], uint64_t desc, int scale_d) {
  emu.wg_open[emu.current].push_back({d, {a[0], a[1], a[2], a[3]}, desc, scale_d});
}
inline void wgmma_m64n64k16(float d[32], const uint32_t a[4], uint64_t desc) {
  emu_wgmma(d, a, desc, 1);
}
inline void wgmma_m64n64k16_zero(float d[32], const uint32_t a[4], uint64_t desc) {
  emu_wgmma(d, a, desc, 0);
}
inline void wgmma_commit() {
  const int t = emu.current;
  emu.wg_committed[t].push_back(std::move(emu.wg_open[t]));
  emu.wg_open[t].clear();
}
template <int N>
inline void wgmma_wait() {
  const int self = emu.current, first = self & ~127;
  const int w = (self & 127) >> 5, g = (self & 31) >> 2, t = self & 3;
  emu_switch();  // every thread of the warpgroup has issued its products
  auto& mine = emu.wg_committed[self];
  const int land = static_cast<int>(mine.size()) - N;
  for (int gi = 0; gi < land; ++gi)
    for (size_t oi = 0; oi < mine[gi].size(); ++oi) {
      const Emu::Product& op = mine[gi][oi];
      float A[2][16];  // rows g and g + 8 of this warp
      for (int tt = 0; tt < 4; ++tt) {
        const auto& theirs = emu.wg_committed[first + 32 * w + 4 * g + tt];
        if (static_cast<int>(theirs.size()) <= gi || theirs[gi].size() != mine[gi].size()) {
          fprintf(stderr, "emulation: a warpgroup's threads issued other products\n");
          abort();
        }
        const Emu::Product& src = theirs[gi][oi];
        for (int i = 0; i < 8; ++i)
          A[(i / 2) & 1][2 * tt + (i & 1) + 8 * (i / 4)] =
              __bfloat162float({emu_b16(src.a[i / 2], i & 1)});
      }
      for (int j = 0; j < 8; ++j)
        for (int i = 0; i < 4; ++i) {
          const int n = 8 * j + 2 * t + (i & 1);
          double s = op.scale_d ? op.d[4 * j + i] : 0.0;
          for (int k = 0; k < 16; ++k) {
            uint16_t bits;
            memcpy(&bits, emu.smem + emu_b_addr(op.desc, n, k), 2);
            s += static_cast<double>(A[i / 2][k]) * __bfloat162float({bits});
          }
          op.d[4 * j + i] = static_cast<float>(s);
        }
    }
  emu_switch();  // every thread of the warpgroup has read the others' A
  for (int gi = 0; gi < land; ++gi) mine.pop_front();
}

// bar.sync id, 128: the 128 threads of one warpgroup
inline void warpgroup_sync(int id) {
  const int64_t gen = emu.named_gen[id];
  if (++emu.named_count[id] == 128) {
    emu.named_count[id] = 0;
    ++emu.named_gen[id];
  }
  do emu_spin();
  while (emu.named_gen[id] == gen);
}

// min.NaN.f32
inline float min_nan(float a, float b) {
  if (isnan(a) || isnan(b)) return __builtin_nanf("");
  return a < b ? a : b;
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
    emu.at_barrier.assign(block, 0);
    emu.open.assign(block, {});
    emu.committed.assign(block, {});
    emu.wg_open.assign(block, {});
    emu.wg_committed.assign(block, {});
    emu.bars.clear();
    for (int i = 0; i < 16; ++i) emu.named_count[i] = 0;
    emu.spins = 0;
    std::vector<char> warp_ended((block + 31) / 32, 0);
    for (int t = 0; t < block; ++t) {
      getcontext(&emu.fibers[t]);
      emu.fibers[t].uc_stack.ss_sp = emu.stacks[t];
      emu.fibers[t].uc_stack.ss_size = stack_bytes;
      emu.fibers[t].uc_link = &emu.scheduler;
      makecontext(&emu.fibers[t], emu_fiber_main, 0);
    }
    for (;;) {
      ++emu.round;
      int waiting = 0, ended = 0, barred = 0;
      for (int t = 0; t < block; ++t) {
        if (emu.ended[t]) continue;
        emu.current = t;
        threadIdx.x = t;
        swapcontext(&emu.scheduler, &emu.fibers[t]);
        if (emu.ended[t]) {
          ++ended;
          warp_ended[t / 32] = 1;
        } else {
          ++waiting;
          barred += emu.at_barrier[t];
        }
      }
      bool diverged = waiting && ended && barred;
      for (int t = 0; t < block && waiting && ended; ++t)
        diverged = diverged || (!emu.ended[t] && warp_ended[t / 32]);
      if (diverged) {
        fprintf(stderr, "emulation: %d threads wait at a barrier or warp exchange "
                        "that %d threads never reach\n", waiting, ended);
        ++emu_divergences;
        break;
      }
      if (!waiting) break;
      if (barred == waiting) emu.at_barrier.assign(block, 0);
      if (emu.spins > kSpinLimit) {
        fprintf(stderr, "emulation: block %d waits on a barrier that never completes\n", b);
        ++emu_divergences;
        b = grid;
        break;
      }
    }
  }
  free(emu.smem);
  emu.smem = nullptr;
}
