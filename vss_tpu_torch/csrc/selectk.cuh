// The stable k-smallest selection's shared pieces (sm_90a), included by
// `selectk.cu` (the select_k kernel) and `pairtopk.cu` (the pairwise_topk
// kernel): the order-preserving 32-bit key of an f32 value, the 64-bit
// composite key << 32 | position (or row), which is unique, so that the k
// least composites are one set however the values are split among blocks,
// the block-wide buffer that a filter fills and a bitonic network cuts to
// its k least, and the merge of a row split over several blocks. Included
// also by `seeds.cu` (the pivot_seeds kernel). See selectk.cu for the
// order and the design.
#pragma once

#include "common.cuh"

namespace vss {

typedef unsigned long long u64;

constexpr int kSkThreads = 256;  // a block's threads
constexpr int kSkWarps = kSkThreads / 32;
constexpr int kSkPer = 4;  // values a thread reads per tile
constexpr int kSkTile = kSkThreads * kSkPer;
constexpr int kSkBuf = 2048;  // candidates a block holds
constexpr int kSkMaxK = 256;  // the widest k; kSkBuf >= kSkMaxK + kSkTile
constexpr u64 kNone = ~0ull;  // an empty slot: after every composite
constexpr unsigned kKeyInf = 0xff800000u;  // the key of +inf

struct SelectKSmem {
  u64 buf[kSkBuf];
  int counts[2][kSkWarps];  // a tile's takes per warp, by tile parity
  int last;                 // this block finished its row last
};

// The order of f32 values as an unsigned key: -0 as +0, NaN least
// (`nan_first`) or greatest.
__device__ __forceinline__ unsigned order_key(float v, bool nan_first) {
  if (isnan(v)) return nan_first ? 0u : 0xffffffffu;
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The least float whose key is `key` (NaN where no float compares: the
// NaN keys, and a threshold not yet set).
__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? key & 0x7fffffffu : ~key);
}

// Sort buf[0, n2) ascending (n2 a power of two) by a bitonic network. A
// stage of stride 32 or less pairs only entries that one warp holds
// (thread t takes pairs t, t + 256, ...: warp w the entries 64 w .. 64 w +
// 63 of each 512), so between two such stages a warp's barrier is enough;
// a stage of a wider stride, and the stage before one, end in the
// block's, and so does the sort.
__device__ __forceinline__ void bitonic_sort(u64* buf, int n2) {
  const int tid = threadIdx.x;
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2 / 2; i += kSkThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = buf[lo], b = buf[hi];
        if ((a > b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      // the next stage's stride: stride / 2, or the next size's first, size
      const int next = stride > 1 ? stride >> 1 : size;
      if (stride > 32 || next > 32)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  __syncthreads();
}

// Sort the n entries of the buffer and keep its k least: n becomes
// min(n, k), and T the k-th least once there are k. n and T are alike in
// every thread.
__device__ __forceinline__ void reduce_buffer(SelectKSmem& s, int& n, u64& T,
                                              int k) {
  __syncthreads();  // the last tile's entries are in
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + static_cast<int>(threadIdx.x); i < n2; i += kSkThreads)
    s.buf[i] = kNone;
  __syncthreads();
  bitonic_sort(s.buf, n2);
  if (n > k) n = k;
  if (n == k) T = s.buf[k - 1];
}

// Filter the composites of positions [c0, c1) into the buffer (which holds
// n entries below T), and end with the buffer sorted and cut to its k
// least. The first tile takes only `first` values, so that the first cut,
// which sorts every value read so far, sorts few; each tile's loads are
// issued before the tile before it is filtered.
template <typename Src>
__device__ __forceinline__ void filter(SelectKSmem& s, const Src& src,
                                       int64_t c0, int64_t c1, int first,
                                       int k, int& n, u64& T) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  int parity = 0;
  int64_t t0 = c0, t1 = c0 + first < c1 ? c0 + first : c1;
  typename Src::Raw raw[kSkPer];
  src.load(t0, t1, raw);
  while (t0 < c1) {
    const float tf = key_float(static_cast<unsigned>(T >> 32));
    u64 c[kSkPer];
#pragma unroll
    for (int v = 0; v < kSkPer; ++v) {
      const int64_t p = src.pos(t0, v);
      c[v] = p < t1 && src.maybe(raw[v], tf) ? src.key(raw[v], p) : kNone;
    }
    const int64_t u0 = t1, u1 = t1 + kSkTile < c1 ? t1 + kSkTile : c1;
    src.load(u0, u1, raw);
    if (n > kSkBuf - kSkTile || (T == kNone && n >= k)) reduce_buffer(s, n, T, k);
    unsigned take[kSkPer];
    int mine = 0;
#pragma unroll
    for (int v = 0; v < kSkPer; ++v) {
      take[v] = __ballot_sync(0xffffffffu, c[v] < T);
      mine += __popc(take[v]);
    }
    if (lane == 0) s.counts[parity][warp] = mine;
    __syncthreads();
    int base = n, total = 0;
#pragma unroll
    for (int w = 0; w < kSkWarps; ++w) {
      const int cw = s.counts[parity][w];
      base += w < warp ? cw : 0;
      total += cw;
    }
#pragma unroll
    for (int v = 0; v < kSkPer; ++v) {
      if ((take[v] >> lane) & 1u) s.buf[base + __popc(take[v] & below)] = c[v];
      base += __popc(take[v]);
    }
    n += total;
    parity ^= 1;
    t0 = u0;
    t1 = u1;
  }
  reduce_buffer(s, n, T, k);
}

// A row's partial lists in the workspace, written by its blocks.
struct PartSource {
  typedef u64 Raw;
  const u64* part;
  __device__ __forceinline__ int64_t pos(int64_t b0, int v) const {
    return b0 + v * kSkThreads + threadIdx.x;
  }
  __device__ __forceinline__ void load(int64_t b0, int64_t b1, u64 (&raw)[kSkPer]) const {
#pragma unroll
    for (int v = 0; v < kSkPer; ++v) {
      const int64_t p = pos(b0, v);
      if (p < b1) raw[v] = __ldcg(part + p);
    }
  }
  __device__ __forceinline__ bool maybe(u64, float) const { return true; }
  __device__ __forceinline__ u64 key(u64 r, int64_t) const { return r; }
};

// A row split over `splits` blocks: this block (segment `split`) writes
// its k least, the buffer's n entries then kNone, to its slot of the
// row's workspace `part` [splits, k], and counts itself done in `done`
// (zero at launch). The block that finishes the row last merges the
// splits * k entries by the same filter and returns true with the row's
// k least sorted in the buffer; every other block returns false. No
// second launch and no host sync.
__device__ __forceinline__ bool merge_splits(SelectKSmem& s, u64* part, int* done,
                                             int split, int splits, int k, int& n,
                                             u64& T) {
  u64* mine = part + static_cast<int64_t>(split) * k;
  for (int i = threadIdx.x; i < k; i += kSkThreads) mine[i] = i < n ? s.buf[i] : kNone;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s.last = atomicAdd(done, 1) == splits - 1;
  __syncthreads();
  if (!s.last) return false;
  __threadfence();
  n = 0;
  T = kNone;
  const PartSource parts{part};
  filter(s, parts, 0, static_cast<int64_t>(splits) * k, kSkTile, k, n, T);
  return true;
}

}  // namespace vss
