// select_k: the k smallest values of each row of an f32 [R, C] matrix, with
// their positions, in one launch for the whole matrix.
//
// Replaces the XLA selection that follows kernels K2, K3 and K4 in the JAX
// package: vss_tpu/ops/topk.py:_iter_min_k (:38, k passes of argmin and
// mask) and `lax.top_k` above k = 32, which vss_tpu/ops/scan.py:125
// (`_select_min_k`) chooses between. The port's plain versions are
// vss_tpu_torch/ops/topk.py:_iter_min_k and _sort_min_k; this kernel gives
// their outputs bit for bit and position for position:
//   * k <= 32 (`iter_order`, _iter_min_k's order): every NaN first, in
//     position order; then every value below +inf ascending, -inf least,
//     -0 equal to +0, ties to the lower position; once those are used up,
//     each remaining slot is (+inf, position 0), which is what argmin
//     returns on a row of +inf;
//   * k > 32 (_sort_min_k, torch.sort(stable=True)): values ascending,
//     -0 equal to +0, ties by position, +inf entries by position, NaN last.
// Both come from one order: each value gets an order-preserving 32-bit key
// (sign flipped; -0 given +0's key; NaN the least key or the greatest, by
// mode), and the position breaks ties, so the 64-bit composite
// key << 32 | position is unique and the selection is stable for free. A
// value returned is the stored one (so -0 stays -0, a NaN keeps its
// bits), or +inf where the options below make it +inf.
//
// Two options serve the exact oracle's chunked path
// (ops/topk.py:_bruteforce_chunked), so that it reads K4's distance block
// once: a bool column mask `valid` [C] (false reads as +inf) and
// `nan_inf` (NaN reads as +inf).
//
// Bound on the H100: each value is read once, 4 bytes at 3.35 TB/s: at the
// oracle's chunk, [512, 524,288], 1.07 GB or 0.32 ms; at the pivot
// seeding, [512, 65,536], 0.040 ms; at the scan's first selection,
// [512, 7,813], 0.0048 ms, where a launch takes longer than the bytes.
// Design:
//   * one block of 256 threads a row reads the row once, 1,024 values a
//     tile: 16-byte loads of 4 consecutive values where the row allows
//     (C a multiple of 4), else coalesced 4-byte loads; the next tile's
//     loads are issued before a tile is filtered. Where rows are too few
//     to give each SM a few blocks, the wrapper splits each row over
//     several blocks (`splits`);
//   * a block keeps a buffer of candidate composites in shared memory and
//     a threshold T: a value enters only if its composite is below T, and
//     one float compare against T's value rejects most values before
//     their composite is made. When the buffer could overflow at the next
//     tile (or first holds k entries), it is sorted by a bitonic network
//     and cut to its k least, and T becomes the k-th. The first tile is
//     256 values (512 above k = 128), so the first sort is short; on rows
//     in no particular order few values pass once T is set (about
//     k ln(row / 256) in all). The network's stages of stride 32 or less
//     stay inside a warp and end in a warp's barrier;
//   * a tile's entries get their slots from a ballot per warp and one
//     prefix over the warps' counts in shared memory, so no atomic on a
//     shared counter serialises a tile in which every value passes;
//   * with splits > 1 each block writes its k least to a workspace, and
//     the block that finishes a row last (an atomic count per row, zeroed
//     by the entry point before the launch) merges the row's splits * k
//     partial entries by the same filter and writes the row. No second
//     launch and no host sync;
//   * every barrier, ballot and branch around them depends only on values
//     every thread of the block holds alike, so control flow around them
//     is uniform (tests/cuda_emulation.h runs nothing else).
// Measured on the H100 (`chip_smoke.py`, PERF.md): the wide rows run at
// about a third of the memory rate; more blocks a row do not help and
// fewer instructions a value helped little, so the wait around each
// tile's barrier is the likely limit (not profiled). The exact oracle's
// chunked path no longer comes here on the card: pairtopk.cu runs the same
// selection inside K4's tile loop, with this file's key, composite and
// cut, which selectk.cuh holds for both.
#include "selectk.cuh"

namespace vss {

struct SelectKArgs {
  const float* d;        // [R, C]
  const uint8_t* valid;  // [C] bool, or null
  float* vals;           // [R, k]
  int32_t* pos;          // [R, k]
  u64* part;             // [R, splits, k]: each segment's k least
  int* done;             // [R]: blocks of the row finished (zero at launch)
  int64_t C;
  int k, splits;
  bool iter_order;  // k <= 32's order: NaN first, +inf slots at position 0
  bool nan_inf;     // NaN reads as +inf
};

// The values of the row. `load` reads this thread's values of the tile at
// b0 (and their mask bytes): value v at `pos(b0, v)`, 4 consecutive
// values in one 16-byte load where rows are 16-byte aligned (`vec`: C a
// multiple of 4, every tile's bounds too), else every 256th. `maybe` says
// whether a value could be below the threshold whose float is `tf` (a
// value above it never is, and one compare rejects most values once the
// threshold is set); `key` makes the composite, key << 32 | position,
// which decides.
struct RowSource {
  struct Raw {
    float v;
    bool ok;
  };
  const float* row;
  const uint8_t* valid;
  bool iter_order, nan_inf, vec;
  __device__ __forceinline__ int64_t pos(int64_t b0, int v) const {
    return vec ? b0 + 4 * threadIdx.x + v : b0 + v * kSkThreads + threadIdx.x;
  }
  __device__ __forceinline__ void load(int64_t b0, int64_t b1,
                                       Raw (&raw)[kSkPer]) const {
    if (vec) {
      const int64_t p = pos(b0, 0);
      if (p < b1) {
        const float4 f = *reinterpret_cast<const float4*>(row + p);
        const unsigned m =
            valid == nullptr ? 0x01010101u : *reinterpret_cast<const unsigned*>(valid + p);
        raw[0] = Raw{f.x, (m & 0xffu) != 0};
        raw[1] = Raw{f.y, (m & 0xff00u) != 0};
        raw[2] = Raw{f.z, (m & 0xff0000u) != 0};
        raw[3] = Raw{f.w, (m & 0xff000000u) != 0};
      }
      return;
    }
#pragma unroll
    for (int v = 0; v < kSkPer; ++v) {
      const int64_t p = pos(b0, v);
      if (p < b1) raw[v] = Raw{row[p], valid == nullptr || valid[p] != 0};
    }
  }
  __device__ __forceinline__ bool maybe(Raw r, float tf) const {
    const float e = !r.ok || (nan_inf && isnan(r.v)) ? CUDART_INF_F : r.v;
    return !(e > tf);
  }
  __device__ __forceinline__ u64 key(Raw r, int64_t p) const {
    const bool inf = !r.ok || (nan_inf && isnan(r.v));
    const unsigned key = inf ? kKeyInf : order_key(r.v, iter_order);
    return (static_cast<u64>(key) << 32) | static_cast<unsigned>(p);
  }
};

// Row r's outputs from the sorted buffer (which holds k entries).
__device__ __forceinline__ void write_row(const SelectKArgs& a,
                                          const SelectKSmem& s, int64_t r) {
  for (int i = threadIdx.x; i < a.k; i += kSkThreads) {
    const u64 c = s.buf[i];
    const unsigned key = static_cast<unsigned>(c >> 32);
    int p = static_cast<int>(c & 0xffffffffull);
    float v;
    if (key == kKeyInf) {
      v = CUDART_INF_F;
      if (a.iter_order) p = 0;
    } else {
      v = a.d[r * a.C + p];
    }
    a.vals[r * a.k + i] = v;
    a.pos[r * a.k + i] = p;
  }
}

__global__ void __launch_bounds__(kSkThreads)
    select_k_kernel(SelectKArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SelectKSmem& s = *reinterpret_cast<SelectKSmem*>(smem);
  const int64_t r = blockIdx.x / a.splits;
  const int split = blockIdx.x % a.splits;
  // segments of a multiple of 4 values, so that 16-byte loads stay inside
  const int64_t seg = ((a.C + a.splits - 1) / a.splits + 3) / 4 * 4;
  const int64_t c0 = split * seg;
  const int64_t c1 = c0 + seg < a.C ? c0 + seg : a.C;
  int n = 0;
  u64 T = kNone;
  const RowSource row{a.d + r * a.C, a.valid, a.iter_order, a.nan_inf, a.C % 4 == 0};
  // the first cut sorts 256 values (512 above k = 128): enough that the
  // k-th of them lets few of the next tiles' values in
  const int first = a.k > 128 ? 2 * kSkThreads : kSkThreads;
  filter(s, row, c0, c1, first, a.k, n, T);
  if (a.splits > 1 &&
      !merge_splits(s, a.part + r * a.splits * a.k, a.done + r, split, a.splits, a.k, n, T))
    return;
  write_row(a, s, r);
}

}  // namespace vss

// The k smallest of each row of d [R, C] (f32, contiguous): vals [R, k]
// f32 and pos [R, k] int32, in _iter_min_k's order (iter_order = 1) or
// torch.sort(stable=True)'s (0). `valid` [C] bool or null: false reads as
// +inf; nan_inf: NaN reads as +inf. With splits > 1 each row is cut into
// that many segments, one block each, and `ws` holds R * splits * k
// 8-byte entries followed by R ints. A shape the kernel does not take
// (k outside 1 .. min(C, 256), C above 2^31 - 1, splits outside
// 1 .. C, splits > 1 without a workspace) is refused before anything is
// launched; R = 0 launches nothing.
extern "C" int vss_select_k(const float* d, const uint8_t* valid, float* vals,
                            int32_t* pos, void* ws, int R, int64_t C, int k,
                            int splits, int iter_order, int nan_inf,
                            void* stream) {
  using namespace vss;
  if (R < 0 || C < 1 || C > 0x7fffffffLL || k < 1 || k > kSkMaxK || k > C ||
      splits < 1 || splits > C || (splits > 1 && ws == nullptr) ||
      static_cast<int64_t>(R) * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SelectKArgs a;
  a.d = d, a.valid = valid, a.vals = vals, a.pos = pos;
  a.part = static_cast<u64*>(ws);
  a.done = splits > 1 ? reinterpret_cast<int*>(a.part + static_cast<int64_t>(R) * splits * k)
                      : nullptr;
  a.C = C, a.k = k, a.splits = splits;
  a.iter_order = iter_order != 0, a.nan_inf = nan_inf != 0;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(a.done, 0, sizeof(int) * static_cast<size_t>(R), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // as many blocks on an SM as its shared memory holds
  cudaError_t err = cudaFuncSetAttribute(
      select_k_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_k_kernel<<<R * splits, kSkThreads, sizeof(SelectKSmem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
