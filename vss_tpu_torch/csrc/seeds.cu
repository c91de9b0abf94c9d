// pivot_seeds: the pivot seeding of the graph search after its product,
// in one launch: each query's n_seeds nearest pivots, mapped to their
// slots and scored against the query as the beam scores every node.
//
// Replaces vss_tpu/ops/gather.py:142 `_gather_dist_kernel` (K1) where it
// rescored the seeds on its own (vss_tpu/index/search.py:520-526),
// together with the XLA step of vss_tpu/index/search.py:451-493
// (`pivot_seeds`: the metric epilogue over the [B, P] product, the
// padding mask, `lax.top_k`, the slot map). The product itself,
// `q @ pivots^T`, stays a matrix product (`torch.matmul`; XLA's
// `dot_general` in the JAX package). The port's route before this kernel
// was the epilogue, the mask and the slot map as PyTorch ops around one
// select_k launch (selectk.cu), then K1 (gather.cu); this kernel gives
// that route's seeds and distances bit for bit:
//   * each value is common.cuh's `epilogue` of its dot, the query's and
//     the pivot's squared norms (the additions and products rounded one
//     by one, in PyTorch's order: qn + pn first, then minus 2 dot; the
//     clamp keeps NaN), or +inf where the pivot slot is -1;
//   * the n_seeds least in select_k's order (selectk.cuh's key and
//     composite, `iter_order` up to k = 32: NaN first; a stable sort's
//     above: NaN last; ties to the lower position, -0 equal to +0);
//   * a seed is the slot of its pivot where its value is finite, else -1;
//   * its distance is K1's: the row scored by `score_row` (gather.cuh)
//     with K1's lane grouping, the value of the group's first lane, then
//     `epilogue`; +inf for a -1 seed.
//
// Bound on the H100: the [B, P] dots are read once, 4 bytes each; the
// pivots' norms and slot signs (4 bytes each a pivot) come from L2 for
// every row after the first; the seed rows are a few KB. At the serving
// shape (512 queries x 65,536 pivot slots, k = 4) that is 134 MB, 0.040 ms
// at 3.35 TB/s; the parent's route moved about 1.6 GB in 17 launches.
// Design:
//   * select_k's tile loop (selectk.cuh `filter`) with the value source
//     replaced by the epilogue: one block of 256 threads a row, 16-byte
//     loads of 4 dots, 4 norms and 4 slots where P is a multiple of 4,
//     else coalesced 4-byte loads; the query's norm in a register; one
//     float compare against the running threshold rejects most values
//     before their composite is made;
//   * where rows are too few to give every SM a few blocks (the SQL
//     layer's single queries), each row is split over several blocks,
//     and the last block of a row to finish merges their lists
//     (selectk.cuh `merge_splits`): no second launch and no host sync;
//   * the block that holds a row's k least stages the query in shared
//     memory and scores the k seed rows with K1's loads and fused
//     multiply-adds, a group of lanes a row (8 for a 128-byte int8 row);
//   * every barrier, shuffle and ballot sits in control flow that every
//     thread of the block takes alike (tests/cuda_emulation.h runs
//     nothing else).
#include "gather.cuh"
#include "selectk.cuh"

namespace vss {

struct SeedArgs {
  const float* dots;     // [B, P] the queries' dot products with the pivots
  const float* qn;       // [B] squared query norms
  const float* pn;       // [P] squared pivot norms
  const int32_t* slots;  // [P] pivot slots, -1 for padding
  const void* table;     // [N, d] the graph's tape
  const float* q;        // [B, d]
  int32_t* seeds;        // [B, k]
  float* seed_d;         // [B, k]
  u64* part;             // [B, splits, k]: each segment's k least
  int* done;             // [B]: blocks of the row finished (zero at launch)
  int64_t P;
  int k, splits, d, group;
  bool vec;  // the tape's rows in 16-byte loads (K1's `row_grouping`)
};

// The values of row b: value v of a thread's tile at `pos(b0, v)` (as
// selectk.cu's RowSource). A value is the epilogue of metric M over its
// dot and the two norms, +inf for a padding slot; `maybe` rejects a value
// above the threshold's float `tf` by one compare, `key` makes the
// composite key << 32 | position.
template <int M>
struct PivotSource {
  struct Raw {
    float dot, pn;
    bool pad;
  };
  const float* dots;
  const float* pn;
  const int32_t* slots;
  float qn;
  bool iter_order, vec;
  __device__ __forceinline__ int64_t pos(int64_t b0, int v) const {
    return vec ? b0 + 4 * threadIdx.x + v : b0 + v * kSkThreads + threadIdx.x;
  }
  __device__ __forceinline__ void load(int64_t b0, int64_t b1,
                                       Raw (&raw)[kSkPer]) const {
    if (vec) {
      const int64_t p = pos(b0, 0);
      if (p < b1) {
        const float4 f = *reinterpret_cast<const float4*>(dots + p);
        const float4 n = *reinterpret_cast<const float4*>(pn + p);
        const uint4 s = *reinterpret_cast<const uint4*>(slots + p);
        raw[0] = Raw{f.x, n.x, static_cast<int>(s.x) < 0};
        raw[1] = Raw{f.y, n.y, static_cast<int>(s.y) < 0};
        raw[2] = Raw{f.z, n.z, static_cast<int>(s.z) < 0};
        raw[3] = Raw{f.w, n.w, static_cast<int>(s.w) < 0};
      }
      return;
    }
#pragma unroll
    for (int v = 0; v < kSkPer; ++v) {
      const int64_t p = pos(b0, v);
      if (p < b1) raw[v] = Raw{dots[p], pn[p], slots[p] < 0};
    }
  }
  __device__ __forceinline__ float value(Raw r) const {
    return r.pad ? CUDART_INF_F : epilogue(r.dot, qn, r.pn, M);
  }
  __device__ __forceinline__ bool maybe(Raw r, float tf) const {
    return !(value(r) > tf);
  }
  __device__ __forceinline__ u64 key(Raw r, int64_t p) const {
    return (static_cast<u64>(order_key(value(r), iter_order)) << 32) |
           static_cast<unsigned>(p);
  }
};

// Row b's outputs from the sorted buffer (its k least): each seed's slot,
// or -1 where its value is not finite, and its distance as K1 gives it.
// `qs` holds d floats of shared memory for the query.
template <typename T, int M>
__device__ __forceinline__ void score_seeds(const SeedArgs& a, const SelectKSmem& s,
                                            float* qs, int64_t b) {
  for (int e = threadIdx.x; e < a.d; e += kSkThreads) qs[e] = a.q[b * a.d + e];
  __syncthreads();
  const float qnb = a.qn[b];
  const T* table = static_cast<const T*>(a.table);
  const int g = threadIdx.x / a.group;
  const int gl = threadIdx.x % a.group;
  const int ngroups = kSkThreads / a.group;
  for (int base = 0; base < a.k; base += ngroups) {
    const int i = base + g;
    int seed = -1;
    if (i < a.k) {
      const u64 c = s.buf[i];
      const int p = static_cast<int>(c & 0xffffffffull);
      if (isfinite(key_float(static_cast<unsigned>(c >> 32)))) seed = a.slots[p];
    }
    float dot, xn;
    score_row<T>(seed >= 0 ? table + static_cast<int64_t>(seed) * a.d : nullptr, qs, a.d,
                 a.group, gl, a.vec, dot, xn);
    if (gl == 0 && i < a.k) {
      a.seeds[b * a.k + i] = seed;
      a.seed_d[b * a.k + i] = seed >= 0 ? epilogue(dot, qnb, xn, M) : CUDART_INF_F;
    }
  }
}

// shared memory: the selection's buffer, then the query
constexpr size_t kSeedQs = (sizeof(SelectKSmem) + 15) / 16 * 16;

template <typename T, int M>
__global__ void __launch_bounds__(kSkThreads) pivot_seeds_kernel(SeedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SelectKSmem& s = *reinterpret_cast<SelectKSmem*>(smem);
  float* qs = reinterpret_cast<float*>(smem + kSeedQs);
  const int64_t b = blockIdx.x / a.splits;
  const int split = blockIdx.x % a.splits;
  // segments of a multiple of 4 values, so that 16-byte loads stay inside
  const int64_t seg = ((a.P + a.splits - 1) / a.splits + 3) / 4 * 4;
  const int64_t c0 = split * seg;
  const int64_t c1 = c0 + seg < a.P ? c0 + seg : a.P;
  int n = 0;
  u64 thr = kNone;
  const PivotSource<M> src{a.dots + b * a.P, a.pn, a.slots, a.qn[b], a.k <= 32, a.P % 4 == 0};
  // the first cut sorts 256 values (512 above k = 128), as select_k's
  filter(s, src, c0, c1, a.k > 128 ? 2 * kSkThreads : kSkThreads, a.k, n, thr);
  if (a.splits > 1 &&
      !merge_splits(s, a.part + b * a.splits * a.k, a.done + b, split, a.splits, a.k, n, thr))
    return;
  score_seeds<T, M>(a, s, qs, b);
}

template <typename T, int M>
int launch(const SeedArgs& a, int B, cudaStream_t stream) {
  const auto kernel = pivot_seeds_kernel<T, M>;
  const size_t smem = kSeedQs + static_cast<size_t>(a.d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // as many blocks on an SM as its shared memory holds
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * a.splits, kSkThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_metric(const SeedArgs& a, int B, int metric, cudaStream_t stream) {
  if (metric == L2SQ) return launch<T, L2SQ>(a, B, stream);
  if (metric == COSINE) return launch<T, COSINE>(a, B, stream);
  return launch<T, IP>(a, B, stream);
}

}  // namespace vss

// Seeds [B, k] int32 and their distances seed_d [B, k] f32 from dots
// [B, P] (f32, contiguous), the squared query norms qn [B], the squared
// pivot norms pn [P], the pivot slots [P] (int32, -1 for padding), the
// tape `table` [N, d] (dtype: common.cuh `DType`) and the queries q
// [B, d] f32, under `metric` (common.cuh `Metric`). With splits > 1 each
// row is cut into that many segments, one block each, and `ws` holds
// B * splits * k 8-byte entries followed by B ints. A shape the kernel
// does not take (k outside 1 .. min(P, 256), P above 2^31 - 1, d < 1,
// splits outside 1 .. P, splits > 1 without a workspace, an unknown dtype
// or metric) is refused before anything is launched; B = 0 launches
// nothing.
extern "C" int vss_pivot_seeds(const float* dots, const float* qn, const float* pn,
                               const int32_t* slots, const void* table, const float* q,
                               int32_t* seeds, float* seed_d, void* ws, int B, int64_t P,
                               int d, int dtype, int metric, int k, int splits,
                               void* stream) {
  using namespace vss;
  if (B < 0 || P < 1 || P > 0x7fffffffLL || d < 1 || k < 1 || k > kSkMaxK || k > P ||
      splits < 1 || splits > P || (splits > 1 && ws == nullptr) ||
      static_cast<int64_t>(B) * splits > 0x7fffffffLL || dtype < F32 || dtype > I8 ||
      metric < L2SQ || metric > IP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SeedArgs a;
  a.dots = dots, a.qn = qn, a.pn = pn, a.slots = slots, a.table = table, a.q = q;
  a.seeds = seeds, a.seed_d = seed_d;
  a.part = static_cast<u64*>(ws);
  a.done = splits > 1 ? reinterpret_cast<int*>(a.part + static_cast<int64_t>(B) * splits * k)
                      : nullptr;
  a.P = P, a.k = k, a.splits = splits, a.d = d;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(a.done, 0, sizeof(int) * static_cast<size_t>(B), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == I8) {
    row_grouping<int8_t>(d, a.group, a.vec);
    return launch_metric<int8_t>(a, B, metric, s);
  }
  if (dtype == BF16) {
    row_grouping<__nv_bfloat16>(d, a.group, a.vec);
    return launch_metric<__nv_bfloat16>(a, B, metric, s);
  }
  row_grouping<float>(d, a.group, a.vec);
  return launch_metric<float>(a, B, metric, s);
}
