// greedy_descent: one launch runs the whole greedy descent of a batch over
// the graph's upper levels, one thread block per query.
//
// Replaces the loop of vss_tpu/index/search.py:greedy_descent (:102-150,
// the lax.while_loop around _descent_step at :75-100) together with the two
// TPU kernels its step reaches: vss_tpu/ops/gather.py:_gather_kernel (:39,
// the adjacency row, K5) and vss_tpu/ops/gather.py:_gather_dist_kernel
// (:142, the neighbours' distances, K1), and the argmin, the move and the
// level drop between them. Nothing of one query's state is read by
// another, so the batch's lockstep loop with a global step cap is B
// independent loops, each capped at `max_iters` steps.
//
// A step of query b at level `lvl` (> stop[b]) from node `cur`:
//   row    = upper_row[cur, max(lvl - 1, 0)]; active = lvl > 0 && row >= 0
//   ids    = active ? upper_adj[row, 0..M) : -1 (an id < 0 scores +inf and
//            loads nothing)
//   j      = argmin of the M distances, as torch.argmin / jnp.argmin: the
//            first NaN if there is one, else the first least value (-0
//            equal to +0)
//   moves to ids[j] if active && d[j] < cur_d, else drops a level
//            (lvl = max(lvl - 1, 0)); a NaN d[j] never moves.
//
// Bound on the H100: a step reads one upper_row entry, one adjacency row
// (M ids) and M tape rows: at the flagship (M=16, 128-B int8 rows) about
// 2.1 KB, some 16 steps a query, 34 KB; a wave of 1,024 queries moves about
// 35 MB, 0.01 ms of the card's 3.35 TB/s. What bounds it is the chain of
// dependent reads: the adjacency row needs `row`, the tape rows need the
// ids, the next step needs the argmin, so a query cannot run faster than
// steps x three round trips to device memory (csrc/probe.cu measures one).
// Design:
//   * one block of 128 threads per query, the query in shared memory; a
//     group of G lanes scores one neighbour with gather.cuh's `score_row`
//     (K1's scorer with K1's lane grouping: 8 lanes for a 128-B int8 row),
//     so a distance equals K1's bit for bit; M past one round of groups
//     (M=48 at the iid arm's m) makes the groups stride over the row;
//   * the adjacency ids are read by the scoring lanes themselves, one id
//     per group, with no staging in shared memory;
//   * the argmin: each group keeps its first least (key, position, value,
//     id) in registers, the warps reduce by shuffles, and one shared-memory
//     step across the four warps gives every thread the same answer, so
//     the level, the node and its distance stay in registers and every
//     thread runs the same loop. The partials alternate between two
//     buffers, one barrier a step;
//   * no tensor cores: a block scores M rows against one query, a
//     matrix-vector product with no tile for `wgmma` or `mma.sync`.
// Counters, 64-bit: [0] the most steps any query ran (atomicMax), [1] the
// tape rows scored (ids >= 0) and [2] the adjacency rows read, over the
// batch (atomicAdd).
#include "gather.cuh"

namespace vss {

constexpr int kThreads = 128;  // a block's threads
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may have

struct DescentArgs {
  const float* q;            // [B, d]
  const float* qn;           // [B] squared query norms
  const void* table;         // [cap, d] tape
  const int32_t* upper_row;  // [cap, lmax]
  const int32_t* upper_adj;  // [rows, M]
  const int32_t* entry;      // 0-d: the entry slot, -1 when empty
  const int32_t* max_level;  // 0-d
  const int32_t* stop;       // [B] stop levels
  int32_t* cur;              // [B] out: the node reached
  float* cur_d;              // [B] out: its distance
  unsigned long long* counters;  // [3]: steps, rows scored, adjacency rows
  int M, d, lmax, metric, max_iters, group;
  bool vec;
};

// Shared memory: the query (4 d bytes, rounded to 16), then two buffers of
// the per-warp argmin partials (key, position, value, id).
inline __host__ __device__ int partials_offset(int d) {
  return (4 * d + 15) / 16 * 16;
}
inline __host__ __device__ int descent_smem(int d) {
  return partials_offset(d) + 2 * 4 * 4 * kWarps;
}

// (key, pos) before (k2, p2): the lesser key, then the lower position
__device__ __forceinline__ bool before(unsigned k2, int p2, unsigned key,
                                       int pos) {
  return k2 < key || (k2 == key && p2 < pos);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) descent_kernel(DescentArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int d = a.d, M = a.M;
  float* qs = reinterpret_cast<float*>(smem);
  unsigned* part = reinterpret_cast<unsigned*>(smem + partials_offset(d));
  for (int e = tid; e < d; e += kThreads) qs[e] = a.q[b * d + e];
  __syncthreads();
  const float qnb = a.qn[b];
  const T* table = static_cast<const T*>(a.table);
  const int group = a.group;
  const int g = tid / group;
  const int gl = tid % group;
  const int ngroups = kThreads / group;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int stop = a.stop[b];
  const int top = *a.max_level > 0 ? *a.max_level : 0;
  int lvl = top > stop ? top : stop;
  int32_t cur = *a.entry > 0 ? *a.entry : 0;
  float cur_d;
  {
    // every group scores the entry: each thread holds its distance
    float dot, xn;
    score_row<T>(table + static_cast<int64_t>(cur) * d, qs, d, group, gl,
                 a.vec, dot, xn);
    cur_d = epilogue(dot, qnb, xn, a.metric);
  }
  int steps = 0;
  unsigned long long scored = 0, adj_rows = 0;  // lane 0's counts, per warp
  int buf = 0;
  while (steps < a.max_iters && lvl > stop) {
    const int col = lvl > 1 ? lvl - 1 : 0;
    int32_t row = -1;
    if (lvl > 0 && col < a.lmax)
      row = a.upper_row[static_cast<int64_t>(cur) * a.lmax + col];
    const bool active = lvl > 0 && row >= 0;
    const int32_t* adj =
        a.upper_adj + static_cast<int64_t>(active ? row : 0) * M;
    // this group's first least neighbour
    unsigned bk = 0xffffffffu;
    int bp = 0x7fffffff;
    float bv = CUDART_INF_F;
    int32_t bi = -1;
    for (int base = 0; base < M; base += ngroups) {
      const int c = base + g;
      const int32_t id = active && c < M ? adj[c] : -1;
      float dot, xn;
      score_row<T>(id >= 0 ? table + static_cast<int64_t>(id) * d : nullptr,
                   qs, d, group, gl, a.vec, dot, xn);
      const unsigned live = __ballot_sync(0xffffffffu, gl == 0 && id >= 0);
      if (lane == 0) scored += __popc(live);
      if (c < M) {
        const float v =
            id >= 0 ? epilogue(dot, qnb, xn, a.metric) : CUDART_INF_F;
        const unsigned k = order_key(v, true);
        // c ascends within a group: the first of equal keys stays
        if (k < bk) bk = k, bp = c, bv = v, bi = id;
      }
    }
    // across the groups of the warp (the lanes of a group agree already)
    for (int off = 16; off >= group; off >>= 1) {
      const unsigned k2 = __shfl_xor_sync(0xffffffffu, bk, off);
      const int p2 = __shfl_xor_sync(0xffffffffu, bp, off);
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, off);
      const int32_t i2 = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(k2, p2, bk, bp)) bk = k2, bp = p2, bv = v2, bi = i2;
    }
    // across the warps: buffer `buf` was last read two steps ago, before
    // the last step's barrier
    unsigned* pk = part + buf * 4 * kWarps;
    int* pp = reinterpret_cast<int*>(pk + kWarps);
    float* pv = reinterpret_cast<float*>(pk + 2 * kWarps);
    int32_t* pi = reinterpret_cast<int32_t*>(pk + 3 * kWarps);
    if (lane == 0) pk[warp] = bk, pp[warp] = bp, pv[warp] = bv, pi[warp] = bi;
    __syncthreads();
    bk = pk[0], bp = pp[0], bv = pv[0], bi = pi[0];
    for (int w = 1; w < kWarps; ++w)
      if (before(pk[w], pp[w], bk, bp))
        bk = pk[w], bp = pp[w], bv = pv[w], bi = pi[w];
    buf ^= 1;
    if (active && bv < cur_d) {
      cur = bi;
      cur_d = bv;
    } else {
      lvl = lvl > 1 ? lvl - 1 : 0;
    }
    if (active && tid == 0) ++adj_rows;
    ++steps;
  }
  if (tid == 0) {
    a.cur[b] = cur;
    a.cur_d[b] = cur_d;
    atomicMax(a.counters, static_cast<unsigned long long>(steps));
    atomicAdd(a.counters + 2, adj_rows);
  }
  if (lane == 0 && scored) atomicAdd(a.counters + 1, scored);
}

template <typename T>
int launch_descent(DescentArgs a, int B, cudaStream_t s) {
  row_grouping<T>(a.d, a.group, a.vec);
  const int smem = descent_smem(a.d);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        descent_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  descent_kernel<T><<<B, kThreads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vss

// `entry` and `max_level` are the graph's 0-d tensors, read on the device;
// `stop` holds one stop level per query. The three counters must be zero
// on entry. A shape the kernel does not take (M, d or max_iters below 1,
// lmax below 0, a query past a block's shared memory) is refused before
// anything is launched.
extern "C" int vss_greedy_descent(const float* q, const float* qn,
                                  const void* table, const int32_t* upper_row,
                                  const int32_t* upper_adj,
                                  const int32_t* entry,
                                  const int32_t* max_level,
                                  const int32_t* stop, int32_t* cur,
                                  float* cur_d, int64_t* counters, int B,
                                  int M, int d, int lmax, int dtype,
                                  int metric, int max_iters, void* stream) {
  using namespace vss;
  if (M < 1 || d < 1 || lmax < 0 || max_iters < 1 ||
      descent_smem(d) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  DescentArgs a;
  a.q = q, a.qn = qn, a.table = table, a.upper_row = upper_row;
  a.upper_adj = upper_adj, a.entry = entry, a.max_level = max_level;
  a.stop = stop, a.cur = cur, a.cur_d = cur_d;
  a.counters = reinterpret_cast<unsigned long long*>(counters);
  a.M = M, a.d = d, a.lmax = lmax, a.metric = metric;
  a.max_iters = max_iters, a.group = 1, a.vec = false;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8) return launch_descent<int8_t>(a, B, s);
  if (dtype == BF16) return launch_descent<__nv_bfloat16>(a, B, s);
  return launch_descent<float>(a, B, s);
}
