// beam_search: one launch runs the whole beam search of a batch, one
// thread block per query.
//
// Replaces, inside the loop of vss_tpu/index/search.py:beam_search_base
// (the lax.while_loop at :442), the two TPU kernels that loop launches
// once per iteration: vss_tpu/ops/gather.py:_gather_dist_kernel (:142, the
// fused gather + distance) and vss_tpu/ops/gather.py:_gather_kernel (:39,
// the adjacency-row gather), together with the selection, the dedupe, the
// sort and the two pool merges between them. Nothing of one query's state
// is read by another, so the batch's lockstep loop is B independent loops.
//
// Bound on the H100: a query reads `evals` tape rows plus `iterations * E`
// adjacency rows, a few hundred KB at the serving shape (512 queries,
// ef = 64, 128-B rows: about 72 iterations of 32 rows), microseconds of
// the card's 3.35 TB/s. What bounds it is the chain of dependent reads:
// each iteration must read an adjacency row before it knows which tape
// rows to read, and must merge their distances before it knows the next
// row, so a query cannot run faster than iterations x two round trips to
// device memory, a few hundred nanoseconds each (csrc/probe.cu measures
// them); the rest of its time is a block's own serial work between its
// barriers. Design:
//   * all state of a query lives in its block's shared memory: the
//     candidate pool (key, id, expanded flag) and the result pool, each
//     the first `ef` slots of a power-of-two merge buffer; the expansion
//     history; the scored batch; the query in f32. About 50 B per `ef`,
//     4 KB at ef = 64, so every query of a batch is resident at once and
//     the SMs overlap one query's round trips with the others' work.
//     Above 48 KB the kernel asks for more dynamic shared memory, up to
//     the 227 KB a block may have;
//   * one thread per neighbour slot (E * fan-out, at least 128 threads):
//     it loads its id of the adjacency row, tests it against the pools
//     and the history, and reads its `allow` flag while the rows load;
//   * the tape rows are scored by gather.cuh's `score_row`, K1's scorer
//     with K1's lane grouping, so a distance equals K1's bit for bit;
//   * every row takes direct loads, whatever its width or alignment: each
//     group of lanes loads its row from device memory as K1 does, 32/G
//     rows per warp in flight, so the four warps of a 128-thread block
//     keep 16 rows of 128 B in flight. Staging the iteration's rows in
//     shared memory with `cp.async` first, all of them in flight before
//     any is scored, was measured on the H100 and was slower at this
//     block size, so it is not kept;
//   * the scored batch is ranked by (distance, position), NaN last, which
//     is a stable sort, and merged into the pool by the same bitonic
//     network as the plain version (`_merge_sorted`): a ++ pad ++
//     reverse(b), compare-exchange at step = P/2 .. 1, swap when
//     key[lo] > key[hi], so ties and NaN fall as they do there. Steps of
//     32 or less stay inside a warp's own 64 slots and need no block-wide
//     barrier; the two reductions (least unexpanded key, its lowest
//     position) are one `redux.sync` each on order-preserving integer
//     keys;
//   * no tensor cores: a block scores a few dozen rows against one query,
//     a matrix-vector product with no tile for `wgmma` to work on.
// Counters, 64-bit: [0] the largest number of iterations any query ran
// (atomicMax), [1] the tape rows scored and [2] the nodes expanded, which
// is the adjacency rows asked for (atomicAdd).
#include "gather.cuh"

namespace vss {

constexpr int kMaxSmem = 232448;      // 227 KB: the most a block may have
constexpr int kMinThreads = 128;      // a block's threads, at least

struct BeamArgs {
  const float* q;            // [B, d]
  const float* qn;           // [B] squared query norms
  const void* table;         // [cap, d] tape
  const int32_t* adj;        // adj0 [cap, fan] or upper_adj [rows, fan]
  const int32_t* upper_row;  // [cap, lmax], read when level_col >= 0
  const uint8_t* allow;      // [cap] bool, read under dual only
  float* cand_d;             // [B, ef] in: seeded pool, out: final pool
  int32_t* cand_i;
  float* res_d;  // [B, ef] in / out under dual, else unused
  int32_t* res_i;
  unsigned long long* counters;  // [3]: iterations, rows scored, expansions
  int ef, E, fan, d, metric, max_iters, level_col, lmax;
  int P, log2p, hist_len, group, rank_lanes_log2;
  bool vec, dual, use_history;
};

// Byte offsets of a block's shared memory. The Python wrapper mirrors
// this arithmetic (`beam_smem_bytes`) to refuse a shape before launching.
struct BeamLayout {
  int qs, ckey, cid, rkey, rid, hist, nid, nd, red_key, red_pos, misc;
  int cflag, dup, okf, total;
};

inline __host__ __device__ BeamLayout beam_layout(int ef, int n, int P, int d,
                                                  int hist_len, bool dual) {
  BeamLayout L;
  int o = 0;
  L.qs = o, o += 4 * d;
  L.ckey = o, o += 4 * P;
  L.cid = o, o += 4 * P;
  L.rkey = o, o += dual ? 4 * P : 0;
  L.rid = o, o += dual ? 4 * P : 0;
  L.hist = o, o += 4 * hist_len;
  L.nid = o, o += 4 * n;
  L.nd = o, o += 4 * n;
  L.red_key = o, o += 4 * 32;
  L.red_pos = o, o += 4 * 32;
  L.misc = o, o += 4 * 4;
  L.cflag = o, o += P;
  L.dup = o, o += n;
  L.okf = o, o += n;
  L.total = (o + 15) / 16 * 16;
  return L;
}

// A float as an unsigned key that orders as torch.sort and torch.argmin
// order floats: ascending, -0 equal to +0, every NaN equal and after +inf.
__device__ __forceinline__ unsigned sort_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) return 0x80000000u;  // -0 as +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Best {
  float key;  // least key, NaN left out
  int pos;    // its lowest position (as torch.argmin)
  bool nan;   // some key was NaN
};

// The least of key[i] = (flag[i] or i in skip[0..nskip)) ? +inf : keys[i]
// over the pool, lowest position on ties. Every thread of the block calls
// it and gets the same answer. The caller must __syncthreads() before the
// next call (the partials in red_* are still being read on return).
__device__ __forceinline__ Best pool_min(const float* keys,
                                         const unsigned char* flag, int ef,
                                         const int* skip, int nskip,
                                         unsigned* red_key, int* red_pos) {
  unsigned bk = 0xffffffffu;
  int bp = 0x7fffffff;
  bool nan = false;
  for (int i = threadIdx.x; i < ef; i += blockDim.x) {
    bool out = flag[i] != 0;
    for (int s = 0; s < nskip; ++s) out = out || skip[s] == i;
    const float k = out ? CUDART_INF_F : keys[i];
    if (isnan(k)) {
      nan = true;
    } else {
      const unsigned u = sort_key(k);
      if (u < bk) bk = u, bp = i;  // i ascends: the first of equal keys stays
    }
  }
  // the warp's least key, then the lowest position that holds it
  const unsigned wk = __reduce_min_sync(0xffffffffu, bk);
  const unsigned wp = __reduce_min_sync(
      0xffffffffu, bk == wk ? static_cast<unsigned>(bp) : 0x7fffffffu);
  const bool wnan = __any_sync(0xffffffffu, nan) != 0;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red_key[warp] = wk;
    // the NaN flag rides in the position's sign bit
    red_pos[warp] = static_cast<int>(wnan ? (wp | 0x80000000u) : wp);
  }
  __syncthreads();
  unsigned k = 0xffffffffu;
  Best best = {CUDART_INF_F, 0x7fffffff, false};
  const int nwarps = blockDim.x >> 5;
  for (int w = 0; w < nwarps; ++w) {
    const unsigned wk2 = red_key[w];
    const int raw = red_pos[w];
    const int p = raw & 0x7fffffff;
    best.nan = best.nan || raw < 0;
    if (wk2 < k || (wk2 == k && p < best.pos)) k = wk2, best.pos = p;
  }
  best.key = key_value(k);
  return best;
}

// One bitonic merge of the P-slot buffer(s), P = 2^log2p: the candidate
// pool's (key, id, flag) and, under `dual`, the result pool's (key, id).
// A warp's 32 pairs of a step of 32 or less lie in its own 64 slots, so
// those steps need no barrier across warps between them.
__device__ __forceinline__ void merge_network(float* ckey, int32_t* cid,
                                              unsigned char* cflag,
                                              float* rkey, int32_t* rid,
                                              int log2p, bool dual) {
  const int pairs = 1 << (log2p - 1);
  for (int s = log2p - 1; s >= 0; --s) {
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      // lo = (p / step) * 2 * step + p % step, step = 2^s
      const int lo = ((p >> s) << (s + 1)) | (p & ((1 << s) - 1));
      const int hi = lo + (1 << s);
      const float a = ckey[lo], b = ckey[hi];
      if (a > b) {
        ckey[lo] = b, ckey[hi] = a;
        const int32_t ti = cid[lo];
        cid[lo] = cid[hi], cid[hi] = ti;
        const unsigned char tf = cflag[lo];
        cflag[lo] = cflag[hi], cflag[hi] = tf;
      }
      if (dual) {
        const float ra = rkey[lo], rb = rkey[hi];
        if (ra > rb) {
          rkey[lo] = rb, rkey[hi] = ra;
          const int32_t ti = rid[lo];
          rid[lo] = rid[hi], rid[hi] = ti;
        }
      }
    }
    if (s > 5 || s == 0)
      __syncthreads();
    else
      __syncwarp();
  }
}

template <typename T>
__global__ void beam_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t b = blockIdx.x;
  const int ef = a.ef, E = a.E, fan = a.fan, d = a.d, P = a.P;
  const int n = E * fan;  // neighbour slots of one iteration, n <= nt
  const BeamLayout L = beam_layout(ef, n, P, d, a.hist_len, a.dual);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ckey = reinterpret_cast<float*>(smem + L.ckey);
  int32_t* cid = reinterpret_cast<int32_t*>(smem + L.cid);
  float* rkey = reinterpret_cast<float*>(smem + L.rkey);
  int32_t* rid = reinterpret_cast<int32_t*>(smem + L.rid);
  int32_t* hist = reinterpret_cast<int32_t*>(smem + L.hist);
  int32_t* nid = reinterpret_cast<int32_t*>(smem + L.nid);
  float* nd = reinterpret_cast<float*>(smem + L.nd);
  unsigned* red_key = reinterpret_cast<unsigned*>(smem + L.red_key);
  int* red_pos = reinterpret_cast<int*>(smem + L.red_pos);
  int* live_count = reinterpret_cast<int*>(smem + L.misc);
  unsigned char* cflag = smem + L.cflag;
  unsigned char* dup = smem + L.dup;
  unsigned char* okf = smem + L.okf;
  // the picks of one iteration: pool positions and node ids, E each; they
  // share the scored batch's arrays, which are idle while picking
  int* sel_pos = reinterpret_cast<int*>(nd);
  int32_t* sel_id = nid;

  for (int e = tid; e < d; e += nt) qs[e] = a.q[b * d + e];
  for (int i = tid; i < ef; i += nt) {
    ckey[i] = a.cand_d[b * ef + i];
    cid[i] = a.cand_i[b * ef + i];
    cflag[i] = 0;
    if (a.dual) {
      rkey[i] = a.res_d[b * ef + i];
      rid[i] = a.res_i[b * ef + i];
    }
  }
  __syncthreads();
  const float qnb = a.qn[b];
  const T* table = static_cast<const T*>(a.table);
  const int group = a.group;
  const int g = tid / group;
  const int gl = tid % group;
  const int ngroups = nt / group;
  const int pick = tid / fan;   // the pick whose row holds this thread's slot
  const int in_row = tid % fan;
  const int parts = nt / n;     // threads per slot in the membership test
  const int part = tid / n;
  const int slot = tid % n;
  const int rl = a.rank_lanes_log2;  // 2^rl lanes rank one scored entry
  const int rank_of = tid >> rl;
  const int rank_lane = tid & ((1 << rl) - 1);
  int it = 0;
  unsigned long long scored = 0, expansions = 0;  // thread 0's counts

  Best best = pool_min(ckey, cflag, ef, nullptr, 0, red_key, red_pos);
  while (it < a.max_iters) {
    // done: nothing unexpanded is nearer than the worst result
    const float worst = a.dual ? rkey[ef - 1] : ckey[ef - 1];
    if (best.nan || !isfinite(best.key) || best.key > worst) break;

    // ---- pick the E best unexpanded candidates
    for (int j = 0; j < E; ++j) {
      if (j > 0) best = pool_min(ckey, cflag, ef, sel_pos, j, red_key, red_pos);
      const bool hit = isfinite(best.key);
      if (tid == 0) {
        sel_pos[j] = best.pos;
        sel_id[j] = hit ? cid[best.pos] : -1;
        if (hit) cflag[best.pos] = 1, ++expansions;
        if (j == 0) *live_count = 0;
      }
      __syncthreads();
    }
    int my_sel = -1;
    if (tid < n) my_sel = sel_id[pick];
    if (a.use_history && tid < E) hist[it * E + tid] = sel_id[tid];
    __syncthreads();  // the picks are read: nid / nd may be overwritten

    // ---- the picks' adjacency rows, one id per thread
    if (tid < n) {
      const int32_t* src = nullptr;
      if (my_sel >= 0) {
        if (a.level_col < 0) {
          src = a.adj + static_cast<int64_t>(my_sel) * fan;
        } else {
          const int32_t row =
              a.upper_row[static_cast<int64_t>(my_sel) * a.lmax + a.level_col];
          if (row >= 0) src = a.adj + static_cast<int64_t>(row) * fan;
        }
      }
      if (src != nullptr)
        copy_row<int32_t>(nid + (tid - in_row), src, fan, in_row, fan);
      else
        nid[tid] = -1;
      dup[tid] = 0;
    }
    __syncthreads();

    // ---- drop ids already in the candidate pool, the history or the
    // result pool: `parts` threads share a slot's test, each taking every
    // parts-th known id
    {
      const int32_t mine = part < parts ? nid[slot] : -1;
      if (mine >= 0) {
        int found = 0;
#pragma unroll 4
        for (int i = part; i < ef; i += parts) found |= cid[i] == mine;
        if (a.use_history) {
          const int seen = (it + 1) * E;
#pragma unroll 4
          for (int i = part; i < seen; i += parts) found |= hist[i] == mine;
        }
        if (a.dual) {
#pragma unroll 4
          for (int i = part; i < ef; i += parts) found |= rid[i] == mine;
        }
        if (found) dup[slot] = 1;
      }
    }
    __syncthreads();
    if (tid < n && dup[tid]) nid[tid] = -1;
    if (E > 1) {
      // ---- and ids that an earlier pick's row already holds
      __syncthreads();
      if (tid < n) {
        const int32_t mine = nid[tid];
        const int prior = pick * fan;
        int found = 0;
        if (mine >= 0) {
#pragma unroll 4
          for (int i = 0; i < prior; ++i) found |= nid[i] == mine;
        }
        dup[tid] = found ? 1 : 0;
      }
      __syncthreads();
      if (tid < n && dup[tid]) nid[tid] = -1;
    }
    const int32_t my_id = tid < n ? nid[tid] : -1;
    {
      const unsigned live = __ballot_sync(0xffffffffu, my_id >= 0);
      if ((tid & 31) == 0 && live != 0) atomicAdd(live_count, __popc(live));
    }
    // the admission flag loads while the rows do
    bool my_ok = false;
    if (a.dual && my_id >= 0) my_ok = a.allow[my_id] != 0;
    __syncthreads();  // nid is final

    // ---- score the survivors against the query (K1's work)
    for (int base = 0; base < n; base += ngroups) {
      const int c = base + g;
      const int32_t id = c < n ? nid[c] : -1;
      const T* row =
          id >= 0 ? table + static_cast<int64_t>(id) * d : nullptr;
      float dot, xn;
      score_row<T>(row, qs, d, group, gl, a.vec, dot, xn);
      if (gl == 0 && c < n)
        nd[c] = id >= 0 ? epilogue(dot, qnb, xn, a.metric) : CUDART_INF_F;
    }
    if (tid < n) okf[tid] = my_ok ? 1 : 0;
    __syncthreads();
    if (tid == 0) scored += static_cast<unsigned long long>(*live_count);

    // ---- stable sort of the batch by distance: an entry's rank is the
    // count of entries that sort before it by (key, position), counted
    // by 2^rl lanes together; it lands reversed in the tail of the merge
    // buffer. Under `dual` the same for the admissible entries.
    {
      const bool mine_in = rank_of < n;
      const float mine = mine_in ? nd[rank_of] : CUDART_INF_F;
      const bool mine_ok = mine_in && a.dual && okf[rank_of] != 0;
      const unsigned ck = sort_key(mine);
      const unsigned rk = sort_key(mine_ok ? mine : CUDART_INF_F);
      int rank = 0, rrank = 0;
      if (mine_in) {
        for (int j = rank_lane; j < n; j += 1 << rl) {
          const float v = nd[j];
          const unsigned kj = sort_key(v);
          rank += (kj < ck || (kj == ck && j < rank_of)) ? 1 : 0;
          if (a.dual) {
            const unsigned rj = okf[j] ? kj : sort_key(CUDART_INF_F);
            rrank += (rj < rk || (rj == rk && j < rank_of)) ? 1 : 0;
          }
        }
      }
      for (int off = (1 << rl) >> 1; off > 0; off >>= 1) {
        rank += __shfl_xor_sync(0xffffffffu, rank, off);
        rrank += __shfl_xor_sync(0xffffffffu, rrank, off);
      }
      if (mine_in && rank_lane == 0) {
        const int32_t id = nid[rank_of];
        ckey[P - 1 - rank] = mine;
        cid[P - 1 - rank] = id;
        cflag[P - 1 - rank] = 0;
        if (a.dual) {
          rkey[P - 1 - rrank] = mine_ok ? mine : CUDART_INF_F;
          rid[P - 1 - rrank] = id;
        }
      }
    }
    for (int i = ef + tid; i < P - n; i += nt) {
      ckey[i] = CUDART_INF_F, cid[i] = -1, cflag[i] = 1;
      if (a.dual) rkey[i] = CUDART_INF_F, rid[i] = -1;
    }
    __syncthreads();
    merge_network(ckey, cid, cflag, rkey, rid, a.log2p, a.dual);
    if (a.dual)
      for (int i = tid; i < ef; i += nt)
        if (!isfinite(rkey[i])) rid[i] = -1;
    ++it;
    best = pool_min(ckey, cflag, ef, nullptr, 0, red_key, red_pos);
  }

  __syncthreads();
  for (int i = tid; i < ef; i += nt) {
    a.cand_d[b * ef + i] = ckey[i];
    a.cand_i[b * ef + i] = cid[i];
    if (a.dual) {
      a.res_d[b * ef + i] = rkey[i];
      a.res_i[b * ef + i] = rid[i];
    }
  }
  if (tid == 0) {
    atomicMax(a.counters, static_cast<unsigned long long>(it));
    atomicAdd(a.counters + 1, scored);
    atomicAdd(a.counters + 2, expansions);
  }
}

// Fills the derived fields of `a` (P, hist_len, group, vec) and the
// block's thread count: one thread per neighbour slot, at least
// kMinThreads, whole warps. Returns the block's shared-memory bytes, or -1
// for a shape the kernel does not take.
template <typename T>
int64_t plan(BeamArgs& a, int& threads) {
  const int n = a.E * a.fan;
  if (a.ef < 1 || a.E < 1 || a.fan < 1 || a.d < 1 || a.max_iters < 1 ||
      n > 1024)
    return -1;
  threads = (n + 31) / 32 * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  int64_t P = 1;
  a.log2p = 0;
  while (P < static_cast<int64_t>(a.ef) + n) P <<= 1, ++a.log2p;
  // lanes that rank one scored entry together: a power of two, inside a warp
  a.rank_lanes_log2 = 0;
  while ((2 << a.rank_lanes_log2) * n <= threads && a.rank_lanes_log2 < 5)
    ++a.rank_lanes_log2;
  const int64_t hist_len =
      a.use_history ? static_cast<int64_t>(a.max_iters) * a.E : 0;
  row_grouping<T>(a.d, a.group, a.vec);
  // the sizes as 64-bit sums first: the layout's ints must not overflow
  const int64_t rough = 4LL * a.d + (a.dual ? 17 : 9) * P + 4 * hist_len +
                        10LL * n + 288;
  if (rough > (1LL << 30)) return rough;
  a.P = static_cast<int>(P);
  a.hist_len = static_cast<int>(hist_len);
  return beam_layout(a.ef, n, a.P, a.d, a.hist_len, a.dual).total;
}

// `smem_expected` is the wrapper's own count of the block's shared-memory
// bytes (`beam_smem_bytes`, by which it refuses a shape before launching):
// a count that differs from the layout's is refused here.
template <typename T>
int launch_beam(BeamArgs a, int B, int64_t smem_expected, cudaStream_t s) {
  int threads = 0;
  const int64_t smem = plan<T>(a, threads);
  if (smem < 0 || smem > kMaxSmem || smem != smem_expected)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_kernel<T><<<B, threads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vss

// The pools arrive seeded and sorted in cand_* / res_* and leave in the
// same buffers; the three counters must be zero on entry. `level` 0 walks
// adj0 (`adj`, fan-out `fan`), level >= 1 walks upper_adj through column
// level - 1 of upper_row. `smem_bytes` is the caller's count of a block's
// shared memory, which must equal the layout's.
extern "C" int vss_beam_search(const float* q, const float* qn,
                               const void* table, const int32_t* adj,
                               const int32_t* upper_row, const void* allow,
                               float* cand_d, int32_t* cand_i, float* res_d,
                               int32_t* res_i, int64_t* counters, int B,
                               int ef, int E, int fan, int d, int dtype,
                               int metric, int max_iters, int level, int lmax,
                               int dual, int use_history, int smem_bytes,
                               void* stream) {
  using namespace vss;
  if (B <= 0) return 0;
  BeamArgs a;
  a.q = q, a.qn = qn, a.table = table, a.adj = adj, a.upper_row = upper_row;
  a.allow = static_cast<const uint8_t*>(allow);
  a.cand_d = cand_d, a.cand_i = cand_i, a.res_d = res_d, a.res_i = res_i;
  a.counters = reinterpret_cast<unsigned long long*>(counters);
  a.ef = ef, a.E = E, a.fan = fan, a.d = d, a.metric = metric;
  a.max_iters = max_iters, a.level_col = level - 1, a.lmax = lmax;
  a.P = 0, a.log2p = 0, a.hist_len = 0, a.group = 1, a.rank_lanes_log2 = 0;
  a.vec = false;
  a.dual = dual != 0, a.use_history = use_history != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8) return launch_beam<int8_t>(a, B, smem_bytes, s);
  if (dtype == BF16) return launch_beam<__nv_bfloat16>(a, B, smem_bytes, s);
  return launch_beam<float>(a, B, smem_bytes, s);
}
