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
//   * the wide layout, for pools past those 227 KB (ef above 8,160 with
//     two pools at d=128, m0=32) or when the caller forces it: the two
//     pools, their flags and the history move to a per-query workspace
//     in device memory that the wrapper allocates; the query and the
//     per-iteration buffers stay in shared memory. The kernel body is the
//     same and only the pools' pointers differ, so both layouts run the
//     same comparisons in the same order and give bit-equal output;
//   * one thread per neighbour slot (E * fan-out, at least 128 threads,
//     at most 256; past that each thread strides over the slots): it
//     loads its id of the adjacency row, tests it against the pools and
//     the history, and reads its `allow` flag while the rows load;
//   * the layout and the striding are template parameters (kWide,
//     kStride), so the shared layout's pools stay shared-memory pointers
//     and the one-slot-a-thread loops stay single passes: the serving
//     shape compiles to what it was before the wide layout existed;
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
// and at most: 256 threads of at most 255 registers each fit an SM's
// 65,536 whatever the compiler allots (one thread per slot at 1,024
// threads of 110 registers was refused: too many resources requested for
// launch). Past it the threads stride over the slots.
constexpr int kMaxThreads = 256;

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
  unsigned char* workspace;  // wide layout: [B, pool_total] bytes, else null
  int ef, E, fan, d, metric, max_iters, level_col, lmax;
  int P, log2p, hist_len, group, rank_lanes_log2;
  bool vec, dual, use_history, wide;
};

// Byte offsets of a block's buffers. The shared layout keeps all of them in
// shared memory, in this order. The wide layout moves the pools (ckey, cid,
// rkey, rid, cflag) and the history to the block's slice of the workspace,
// in the same order, and keeps the rest in shared memory. `total` is a
// block's shared memory, `pool_total` a query's workspace bytes (0 in the
// shared layout). The Python wrapper mirrors this arithmetic
// (`beam_smem_bytes`, `beam_pool_bytes`) to pick a layout and to refuse a
// shape before launching.
struct BeamLayout {
  int qs, ckey, cid, rkey, rid, hist, nid, nd, red_key, red_pos, misc;
  int cflag, dup, okf, total, pool_total;
};

inline __host__ __device__ BeamLayout beam_layout(int ef, int n, int P, int d,
                                                  int hist_len, bool dual,
                                                  bool wide) {
  BeamLayout L;
  int o = 0, g = 0;
  int& p = wide ? g : o;  // where the pools and the history go
  L.qs = o, o += 4 * d;
  L.ckey = p, p += 4 * P;
  L.cid = p, p += 4 * P;
  L.rkey = p, p += dual ? 4 * P : 0;
  L.rid = p, p += dual ? 4 * P : 0;
  L.hist = p, p += 4 * hist_len;
  L.nid = o, o += 4 * n;
  L.nd = o, o += 4 * n;
  L.red_key = o, o += 4 * 32;
  L.red_pos = o, o += 4 * 32;
  L.misc = o, o += 4 * 4;
  L.cflag = p, p += P;
  L.dup = o, o += n;
  L.okf = o, o += n;
  L.total = (o + 15) / 16 * 16;
  L.pool_total = (g + 15) / 16 * 16;
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

// f(s) for the neighbour slots s < n this thread owns: its own slot, or
// with kStride (more slots than threads) every blockDim-th slot from it.
template <bool kStride, typename F>
__device__ __forceinline__ void each_slot(int n, F&& f) {
  if (kStride) {
    for (int s = threadIdx.x; s < n; s += blockDim.x) f(s);
  } else if (static_cast<int>(threadIdx.x) < n) {
    f(static_cast<int>(threadIdx.x));
  }
}

template <typename T, bool kWide, bool kStride>
__global__ void beam_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t b = blockIdx.x;
  const int ef = a.ef, E = a.E, fan = a.fan, d = a.d, P = a.P;
  const int n = E * fan;  // neighbour slots of one iteration
  const BeamLayout L = beam_layout(ef, n, P, d, a.hist_len, a.dual, kWide);
  // the pools and the history: in shared memory, or in this query's slice
  // of the workspace
  unsigned char* pool = kWide ? a.workspace + b * L.pool_total : smem;
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ckey = reinterpret_cast<float*>(pool + L.ckey);
  int32_t* cid = reinterpret_cast<int32_t*>(pool + L.cid);
  float* rkey = reinterpret_cast<float*>(pool + L.rkey);
  int32_t* rid = reinterpret_cast<int32_t*>(pool + L.rid);
  int32_t* hist = reinterpret_cast<int32_t*>(pool + L.hist);
  int32_t* nid = reinterpret_cast<int32_t*>(smem + L.nid);
  float* nd = reinterpret_cast<float*>(smem + L.nd);
  unsigned* red_key = reinterpret_cast<unsigned*>(smem + L.red_key);
  int* red_pos = reinterpret_cast<int*>(smem + L.red_pos);
  int* live_count = reinterpret_cast<int*>(smem + L.misc);
  unsigned char* cflag = pool + L.cflag;
  unsigned char* dup = smem + L.dup;
  unsigned char* okf = smem + L.okf;
  // the picks of one iteration: pool positions and node ids, E each; they
  // share the scored batch's arrays, which are idle while picking. Under
  // kStride the picked ids are then copied over the positions (`picked`),
  // so that the adjacency rows may overwrite `nid`
  int* sel_pos = reinterpret_cast<int*>(nd);
  int32_t* sel_id = nid;
  int32_t* picked = reinterpret_cast<int32_t*>(nd);

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
  // threads per slot in the membership test (1 when the slots outnumber
  // the threads, which then stride over them)
  const int parts = n <= nt ? nt / n : 1;
  // one slot a thread (not kStride): the pick whose row holds this
  // thread's slot, the slot's place in that row, and the thread's part and
  // slot in the membership test, fixed for the whole beam
  const int my_pick = tid / fan, my_in_row = tid % fan;
  const int my_part = tid / n, my_slot = tid % n;
  const int rl = a.rank_lanes_log2;  // 2^rl lanes rank one scored entry
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
    // each slot's pick: in a register when a thread owns one slot, else
    // copied over the positions (sel_pos was last read before the pick's
    // barrier)
    int32_t my_sel = -1;
    if (kStride) {
      for (int j = tid; j < E; j += nt) picked[j] = sel_id[j];
    } else if (tid < n) {
      my_sel = sel_id[my_pick];
    }
    if (a.use_history)
      for (int j = tid; j < E; j += nt) hist[it * E + j] = sel_id[j];
    __syncthreads();  // the picks are read: nid may be overwritten

    // ---- the picks' adjacency rows, one id per slot
    each_slot<kStride>(n, [&](int s) {
      const int in_row = kStride ? s % fan : my_in_row;
      const int32_t sel = kStride ? picked[s / fan] : my_sel;
      const int32_t* src = nullptr;
      if (sel >= 0) {
        if (a.level_col < 0) {
          src = a.adj + static_cast<int64_t>(sel) * fan;
        } else {
          const int32_t row =
              a.upper_row[static_cast<int64_t>(sel) * a.lmax + a.level_col];
          if (row >= 0) src = a.adj + static_cast<int64_t>(row) * fan;
        }
      }
      if (src != nullptr)
        copy_row<int32_t>(nid + (s - in_row), src, fan, in_row, fan);
      else
        nid[s] = -1;
      dup[s] = 0;
    });
    __syncthreads();

    // ---- drop ids already in the candidate pool, the history or the
    // result pool: `parts` threads share a slot's test, each taking every
    // parts-th known id
    each_slot<kStride>(parts * n, [&](int u) {
      const int part = kStride ? u / n : my_part;
      const int slot = kStride ? u % n : my_slot;
      const int32_t mine = nid[slot];
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
    });
    __syncthreads();
    each_slot<kStride>(n, [&](int s) {
      if (dup[s]) nid[s] = -1;
    });
    if (E > 1) {
      // ---- and ids that an earlier pick's row already holds
      __syncthreads();
      each_slot<kStride>(n, [&](int s) {
        const int32_t mine = nid[s];
        const int prior = (kStride ? s / fan : my_pick) * fan;
        int found = 0;
        if (mine >= 0) {
#pragma unroll 4
          for (int i = 0; i < prior; ++i) found |= nid[i] == mine;
        }
        dup[s] = found ? 1 : 0;
      });
      __syncthreads();
      each_slot<kStride>(n, [&](int s) {
        if (dup[s]) nid[s] = -1;
      });
    }
    // the live count, and the admission flags: the first slot of each
    // thread keeps its flag in a register while the rows load and stores
    // it after the scoring; with kStride further slots store theirs at once
    bool my_ok = false;
    for (int s0 = 0; s0 < n; s0 += nt) {
      const int s = s0 + tid;
      const int32_t id = s < n ? nid[s] : -1;
      const unsigned live = __ballot_sync(0xffffffffu, id >= 0);
      if ((tid & 31) == 0 && live != 0) atomicAdd(live_count, __popc(live));
      const bool ok = a.dual && id >= 0 && a.allow[id] != 0;
      if (s0 == 0)
        my_ok = ok;
      else if (s < n)
        okf[s] = ok ? 1 : 0;
      if (!kStride) break;  // one slot a thread: a single pass
    }
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
    for (int e0 = 0; e0 < n; e0 += nt >> rl) {
      const int rank_of = e0 + (tid >> rl);
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
      if (!kStride) break;  // every entry has its lanes: a single pass
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
// kMinThreads and at most kMaxThreads (then the threads stride over the
// slots), whole warps. Returns the layout, or sets `ok` false for a shape
// the kernel does not take.
template <typename T>
BeamLayout plan(BeamArgs& a, int& threads, bool& ok) {
  BeamLayout L = {};
  ok = false;
  const int64_t n = static_cast<int64_t>(a.E) * a.fan;
  if (a.ef < 1 || a.E < 1 || a.fan < 1 || a.d < 1 || a.max_iters < 1 ||
      n > (1 << 24))
    return L;
  threads = static_cast<int>((n + 31) / 32 * 32);
  if (threads < kMinThreads) threads = kMinThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
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
  if (rough > (1LL << 30)) return L;
  a.P = static_cast<int>(P);
  a.hist_len = static_cast<int>(hist_len);
  ok = true;
  return beam_layout(a.ef, static_cast<int>(n), a.P, a.d, a.hist_len, a.dual,
                     a.wide);
}

template <typename T, bool kWide, bool kStride>
int launch_kernel(const BeamArgs& a, int B, int threads, int smem,
                  cudaStream_t s) {
  auto kernel = beam_kernel<T, kWide, kStride>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// `smem_expected` and `pool_expected` are the wrapper's own counts of a
// block's shared memory and a query's workspace bytes (`beam_smem_bytes`,
// `beam_pool_bytes`, by which it picks the layout and refuses a shape
// before launching): counts that differ from the layout's are refused
// here, as is a workspace smaller than B queries' slices.
template <typename T>
int launch_beam(BeamArgs a, int B, int64_t smem_expected,
                int64_t pool_expected, int64_t workspace_bytes,
                cudaStream_t s) {
  int threads = 0;
  bool ok = false;
  const BeamLayout L = plan<T>(a, threads, ok);
  if (!ok || L.total > kMaxSmem || L.total != smem_expected ||
      L.pool_total != pool_expected ||
      static_cast<int64_t>(B) * L.pool_total > workspace_bytes ||
      (a.wide && a.workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stride = a.E * a.fan > threads;
  if (a.wide)
    return stride ? launch_kernel<T, true, true>(a, B, threads, L.total, s)
                  : launch_kernel<T, true, false>(a, B, threads, L.total, s);
  return stride ? launch_kernel<T, false, true>(a, B, threads, L.total, s)
                : launch_kernel<T, false, false>(a, B, threads, L.total, s);
}

}  // namespace vss

// The pools arrive seeded and sorted in cand_* / res_* and leave in the
// same buffers; the three counters must be zero on entry. `level` 0 walks
// adj0 (`adj`, fan-out `fan`), level >= 1 walks upper_adj through column
// level - 1 of upper_row. `wide` selects the wide layout, whose pools live
// in `workspace` (`workspace_bytes` long, at least B * pool_bytes).
// `smem_bytes` and `pool_bytes` are the caller's counts of a block's
// shared memory and a query's workspace slice, which must equal the
// layout's.
extern "C" int vss_beam_search(const float* q, const float* qn,
                               const void* table, const int32_t* adj,
                               const int32_t* upper_row, const void* allow,
                               float* cand_d, int32_t* cand_i, float* res_d,
                               int32_t* res_i, int64_t* counters,
                               void* workspace, int B, int ef, int E, int fan,
                               int d, int dtype, int metric, int max_iters,
                               int level, int lmax, int dual, int use_history,
                               int wide, int64_t smem_bytes,
                               int64_t pool_bytes, int64_t workspace_bytes,
                               void* stream) {
  using namespace vss;
  if (B <= 0) return 0;
  BeamArgs a;
  a.q = q, a.qn = qn, a.table = table, a.adj = adj, a.upper_row = upper_row;
  a.allow = static_cast<const uint8_t*>(allow);
  a.cand_d = cand_d, a.cand_i = cand_i, a.res_d = res_d, a.res_i = res_i;
  a.counters = reinterpret_cast<unsigned long long*>(counters);
  a.workspace = static_cast<unsigned char*>(workspace);
  a.ef = ef, a.E = E, a.fan = fan, a.d = d, a.metric = metric;
  a.max_iters = max_iters, a.level_col = level - 1, a.lmax = lmax;
  a.P = 0, a.log2p = 0, a.hist_len = 0, a.group = 1, a.rank_lanes_log2 = 0;
  a.vec = false;
  a.dual = dual != 0, a.use_history = use_history != 0, a.wide = wide != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8)
    return launch_beam<int8_t>(a, B, smem_bytes, pool_bytes, workspace_bytes, s);
  if (dtype == BF16)
    return launch_beam<__nv_bfloat16>(a, B, smem_bytes, pool_bytes,
                                      workspace_bytes, s);
  return launch_beam<float>(a, B, smem_bytes, pool_bytes, workspace_bytes, s);
}

// A block's shared-memory bytes and a query's workspace bytes for a shape
// and layout ({-1, -1} for a shape the kernel does not take): the layout's
// own counts, which `beam_smem_bytes` and `beam_pool_bytes` mirror.
extern "C" void vss_beam_layout_bytes(int ef, int E, int fan, int d,
                                      int max_iters, int dual, int use_history,
                                      int wide, int64_t* out) {
  using namespace vss;
  BeamArgs a = {};
  a.ef = ef, a.E = E, a.fan = fan, a.d = d, a.max_iters = max_iters;
  a.dual = dual != 0, a.use_history = use_history != 0, a.wide = wide != 0;
  int threads = 0;
  bool ok = false;
  const BeamLayout L = plan<float>(a, threads, ok);
  out[0] = ok ? L.total : -1;
  out[1] = ok ? L.pool_total : -1;
}
