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
// barriers. At wide rows the batch's distinct rows, counted, are 355,000
// of 960 B (gist1m's serving call, 69 iterations, 1,822 rows scored a
// query) and 277,000 of 1,536 B (openai1m's, 81 iterations, 1,703 rows),
// 0.10 and 0.13 ms of bytes; scoring a row a warp with each lane's chunks
// loaded one after another, 4 rows a round, and the query read at 4-way
// bank conflicts, the kernel took 1.06 and 1.44 ms there. Design:
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
//   * rows under 512 bytes (d=128 int8) are scored by gather.cuh's
//     `score_row`, K1's scorer with K1's lane grouping, so a distance
//     equals K1's bit for bit, with direct loads: each group of lanes
//     loads its row from device memory as K1 does, 32/G rows per warp in
//     flight, so the four warps of a 128-thread block keep 16 rows of
//     128 B in flight. Such a row has fewer than 32 chunks, so K1's
//     grouping gives it less than a warp and `score_row_wide`, which
//     scores a row a warp, cannot keep its distances bit-equal there;
//   * rows of 512 bytes or more (a whole warp a row, K1's grouping) take
//     the staged route (kStaged): the live slots take positions as they
//     are counted, each live row is one bulk copy into shared memory, all
//     of a phase's copies in flight together and announced to one
//     mbarrier, so the scoring waits for one round trip instead of one per
//     chunk and round; a phase holds as many rows as fit kStageBudget
//     beside the rest, so that 4 blocks stay resident (31 rows of 1,536 B,
//     all 32 of 960 B), and at least one. Where even one row would take
//     the block past kMaxSmem the rows keep direct loads, so the route
//     refuses no shape that direct loads take. A warp then scores a row
//     from shared memory with `score_row_wide`: the same chunks per lane,
//     multiply-adds and shuffle tree as `score_row` (distances equal bit
//     for bit), the query interleaved so that a warp's reads of it meet no
//     bank conflict, and int8 decoded without the conversion unit. Staging
//     was timed against direct loads from 512-B to 64-KB rows and was
//     faster at every width, down to one row a phase. Loads hoisted into
//     registers instead (8 rows x 2 chunks a lane) took 162 registers and
//     3 blocks a SM, and were slower than the parent;
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
#include "cpasync.cuh"
#include "gather.cuh"

namespace vss {

constexpr int kMaxSmem = 232448;      // 227 KB: the most a block may have
constexpr int kMinThreads = 128;      // a block's threads, at least
// and at most: 256 threads of at most 255 registers each fit an SM's
// 65,536 whatever the compiler allots (one thread per slot at 1,024
// threads of 110 registers was refused: too many resources requested for
// launch). Past it the threads stride over the slots.
constexpr int kMaxThreads = 256;
// Shared memory a block of the staged route fills with rows, at most: an
// SM's 233,472 bytes shared by 4 blocks, less the 1 KB each reserves, so
// that 4 blocks stay resident (a batch of 512 queries on 132 SMs runs in
// one wave).
constexpr int kStageBudget = 233472 / 4 - 1024;

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
  int row_bytes, nbuf;  // the staged route's rows: bytes each, rows a phase
};

// Byte offsets of a block's buffers. The shared layout keeps all of them in
// shared memory, in this order. The wide layout moves the pools (ckey, cid,
// rkey, rid, cflag) and the history to the block's slice of the workspace,
// in the same order, and keeps the rest in shared memory. `total` is a
// block's shared memory, `pool_total` a query's workspace bytes (0 in the
// shared layout). The staged route (`row_bytes` > 0) adds the position ->
// slot map of the live rows, the rows' mbarrier and `nbuf` rows. The
// Python wrapper mirrors this arithmetic (`beam_smem_bytes`,
// `beam_pool_bytes`) to pick a layout and to refuse a shape before
// launching.
struct BeamLayout {
  int qs, ckey, cid, rkey, rid, hist, nid, nd, red_key, red_pos, misc;
  int cflag, dup, okf, slot, bar, rows, total, pool_total;
};

inline __host__ __device__ BeamLayout beam_layout(int ef, int n, int P, int d,
                                                  int hist_len, bool dual,
                                                  bool wide, int row_bytes,
                                                  int nbuf) {
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
  L.slot = L.bar = L.rows = 0;
  if (row_bytes > 0) {
    o = (o + 3) / 4 * 4;
    L.slot = o, o += 4 * n;
    o = (o + 7) / 8 * 8;
    L.bar = o, o += 8;
    o = (o + 15) / 16 * 16;
    L.rows = o, o += nbuf * row_bytes;
  }
  L.total = (o + 15) / 16 * 16;
  L.pool_total = (g + 15) / 16 * 16;
  return L;
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
      const unsigned u = order_key(k, false);
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
  best.key = key_float(k);
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

template <typename T, bool kWide, bool kStride, bool kStaged>
__global__ void beam_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t b = blockIdx.x;
  const int ef = a.ef, E = a.E, fan = a.fan, d = a.d, P = a.P;
  const int n = E * fan;  // neighbour slots of one iteration
  const BeamLayout L = beam_layout(ef, n, P, d, a.hist_len, a.dual, kWide,
                                   kStaged ? a.row_bytes : 0, a.nbuf);
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
  // the staged route: the live rows' slots by position, the rows, their
  // barrier and its phase; the query in `wide_query_pos`'s order
  int32_t* slot_of = reinterpret_cast<int32_t*>(smem + L.slot);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  unsigned char* rows = smem + L.rows;
  const int chunks = d / (16 / static_cast<int>(sizeof(T)));
  int phase = 0;

  if (kStaged && tid == 0) {
    mbar_init(bar, nt);
    mbar_init_fence();
  }
  for (int e = tid; e < d; e += nt)
    qs[kStaged ? wide_query_pos<T>(e, chunks) : e] = a.q[b * d + e];
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
      if (kStaged) {
        // each live slot's position among the live rows
        int pos = 0;
        if ((tid & 31) == 0 && live != 0) pos = atomicAdd(live_count, __popc(live));
        pos = __shfl_sync(0xffffffffu, pos, 0) +
              __popc(live & ((1u << (tid & 31)) - 1u));
        if (id >= 0) slot_of[pos] = s;
      } else if ((tid & 31) == 0 && live != 0) {
        atomicAdd(live_count, __popc(live));
      }
      const bool ok = a.dual && id >= 0 && a.allow[id] != 0;
      if (s0 == 0)
        my_ok = ok;
      else if (s < n)
        okf[s] = ok ? 1 : 0;
      if (!kStride) break;  // one slot a thread: a single pass
    }
    __syncthreads();  // nid is final

    // ---- score the survivors against the query (K1's work)
    if (kStaged) {
      // the live rows, nbuf a phase: one bulk copy each into shared
      // memory, all in flight together, announced to one mbarrier; then a
      // warp a row
      const int live = *live_count, rb = a.row_bytes;
      const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
      for (int s = tid; s < n; s += nt)
        if (nid[s] < 0) nd[s] = CUDART_INF_F;
      for (int p0 = 0; p0 < live; p0 += a.nbuf) {
        const int cnt = live - p0 < a.nbuf ? live - p0 : a.nbuf;
        if (tid < cnt) {
          mbar_expect_tx(bar, static_cast<unsigned>(rb));
          bulk_copy(rows + tid * rb, table + static_cast<int64_t>(nid[slot_of[p0 + tid]]) * d,
                    static_cast<unsigned>(rb), bar);
        } else {
          mbar_arrive(bar);
        }
        mbar_wait(bar, phase);
        phase ^= 1;
        for (int r0 = 0; r0 < cnt; r0 += nw) {
          const int r = r0 + warp;
          float dot, xn;
          score_row_wide<T>(r < cnt ? reinterpret_cast<const T*>(rows + r * rb) : nullptr, qs,
                            chunks, lane, dot, xn);
          if (lane == 0 && r < cnt) nd[slot_of[p0 + r]] = epilogue(dot, qnb, xn, a.metric);
        }
        if (p0 + cnt < live) __syncthreads();  // the rows are read: the next phase may land
      }
    } else {
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
      const unsigned ck = order_key(mine, false);
      const unsigned rk = order_key(mine_ok ? mine : CUDART_INF_F, false);
      int rank = 0, rrank = 0;
      if (mine_in) {
        for (int j = rank_lane; j < n; j += 1 << rl) {
          const float v = nd[j];
          const unsigned kj = order_key(v, false);
          rank += (kj < ck || (kj == ck && j < rank_of)) ? 1 : 0;
          if (a.dual) {
            const unsigned rj = okf[j] ? kj : order_key(CUDART_INF_F, false);
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

// Whether a row takes the staged route: 16-byte loads and at least 32
// chunks (512 bytes), where a row has a whole warp to itself.
template <typename T>
bool staged_rows(const BeamArgs& a) {
  return a.vec && a.d / (16 / static_cast<int>(sizeof(T))) >= 32;
}

// Fills the derived fields of `a` (P, hist_len, group, vec, row_bytes,
// nbuf) and the block's thread count: one thread per neighbour slot, at
// least kMinThreads and at most kMaxThreads (then the threads stride over
// the slots), whole warps. The staged route takes as many rows a phase as
// fit kStageBudget beside the rest of the layout, at least one and at most
// a step's slots, and is not taken where that layout passes kMaxSmem.
// Returns the layout, or sets `ok` false for a shape the kernel does not
// take.
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
  const int64_t row_bytes =
      staged_rows<T>(a) ? static_cast<int64_t>(a.d) * sizeof(T) : 0;
  // the sizes as 64-bit sums first: the layout's ints must not overflow
  const int64_t rough = 4LL * a.d + (a.dual ? 17 : 9) * P + 4 * hist_len +
                        10LL * n + 288 +
                        (row_bytes ? 4 * n + 24 + row_bytes + kStageBudget : 0);
  if (rough > (1LL << 30)) return L;
  a.P = static_cast<int>(P);
  a.hist_len = static_cast<int>(hist_len);
  a.row_bytes = static_cast<int>(row_bytes);
  a.nbuf = 0;
  if (row_bytes) {
    const BeamLayout base = beam_layout(a.ef, static_cast<int>(n), a.P, a.d,
                                        a.hist_len, a.dual, a.wide, a.row_bytes, 0);
    const int64_t fit = (kStageBudget - base.rows) / row_bytes;
    a.nbuf = static_cast<int>(fit < 1 ? 1 : fit > n ? n : fit);
    // past a block's shared memory: the rows keep direct loads
    if (base.rows + static_cast<int64_t>(a.nbuf) * row_bytes > kMaxSmem)
      a.row_bytes = 0, a.nbuf = 0;
  }
  ok = true;
  return beam_layout(a.ef, static_cast<int>(n), a.P, a.d, a.hist_len, a.dual,
                     a.wide, a.row_bytes, a.nbuf);
}

template <typename T, bool kWide, bool kStride, bool kStaged>
int launch_kernel(const BeamArgs& a, int B, int threads, int smem,
                  cudaStream_t s) {
  auto kernel = beam_kernel<T, kWide, kStride, kStaged>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kStaged>
int launch_layout(const BeamArgs& a, int B, int threads, int smem,
                  cudaStream_t s) {
  const bool stride = a.E * a.fan > threads;
  if (a.wide)
    return stride ? launch_kernel<T, true, true, kStaged>(a, B, threads, smem, s)
                  : launch_kernel<T, true, false, kStaged>(a, B, threads, smem, s);
  return stride ? launch_kernel<T, false, true, kStaged>(a, B, threads, smem, s)
                : launch_kernel<T, false, false, kStaged>(a, B, threads, smem, s);
}

// `smem_expected` and `pool_expected` are the wrapper's own counts of a
// block's shared memory and a query's workspace bytes (`beam_smem_bytes`,
// `beam_pool_bytes`, by which it picks the layout and refuses a shape
// before launching): counts that differ from the layout's are refused
// here, as is a workspace smaller than B queries' slices.
template <typename T>
int launch_beam(BeamArgs a, int B, int64_t smem_expected,
                int64_t pool_expected, int64_t workspace_bytes,
                int* staged, cudaStream_t s) {
  int threads = 0;
  bool ok = false;
  const BeamLayout L = plan<T>(a, threads, ok);
  if (!ok || L.total > kMaxSmem || L.total != smem_expected ||
      L.pool_total != pool_expected ||
      static_cast<int64_t>(B) * L.pool_total > workspace_bytes ||
      (a.wide && a.workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  *staged = a.row_bytes > 0 ? 1 : 0;
  return *staged ? launch_layout<T, true>(a, B, threads, L.total, s)
                 : launch_layout<T, false>(a, B, threads, L.total, s);
}

}  // namespace vss

// The pools arrive seeded and sorted in cand_* / res_* and leave in the
// same buffers; the three counters must be zero on entry. `level` 0 walks
// adj0 (`adj`, fan-out `fan`), level >= 1 walks upper_adj through column
// level - 1 of upper_row. `wide` selects the wide layout, whose pools live
// in `workspace` (`workspace_bytes` long, at least B * pool_bytes).
// `smem_bytes` and `pool_bytes` are the caller's counts of a block's
// shared memory and a query's workspace slice, which must equal the
// layout's. `staged` is set to 1 where the launch takes the staged route
// (rows of 512 bytes or more), else 0.
extern "C" int vss_beam_search(const float* q, const float* qn,
                               const void* table, const int32_t* adj,
                               const int32_t* upper_row, const void* allow,
                               float* cand_d, int32_t* cand_i, float* res_d,
                               int32_t* res_i, int64_t* counters,
                               void* workspace, int* staged, int B, int ef,
                               int E, int fan, int d, int dtype, int metric,
                               int max_iters, int level, int lmax, int dual,
                               int use_history,
                               int wide, int64_t smem_bytes,
                               int64_t pool_bytes, int64_t workspace_bytes,
                               void* stream) {
  using namespace vss;
  *staged = 0;
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
  a.vec = false, a.row_bytes = 0, a.nbuf = 0;
  a.dual = dual != 0, a.use_history = use_history != 0, a.wide = wide != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8)
    return launch_beam<int8_t>(a, B, smem_bytes, pool_bytes, workspace_bytes,
                               staged, s);
  if (dtype == BF16)
    return launch_beam<__nv_bfloat16>(a, B, smem_bytes, pool_bytes,
                                      workspace_bytes, staged, s);
  return launch_beam<float>(a, B, smem_bytes, pool_bytes, workspace_bytes,
                            staged, s);
}

// A block's shared-memory bytes and a query's workspace bytes for a shape,
// layout and tape dtype ({-1, -1} for a shape the kernel does not take):
// the layout's own counts, which `beam_smem_bytes` and `beam_pool_bytes`
// mirror.
extern "C" void vss_beam_layout_bytes(int ef, int E, int fan, int d,
                                      int max_iters, int dual, int use_history,
                                      int wide, int dtype, int64_t* out) {
  using namespace vss;
  BeamArgs a = {};
  a.ef = ef, a.E = E, a.fan = fan, a.d = d, a.max_iters = max_iters;
  a.dual = dual != 0, a.use_history = use_history != 0, a.wide = wide != 0;
  int threads = 0;
  bool ok = false;
  const BeamLayout L = dtype == I8     ? plan<int8_t>(a, threads, ok)
                       : dtype == BF16 ? plan<__nv_bfloat16>(a, threads, ok)
                                       : plan<float>(a, threads, ok);
  out[0] = ok ? L.total : -1;
  out[1] = ok ? L.pool_total : -1;
}
