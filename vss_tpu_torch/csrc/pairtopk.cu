// pairwise_topk: the stable k smallest distances of each query over a
// whole tape in one call: K4's tile loop with the exact oracle's selection
// inside, so that no [nq, nx] distance block reaches device memory.
//
// Replaces vss_tpu/ops/distance.py:113 `_pairwise_kernel` (K4) together
// with the XLA step that follows it in the oracle's chunked scan,
// vss_tpu/ops/topk.py:62-100: the chunk's distances, the tombstone mask,
// NaN as +inf, and the stable merge of the chunk's k least into the
// running best. The port's route before this kernel was K4 (distance.cu)
// on each chunk, then select_k (selectk.cu) with the mask and NaN
// options, then the stable merge (ops/topk.py); this kernel gives that
// route's distances and ids bit for bit:
//   * distances with K4's bits: each is one fmaf chain over the columns in
//     ascending order from 0 (tape value times query value), the squared
//     norms fmaf chains in the same order, then common.cuh's `epilogue`;
//     zero-padded columns add +0;
//   * selectk.cu's order, from selectk.cuh: the composite key << 32 | row
//     is unique, so the k least composites are one set however the rows
//     are split among blocks. Tombstoned rows, rows past the tape and NaN
//     or +inf distances are never candidates: the route gives them as
//     (+inf, -1), and so does this kernel once a query has fewer than k
//     other rows. A distance comes back as the float of its key (the
//     epilogue never gives -0, the one value that shares its key), and its
//     id is -1 unless it is finite, as the route's final `torch.where`.
//
// Bound on the H100: 2 nq nx d FLOP of f32 products at the f32 SIMT
// pipes' 67 TFLOP/s (TF32 on the tensor cores is not exact, and the oracle
// is), against (nq + nx) d 4 bytes read: at 512 x 10^6 x 128, 1.96 ms of
// operations and 0.15 ms of bytes. K4 then select_k also wrote and read
// back a [nq, chunk] block (1 GiB a 524,288-row chunk). Design:
//   * a block scores 128 queries against a slab of consecutive 128-row
//     tiles of the tape (the grid: query tiles fastest, then slabs; the
//     wrapper picks about two blocks an SM, so a tile is read from device
//     memory about once); 256 threads, each with 16 x 4 f32 accumulators:
//     rows r + 8 i and queries c + 32 j of the tile, r = tid % 8, c = tid /
//     8, so each query's 128 distances of a tile sit in the 8 lanes of one
//     quarter warp;
//   * the loop streams 16 columns of the tile's rows and queries a step
//     through a ring of three stages in shared memory, by cp.async (16
//     bytes a copy, zero-filled past the tape and the queries), two steps
//     ahead across tile boundaries: a step's FMAs, and a tile's selection,
//     run while the next two steps' copies land, with one barrier a step.
//     Staged rows stay in row-major order, 20 floats apart, so a thread
//     reads 4 columns of a row or a query as one 16-byte load and no two
//     lanes of a quarter warp meet in a bank. The tile's mask bits and
//     bounds are read at its start, so that its FMAs hide the wait;
//   * the epilogue is the filter. Each warp owns 16 queries and selects
//     for them alone, with no block barrier, one pass per 4 of them. A
//     distance is compared with the float of the query's threshold T; a
//     warp none of whose values can pass ends the pass there. Survivors
//     are appended to the query's list, each lane's slots from a prefix
//     over its quarter warp;
//   * the cut: when a list could overflow in the next tile, or first holds
//     k entries, the warp keeps its k least (in no order) and T becomes the
//     k-th, found by a radix select over the composites (8 bits a pass from
//     the first bit in which they differ, a histogram in shared memory),
//     not a sort;
//   * the shared-memory budget: 128 queries' lists of k + 128 entries
//     would take 384 KB at k = 256, above the 227 KB a block may have. So
//     the lists live in a workspace in device memory (L2-resident; k
//     rounded up to 32, plus two tiles' 256 entries a list, whatever the
//     data), and shared memory holds the ring (60 KB), each query's T, bound
//     and count, and one 4 KB cut buffer and 1 KB histogram a warp: 104 KB,
//     two blocks an SM;
//   * the slabs of a query share a bound: every cut that sets T lowers the
//     query's minimum in device memory (atomicMin), and each tile reads it
//     back. A row among the k least of the whole tape is below every
//     slab's k-th, so it passes any such bound; what the lists hold beyond
//     those rows depends on the blocks' timing, the result does not;
//   * a second launch, one block a query, takes the k least of the slabs'
//     lists (laid out by slab, in ascending row order) with selectk.cuh's
//     filter and writes the distances and ids. Two launches and a memset a
//     call, no host sync.
// Measured on the H100 (chip_smoke.py, PERF.md): at 512 x 10^6 x 128 the
// kernel takes about three times its bound, near the K4 route at k = 100,
// faster below it and slower above: its FMA loop runs at about K4's rate,
// and with a threshold per slab most passes at k = 100 find a survivor. A
// bound shared between slabs that is cheap to read is the next lever.
#include "common.cuh"
#include "cpasync.cuh"
#include "selectk.cuh"

namespace vss {

constexpr int kPtRows = 128;            // tape rows a tile
constexpr int kPtQueries = 128;         // queries a block
constexpr int kPtCols = 16;             // columns a step
constexpr int kPtStride = kPtCols + 4;  // floats from one staged row to the next
constexpr int kPtStages = 3;            // the ring's stages
constexpr int kPtThreads = 256;
constexpr int kPtWarps = kPtThreads / 32;
constexpr int kPtCut = 512;   // a warp's cut buffer: at least pt_cap(kSkMaxK)
constexpr int kPtBins = 256;  // a radix pass's bins (8 bits)

// A list's capacity: k rounded up to 32, and two tiles' survivors (a list
// is cut before a tile that could overflow it, so a cut takes in at least
// one tile's worth of entries).
__host__ __device__ __forceinline__ int pt_cap(int k) {
  return (k + 31) / 32 * 32 + 2 * kPtRows;
}

struct PtArgs {
  const float* q;        // [nq, d]
  const float* x;        // [nx, d]
  const uint8_t* valid;  // [nx] bool, or null
  u64* lists;            // [nq, slabs, cap]: a query's list in each slab
  u64* bound;            // [nq]: the least threshold of the query's slabs
  float* dists;          // [nq, k]
  int32_t* ids;          // [nq, k]
  int64_t nx, slab_rows;
  int nq, d, metric, k, slabs, cap, q_tiles;
};

struct PtSmem {
  float xs[kPtStages][kPtRows][kPtStride];     // staged tape rows
  float qs[kPtStages][kPtQueries][kPtStride];  // staged queries
  float xn[kPtRows];                           // the tile's squared row norms
  float qn[kPtQueries];                        // squared query norms
  u64 tl[kPtQueries];   // a query's threshold in this slab (kNone: not set)
  u64 gb[kPtQueries];   // its bound over the slabs, read for this tile
  int cnt[kPtQueries];  // entries in its list
  u64 cut[kPtWarps][kPtCut];
  int hist[kPtWarps][kPtBins];
};
static_assert(kPtRows == kPtQueries, "threads 0..127 stage a row and read a query's bound");
static_assert(kPtBins == 8 * 32, "a lane scans 8 bins");

__device__ __forceinline__ u64 pt_composite(float v, int64_t row) {
  return (static_cast<u64>(order_key(v, false)) << 32) | static_cast<unsigned>(row);
}

// The t-th of warp w's 16 queries (t = 0..15): 4 w + t % 4 + 32 (t / 4).
__device__ __forceinline__ int pt_warp_query(int w, int t) { return 4 * w + (t & 3) + 32 * (t >> 2); }

__device__ __forceinline__ u64* pt_list(const PtArgs& a, int gq, int slab) {
  return a.lists + (static_cast<int64_t>(gq) * a.slabs + slab) * a.cap;
}

// Issue the copies of one step into stage `buf`: 16 columns from k0 of
// the 128 rows from row0 and of the 128 queries from q0, four 16-byte
// copies a row, four a thread.
__device__ __forceinline__ void pt_issue(const PtArgs& a, PtSmem& s, int buf, int64_t row0,
                                         int q0, int k0) {
#pragma unroll
  for (int u0 = 0; u0 < 8 * kPtRows; u0 += kPtThreads) {
    const int u = u0 + static_cast<int>(threadIdx.x);
    const int part = u & 3;
    bool live;
    const float* src;
    float* dst;
    if (u0 < 4 * kPtRows) {
      const int lr = u >> 2;
      const int64_t row = row0 + lr;
      live = row < a.nx;
      src = a.x + (live ? row : 0) * a.d + k0 + 4 * part;
      dst = &s.xs[buf][lr][4 * part];
    } else {
      const int lq = (u - 4 * kPtRows) >> 2;
      live = q0 + lq < a.nq;
      src = a.q + static_cast<int64_t>(live ? q0 + lq : 0) * a.d + k0 + 4 * part;
      dst = &s.qs[buf][lq][4 * part];
    }
    cp_async16(dst, src, live ? 16 : 0);
  }
}

__device__ __forceinline__ u64 warp_or(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned lo = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v), o);
    const unsigned hi = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v >> 32), o);
    v |= (static_cast<u64>(hi) << 32) | lo;
  }
  return v;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned lo = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v), o);
    const unsigned hi = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v >> 32), o);
    const u64 w = (static_cast<u64>(hi) << 32) | lo;
    v = w > v ? w : v;
  }
  return v;
}

// e >> b for b in 0 .. 64
__device__ __forceinline__ u64 high_bits(u64 e, int b) { return b >= 64 ? 0ull : e >> b; }

// The warp's cut of query lq's list (its global index gq): once the list
// holds more than k entries, it keeps its k least (in no order), and once
// it holds k, T is the k-th least and the query's bound takes it. The k-th
// is found by a radix select over the composites, copied to the warp's
// buffer: 8 bits a pass from the first bit in which they differ, counted
// in a histogram in shared memory, until the bin that holds the k-th holds
// no entry above it. The whole warp calls it, on a condition alike in
// every lane.
__device__ __forceinline__ void pt_cut(const PtArgs& a, PtSmem& s, int lq, int gq, int slab) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  u64* buf = s.cut[warp];
  int* hist = s.hist[warp];
  u64* list = pt_list(a, gq, slab);
  const int n = s.cnt[lq];
  if (n < a.k) return;
  // the list into the buffer, four loads a lane in flight; the bits in
  // which all entries agree are those their OR and their AND share
  u64 ors = 0, ands = ~0ull;
  for (int i0 = 0; i0 < n; i0 += 4 * 32) {
    u64 e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      e[u] = i < n ? __ldcg(list + i) : kNone;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i < n) {
        buf[i] = e[u];
        ors |= e[u];
        ands &= e[u];
      }
    }
  }
  ors = warp_or(ors);
  ands = ~warp_or(~ands);
  const u64 diff = ors ^ ands;
  __syncwarp();
  // entries at or below `prefix` in their bits from `shift` up are kept
  u64 prefix = ands;
  int shift = diff == 0 ? 0 : 64 - __clzll(diff);  // the bits from here up are all alike
  int kr = a.k;  // the rank of the k-th among the entries that match the prefix so far
  const bool all = n == a.k;
  while (!all && shift > 0) {
    const int width = shift < 8 ? shift : 8;
    shift -= width;
    for (int b = lane; b < kPtBins; b += 32) hist[b] = 0;
    __syncwarp();
    for (int i0 = 0; i0 < n; i0 += 4 * 32) {
      u64 e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        e[u] = i < n ? buf[i] : kNone;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < n && high_bits(e[u] ^ prefix, shift + width) == 0)
          atomicAdd(&hist[(e[u] >> shift) & ((1u << width) - 1u)], 1);
      }
    }
    __syncwarp();
    // the bin that holds rank kr: lane l scans bins 8 l .. 8 l + 7
    int cnt[8], sum = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      cnt[t] = hist[8 * lane + t];
      sum += cnt[t];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum, digit = -1, under = 0, in_bin = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (digit < 0 && run < kr && kr <= run + cnt[t]) {
        digit = 8 * lane + t;
        under = run;
        in_bin = cnt[t];
      }
      run += cnt[t];
    }
    const int owner = __ffs(__ballot_sync(0xffffffffu, digit >= 0)) - 1;
    digit = __shfl_sync(0xffffffffu, digit, owner);
    under = __shfl_sync(0xffffffffu, under, owner);
    in_bin = __shfl_sync(0xffffffffu, in_bin, owner);
    kr -= under;
    prefix = (prefix & ~(static_cast<u64>((1u << width) - 1u) << shift)) |
             (static_cast<u64>(digit) << shift);
    __syncwarp();  // every lane has read the bins before the next pass clears them
    if (in_bin == kr) break;
  }
  const u64 top = high_bits(prefix, shift);
  int base = 0;
  u64 tmax = 0;
  for (int i0 = 0; i0 < n; i0 += 4 * 32) {
    u64 e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      e[u] = i < n ? buf[i] : kNone;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      const bool keep = i < n && (all || high_bits(e[u], shift) <= top);
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        list[base + __popc(bal & below)] = e[u];
        tmax = e[u] > tmax ? e[u] : tmax;
      }
      base += __popc(bal);
    }
  }
  tmax = warp_max(tmax);
  if (lane == 0) {
    s.cnt[lq] = a.k;
    s.tl[lq] = tmax;
    atomicMin(a.bound + gq, tmax);
  }
  __syncwarp();
}

// The tile's selection: its 128 x 128 distances from the accumulators and
// the norms, filtered into the lists of the warp's 16 queries (lane
// quarters h = 0..3 hold queries 4 w + h + 32 j of warp w, one j a
// pass). The passes are one loop, not unrolled, that takes column 0 of the
// accumulators and shifts the others down (it leaves them spent), so that
// the tile's code and its live registers stay few: unrolled, the eight
// passes of an 8 x 8 tile spilled registers into the FMA loop and tripled
// its time. Cuts run after the passes, and only in a tile in which the
// warp appended: each list that could overflow in the next tile (more
// than cap - 128 entries), or that first holds k entries, is cut.
__device__ __forceinline__ void pt_filter(const PtArgs& a, PtSmem& s, float (&acc)[16][4],
                                          unsigned ok, int64_t row0, int q0, int slab) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid & 7, c = tid >> 3;
  bool appended = false;
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    const int lq = c + 32 * j;
    const int gq = q0 + lq;
    const bool live = gq < a.nq;
    const u64 g = s.gb[lq];
    const u64 tl = s.tl[lq];
    const u64 T = tl < g ? tl : g;
    // a value below T's float is below T; one equal to it is decided by
    // the row; any value below +inf passes while T is not set
    const float tf = T == kNone ? CUDART_INF_F : key_float(static_cast<unsigned>(T >> 32));
    const float qn = s.qn[lq];
    float v[16];
    bool maybe = false;  // a value of this lane that could pass
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = epilogue(acc[i][0], qn, s.xn[r + 8 * i], a.metric);
      maybe |= ((ok >> i) & 1u) && v[i] < CUDART_INF_F && !(v[i] > tf);
    }
    // once T is set, the passes of a warp without a survivor end here
    if (__any_sync(0xffffffffu, live && maybe)) {
      appended = true;
      unsigned take = 0;  // bit i: value i passes
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool p = live && ((ok >> i) & 1u) && v[i] < CUDART_INF_F &&
                       (v[i] < tf || (v[i] == tf && pt_composite(v[i], row0 + r + 8 * i) < T));
        take |= static_cast<unsigned>(p) << i;
      }
      // each lane's slots: a prefix over the 8 lanes of its quarter warp
      const int mine = __popc(take);
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if ((lane & 7) >= o) incl += y;
      }
      const int total = __shfl_sync(0xffffffffu, incl, lane | 7);
      const int base = s.cnt[lq];
      if (take != 0) {
        u64* list = pt_list(a, gq, slab);
        int pos = base + incl - mine;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if ((take >> i) & 1u) list[pos++] = pt_composite(v[i], row0 + r + 8 * i);
      }
      __syncwarp();  // every lane has read the count
      if ((lane & 7) == 0 && live) s.cnt[lq] = base + total;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) acc[i][jj] = acc[i][jj + 1];
  }
  if (!appended) return;  // alike in every lane: the passes' votes are the warp's
  __syncwarp();
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const int lq = pt_warp_query(warp, t);
    if (q0 + lq < a.nq && (s.cnt[lq] > a.cap - kPtRows || (s.tl[lq] == kNone && s.cnt[lq] >= a.k)))
      pt_cut(a, s, lq, q0 + lq, slab);
  }
}

__global__ void __launch_bounds__(kPtThreads, 2) pairwise_topk_kernel(PtArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  PtSmem& s = *reinterpret_cast<PtSmem*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid & 7, c = tid >> 3;
  const int q0 = static_cast<int>(blockIdx.x % a.q_tiles) * kPtQueries;
  const int slab = static_cast<int>(blockIdx.x / a.q_tiles);
  const int64_t r0 = static_cast<int64_t>(slab) * a.slab_rows;
  const int64_t r1 = r0 + a.slab_rows < a.nx ? r0 + a.slab_rows : a.nx;
  const int tiles = r1 > r0 ? static_cast<int>((r1 - r0 + kPtRows - 1) / kPtRows) : 0;
  const int ksteps = a.d / kPtCols;
  const int steps = tiles * ksteps;
  for (int i = tid; i < kPtQueries; i += kPtThreads) {
    s.tl[i] = kNone;
    s.cnt[i] = 0;
  }
  __syncthreads();  // a slab past the tape's end runs no step, and its barrier
#pragma unroll
  for (int p = 0; p < kPtStages - 1; ++p) {
    if (p < steps)
      pt_issue(a, s, p, r0 + static_cast<int64_t>(p / ksteps) * kPtRows, q0,
               (p % ksteps) * kPtCols);
    cp_async_commit();
  }
  float acc[16][4];
  int st = 0;  // the step: tile st / ksteps, columns (st % ksteps) * 16 ..
  for (int tile = 0; tile < tiles; ++tile) {
    const int64_t row0 = r0 + static_cast<int64_t>(tile) * kPtRows;
    // read now, used after the tile's FMAs, which hide the wait
    unsigned ok = 0;  // bit i: row r + 8 i of the tile is in the tape and valid
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int64_t row = row0 + r + 8 * i;
      if (row < a.nx && (a.valid == nullptr || a.valid[row] != 0)) ok |= 1u << i;
    }
    const u64 gb = tid < kPtQueries && q0 + tid < a.nq ? __ldcg(a.bound + q0 + tid) : kNone;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    float sq = 0.0f;
    for (int ks = 0; ks < ksteps; ++ks, ++st) {
      cp_async_wait<kPtStages - 2>();
      __syncthreads();  // step st has landed; every thread is done with step st - 1
      const int nxt = st + kPtStages - 1;
      if (nxt < steps)
        pt_issue(a, s, nxt % kPtStages, r0 + static_cast<int64_t>(nxt / ksteps) * kPtRows, q0,
                 (nxt % ksteps) * kPtCols);
      cp_async_commit();
      const int buf = st % kPtStages;
      {
        // the squared norm of the row (threads 0..127) or query (128..255)
        // this thread stages
        const float* own = tid < kPtRows ? s.xs[buf][tid] : s.qs[buf][tid - kPtRows];
#pragma unroll
        for (int e = 0; e < kPtCols; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(own + e);
          sq = fmaf(f.x, f.x, sq);
          sq = fmaf(f.y, f.y, sq);
          sq = fmaf(f.z, f.z, sq);
          sq = fmaf(f.w, f.w, sq);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kPtCols; kk += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(&s.qs[buf][c + 32 * j][kk]);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(&s.xs[buf][r + 8 * i][kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float t = acc[i][j];
            t = fmaf(av.x, b[j].x, t);
            t = fmaf(av.y, b[j].y, t);
            t = fmaf(av.z, b[j].z, t);
            t = fmaf(av.w, b[j].w, t);
            acc[i][j] = t;
          }
        }
      }
    }
    if (tid < kPtRows) {
      s.xn[tid] = sq;
      s.gb[tid] = gb;
    } else {
      s.qn[tid - kPtRows] = sq;
    }
    __syncthreads();
    pt_filter(a, s, acc, ok, row0, q0, slab);
  }
  cp_async_wait<0>();
  // each list cut to its k least (in no order), empty slots after them
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const int lq = pt_warp_query(warp, t);
    if (q0 + lq >= a.nq) continue;
    pt_cut(a, s, lq, q0 + lq, slab);
    u64* list = pt_list(a, q0 + lq, slab);
    for (int i = s.cnt[lq] + lane; i < a.k; i += 32) list[i] = kNone;
  }
  __syncthreads();
}

// The lists of one query, slab after slab: entry p is entry p % k of slab
// p / k's list.
struct SlabLists {
  typedef u64 Raw;
  const u64* lists;
  int k, cap;
  __device__ __forceinline__ int64_t pos(int64_t b0, int v) const {
    return b0 + v * kSkThreads + threadIdx.x;
  }
  __device__ __forceinline__ void load(int64_t b0, int64_t b1, u64 (&raw)[kSkPer]) const {
#pragma unroll
    for (int v = 0; v < kSkPer; ++v) {
      const int64_t p = pos(b0, v);
      if (p < b1) raw[v] = lists[(p / k) * cap + p % k];
    }
  }
  __device__ __forceinline__ bool maybe(u64, float) const { return true; }
  __device__ __forceinline__ u64 key(u64 e, int64_t) const { return e; }
};

__global__ void __launch_bounds__(kSkThreads) pairwise_topk_merge(PtArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SelectKSmem& s = *reinterpret_cast<SelectKSmem*>(smem);
  const int64_t q = blockIdx.x;
  int n = 0;
  u64 T = kNone;
  const SlabLists src{a.lists + q * a.slabs * a.cap, a.k, a.cap};
  filter(s, src, 0, static_cast<int64_t>(a.slabs) * a.k, kSkTile, a.k, n, T);
  for (int i = threadIdx.x; i < a.k; i += kSkThreads) {
    const u64 e = i < n ? s.buf[i] : kNone;
    float v = CUDART_INF_F;
    int id = -1;
    if (e != kNone) {
      v = key_float(static_cast<unsigned>(e >> 32));
      if (isfinite(v)) id = static_cast<int>(e & 0xffffffffull);
    }
    a.dists[q * a.k + i] = v;
    a.ids[q * a.k + i] = id;
  }
}

}  // namespace vss

// Bytes of the workspace a call takes: each query's list in each slab, and
// each query's bound (-1 where the arguments are refused).
extern "C" int64_t vss_pairwise_topk_workspace_bytes(int nq, int slabs, int k) {
  using namespace vss;
  if (nq < 0 || slabs < 1 || k < 1 || k > kSkMaxK) return -1;
  return (static_cast<int64_t>(nq) * slabs * pt_cap(k) + nq) * 8;
}

// The k least distances (f32, ascending) and their ids (int32, -1 where
// the distance is not finite) of each query of q [nq, d] over the rows of
// x [nx, d] (both f32, contiguous, 16-byte aligned; d a multiple of 16:
// the wrapper pads the columns with zeros) that `valid` [nx] (bool, or
// null) keeps, as dists [nq, k] and ids [nq, k]. The tape is cut into
// `slabs` slabs of whole tiles, one block per 128 queries and slab; `ws`
// holds vss_pairwise_topk_workspace_bytes(nq, slabs, k) bytes. A shape the
// kernel does not take (k outside 1 .. 256, nx outside 1 .. 2^31 - 1,
// slabs outside 1 .. the tape's tiles, d not a positive multiple of 16, no
// workspace) is refused before anything is launched; nq = 0 launches
// nothing.
extern "C" int vss_pairwise_topk(const float* q, const float* x, const uint8_t* valid,
                                 float* dists, int32_t* ids, void* ws, int nq, int64_t nx,
                                 int d, int metric, int k, int slabs, void* stream) {
  using namespace vss;
  const int64_t tiles = (nx + kPtRows - 1) / kPtRows;
  const int64_t q_tiles = (static_cast<int64_t>(nq) + kPtQueries - 1) / kPtQueries;
  if (nq < 0 || nx < 1 || nx > 0x7fffffffLL || d < kPtCols || d % kPtCols != 0 ||
      metric < L2SQ || metric > IP || k < 1 || k > kSkMaxK || slabs < 1 || slabs > tiles ||
      ws == nullptr || q_tiles * slabs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PtArgs a;
  a.q = q, a.x = x, a.valid = valid, a.dists = dists, a.ids = ids;
  // slabs of whole tiles; as many as that leaves non-empty (at most `slabs`)
  const int64_t slab_tiles = (tiles + slabs - 1) / slabs;
  slabs = static_cast<int>((tiles + slab_tiles - 1) / slab_tiles);
  a.nx = nx, a.nq = nq, a.d = d, a.metric = metric, a.k = k, a.slabs = slabs;
  a.cap = pt_cap(k);
  a.q_tiles = static_cast<int>(q_tiles);
  a.slab_rows = slab_tiles * kPtRows;
  a.lists = static_cast<u64*>(ws);
  a.bound = a.lists + static_cast<int64_t>(nq) * slabs * a.cap;
  cudaError_t err = cudaMemsetAsync(a.bound, 0xff, sizeof(u64) * static_cast<size_t>(nq), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(pairwise_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(PtSmem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(pairwise_topk_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairwise_topk_kernel<<<static_cast<unsigned>(q_tiles * slabs), kPtThreads, sizeof(PtSmem),
                         st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pairwise_topk_merge<<<static_cast<unsigned>(nq), kSkThreads, sizeof(SelectKSmem), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
