// select_neighbors: the neighbour-selection heuristic of the write path and
// the bulk builder, one launch for a batch of A rows, one thread block per
// row.
//
// Replaces vss_tpu/index/select.py:select_neighbors (:35-105: the candidate
// sort, the `jnp.take` of the candidate rows, the [A, C, C] einsum and the
// C-step `fori_loop` of mask logic, then the top-m of the kept-first keys)
// together with the TPU kernel its gather reaches on the port's plain path,
// vss_tpu/ops/gather.py:_gather_kernel (:39, K5). For row r:
//   1. d[c] = cand_d[r, c], +inf where cand_i[r, c] < 0; positions C..m-1
//      (when C < m) are padding with id -1 and d +inf;
//   2. the positions sorted ascending by d as torch.sort(stable=True)
//      orders f32: every NaN after every number, -0 equal to +0, ties in
//      position order;
//   3. the candidate rows: tape row max(id, 0) (int8 / bf16 / f32), or row
//      [r, c] of the caller's cand_vecs;
//   4. in sorted order, candidate c is kept iff d[c] is finite, d[c] <
//      min over kept j of epilogue(dot(c, j), |c|^2, |j|^2) (torch.amin:
//      a NaN among them makes the minimum NaN, which rejects c) and fewer
//      than m are kept;
//   5. out[r] = the ids of the m least keys (kept: d; pruned finite:
//      d + 1e30; else +inf) by a stable sort, -1 where the key is not
//      finite; all -1 on a row whose `active` flag is false.
//
// Step 4 needs only distances to the kept candidates, and their minimum
// is the same in any order, so each candidate carries dmin, the least
// distance to the candidates kept so far: when candidate s is kept, the
// block scores it against every later candidate with a finite d and
// folds the result into their dmin. A rejection costs one read of dmin; a
// keep before the m-th one pass over the later rows (the m-th ends the
// row's decisions, and no pass follows it). The [C, C]
// matrix of the plain version is never formed.
//
// Bound on the H100: at the insert wave's shape (1,024 rows x 144
// candidates, m=16, int8 rows of 128 B) the candidate rows are 19 MB
// (6 us at 3.35 TB/s) and the dot products at most 1,024 x 144 x 16 x 128
// int8 multiply-adds (0.3 us at the card's int8 rate of 1,979 TOP/s; the
// f32 and bf16 rows' products run at the f32 rate, 67 TFLOP/s), so bytes
// bound it. What bounds a row
// is its chain of dependent decisions: 144 in sorted order, up to 16 of
// them followed by a pass over the later rows and two barriers. Blocks of
// different rows share nothing, so the card runs many rows' chains side by
// side. Design:
//   * one block of 128 threads per row; the candidates' ids, distances,
//     sorted order, norms and dmin in shared memory, and the candidate
//     rows too where they fit (the "shared" layout: 21 KB of int8 rows a
//     row at the wave's shape), copied in by all threads at once with
//     several 16-byte loads in flight each. Past a block's 227 KB the rows
//     are read from device memory and L2 at each use ("rows global");
//     past it even without the rows (several thousand candidates) the
//     per-candidate arrays move to a workspace in device memory that the
//     wrapper allocates ("all global"). The entry point picks the first
//     that fits (`select_layout`) and tells the wrapper the workspace's
//     size (vss_select_workspace_bytes). Every shape the plain version
//     takes is taken by one of the three;
//   * the sorts are rank counts: each thread ranks its candidates against
//     all others by (key, position), O(C^2 / 128) compares of shared
//     values;
//   * a group of G lanes scores one row, G the least power of two that
//     leaves a lane at most eight 16-byte chunks (1 lane for a 128-B int8
//     row, 4 for a 512-B f32 row), so one pass of the block covers 128 / G
//     later candidates; rows sit in shared memory at a stride that puts
//     the chunks the 8 lanes of a quarter-warp read in 8 different bank
//     groups. The kept row is staged in shared memory (int8 as bytes,
//     others in f32). The decisions are read by every thread from shared
//     memory, so all threads take every branch together and every barrier
//     sits in uniform control flow;
//   * int8 rows: the sums in int32 with __dp4a (exact, see below), which
//     keeps int-to-float conversions, a quarter-rate instruction, out of
//     the loops;
//   * no tensor cores: a keep scores one row against the later rows, a
//     matrix-vector product with no tile for `wgmma` or `mma.sync`.
// On int8 rows every dot product and norm is an exact integer in f32
// (|dot| <= 128 * 127^2 < 2^24), so the kept ids equal the plain
// version's whatever the order of the sums; the epilogue rounds each
// operation on its own (common.cuh), as PyTorch does.
#include "gather.cuh"

namespace vss {

constexpr int kSelThreads = 128;  // a block's threads
constexpr int kSelMaxSmem = 232448;  // 227 KB: the most a block may have
constexpr float kBig = 1e30f;  // select.py's _BIG, as f32 arithmetic takes it

// where a row's candidate rows and per-candidate arrays live
enum SelectLayout : int { kShared = 0, kRowsGlobal = 1, kAllGlobal = 2 };

struct SelectArgs {
  const int32_t* cand_i;  // [A, C]
  const float* cand_d;    // [A, C]
  const void* rows;       // the tape [cap, d], or cand_vecs [A, C, d]
  const uint8_t* active;  // [A] bool, or null
  int32_t* out;           // [A, m]
  unsigned char* ws;      // kAllGlobal: ws_row bytes a row
  int64_t ws_row;
  int C, Cp, m, d, metric, layout, group, stride;
  bool gathered, vec;
};

inline __host__ __device__ int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

// The lanes that score one row (`group`), whether rows are read in 16-byte
// chunks (`vec`: d a multiple of 16 bytes), and the row stride in shared
// memory in elements (`stride`): with fewer than 8 lanes a row, the stride
// in chunks is congruent to the group mod 8, so that the chunks the 8
// lanes of a quarter-warp read (8 / group rows) fall in 8 different groups
// of 4 banks.
inline __host__ __device__ void select_grouping(int d, int esize, int& group,
                                                bool& vec, int& stride) {
  const int VE = 16 / esize;
  vec = d % VE == 0;
  const int chunks = vec ? d / VE : d;
  group = 1;
  while (group * 8 < chunks && group < 32) group <<= 1;
  int s16 = chunks;
  if (vec && group < 8)
    while (s16 % 8 != group) ++s16;
  stride = vec ? s16 * VE : d;
}

// A row's memory, from its base: seven arrays of Cp 32-bit values (the
// unsorted ids and distances, the sorted distances, ids and positions,
// norms, dmin), Cp kept flags, the kept row in f32 (d values), then, in the
// shared layout, the Cp candidate rows at `select_grouping`'s stride.
inline __host__ __device__ int64_t select_meta_bytes(int Cp, int d) {
  return 7 * align16(4LL * Cp) + align16(Cp) + align16(4LL * d);
}
inline __host__ __device__ int64_t select_row_bytes(int Cp, int d, int esize,
                                                    int layout) {
  int group, stride;
  bool vec;
  select_grouping(d, esize, group, vec, stride);
  return select_meta_bytes(Cp, d) +
         (layout == kShared ? static_cast<int64_t>(Cp) * stride * esize : 0);
}

// torch.sort's ascending order of floats as an unsigned key: -0 as +0,
// every NaN last
__device__ __forceinline__ unsigned sort_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0 as +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the number of positions j of keys[0..n) (sort_key values) that sort
// before position c
__device__ __forceinline__ int rank_of(const unsigned* keys, int n, int c) {
  const unsigned kc = keys[c];
  int rank = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const unsigned kj = keys[j];
    rank += kj < kc || (kj == kc && j < c);
  }
  return rank;
}

// Where element e of a bf16 or f32 kept row sits in `ks` (in f32): with
// 16-byte loads (`vec`) element k of chunk v (16 bytes of the row) at
// k * chunks + v, so that lanes on neighbouring chunks read neighbouring
// words of shared memory (no bank conflicts); else at e. An int8 kept row
// keeps its bytes in order.
__device__ __forceinline__ int ks_slot(int e, int d, int VE, bool vec) {
  return vec ? (e % VE) * (d / VE) + e / VE : e;
}

// int8 rows: every product and partial sum of the plain version's f32 dot
// products and norms is an exact integer (|dot| <= d * 127^2 < 2^24 at
// d <= 1,040), so the sums run in int32, four products an instruction,
// and are converted once: the same f32 value.
__device__ __forceinline__ int dp4a16(uint4 x, uint4 k, int acc) {
  acc = __dp4a(static_cast<int>(x.x), static_cast<int>(k.x), acc);
  acc = __dp4a(static_cast<int>(x.y), static_cast<int>(k.y), acc);
  acc = __dp4a(static_cast<int>(x.z), static_cast<int>(k.z), acc);
  return __dp4a(static_cast<int>(x.w), static_cast<int>(k.w), acc);
}

__device__ __forceinline__ float dot_i8(const int8_t* row, const int8_t* kb,
                                        int d, int group, int gl, bool vec) {
  int dot = 0;
  if (row != nullptr) {
    if (vec) {
      for (int v = gl; v < d / 16; v += group)
        dot = dp4a16(*reinterpret_cast<const uint4*>(row + v * 16),
                     *reinterpret_cast<const uint4*>(kb + v * 16), dot);
    } else {
      for (int e = gl; e < d; e += group)
        dot += static_cast<int>(row[e]) * static_cast<int>(kb[e]);
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return static_cast<float>(dot);
}

// dot(row, ks) over d elements by a group of `group` lanes of which this is
// lane `gl`, the kept row in `ks` as `ks_slot` places it; every lane of the
// group returns the sum. `row` null loads nothing (0). Every lane of the
// warp must call this together.
template <typename T>
__device__ __forceinline__ float row_dot(const T* row, const float* ks, int d,
                                         int group, int gl, bool vec) {
  if constexpr (sizeof(T) == 1)
    return dot_i8(row, reinterpret_cast<const int8_t*>(ks), d, group, gl, vec);
  constexpr int VE = 16 / sizeof(T);
  float dot = 0.0f;
  if (row != nullptr) {
    if (vec) {
      for (int v = gl; v < d / VE; v += group) {
        float xv[16];
        load_vec(row + v * VE, xv);
#pragma unroll
        for (int e = 0; e < VE; ++e) dot = fmaf(xv[e], ks[e * (d / VE) + v], dot);
      }
    } else {
      for (int e = gl; e < d; e += group) dot = fmaf(to_f32(row[e]), ks[e], dot);
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return dot;
}

// |row|^2 by a group of lanes, as row_dot
template <typename T>
__device__ __forceinline__ float row_norm(const T* row, int d, int group,
                                          int gl, bool vec) {
  if constexpr (sizeof(T) == 1) return dot_i8(row, row, d, group, gl, vec);
  constexpr int VE = 16 / sizeof(T);
  float n = 0.0f;
  if (row != nullptr) {
    if (vec) {
      for (int v = gl; v < d / VE; v += group) {
        float xv[16];
        load_vec(row + v * VE, xv);
#pragma unroll
        for (int e = 0; e < VE; ++e) n = fmaf(xv[e], xv[e], n);
      }
    } else {
      for (int e = gl; e < d; e += group) {
        const float x = to_f32(row[e]);
        n = fmaf(x, x, n);
      }
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1)
    n += __shfl_xor_sync(0xffffffffu, n, off);
  return n;
}

// candidate s's row (sorted position s) in the caller's memory: tape row
// sid[s] (never negative for a finite distance) or cand_vecs[r, spos[s]]
template <typename T>
__device__ __forceinline__ const T* source_row(const SelectArgs& a, int64_t r,
                                               int s, const int32_t* sid,
                                               const int32_t* spos) {
  const T* rows = static_cast<const T*>(a.rows);
  return a.gathered ? rows + (r * a.C + spos[s]) * a.d
                    : rows + static_cast<int64_t>(sid[s]) * a.d;
}

template <typename T>
__global__ void __launch_bounds__(kSelThreads) select_kernel(SelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t r = blockIdx.x;
  const int C = a.C, Cp = a.Cp, m = a.m, d = a.d, stride = a.stride;
  int32_t* out = a.out + r * m;
  if (a.active != nullptr && !a.active[r]) {
    for (int j = tid; j < m; j += kSelThreads) out[j] = -1;
    return;
  }
  unsigned char* base = a.layout == kAllGlobal ? a.ws + r * a.ws_row : smem;
  const int64_t A4 = align16(4LL * Cp);
  int32_t* uid = reinterpret_cast<int32_t*>(base);
  float* ud = reinterpret_cast<float*>(base + A4);
  float* sd = reinterpret_cast<float*>(base + 2 * A4);
  int32_t* sid = reinterpret_cast<int32_t*>(base + 3 * A4);
  int32_t* spos = reinterpret_cast<int32_t*>(base + 4 * A4);
  float* nrm = reinterpret_cast<float*>(base + 5 * A4);
  float* dmin = reinterpret_cast<float*>(base + 6 * A4);
  unsigned char* kept = base + 7 * A4;
  float* ks = reinterpret_cast<float*>(kept + align16(Cp));
  T* srows = a.layout == kShared
                 ? reinterpret_cast<T*>(base + select_meta_bytes(Cp, d))
                 : nullptr;
  const int group = a.group;
  const int g = tid / group;
  const int gl = tid % group;
  const int ngroups = kSelThreads / group;

  // 1. inputs, padded to Cp
  for (int c = tid; c < Cp; c += kSelThreads) {
    int32_t id = -1;
    float v = CUDART_INF_F;
    if (c < C) {
      id = a.cand_i[r * C + c];
      v = a.cand_d[r * C + c];
    }
    uid[c] = id;
    ud[c] = id >= 0 ? v : CUDART_INF_F;
  }
  __syncthreads();
  // 2. the candidate order, the keys in dmin's words (free until step 3)
  unsigned* keys = reinterpret_cast<unsigned*>(dmin);
  for (int c = tid; c < Cp; c += kSelThreads) keys[c] = sort_key(ud[c]);
  __syncthreads();
  for (int c = tid; c < Cp; c += kSelThreads) {
    const int s = rank_of(keys, Cp, c);
    sd[s] = ud[c];
    sid[s] = uid[c];
    spos[s] = c;
  }
  __syncthreads();
  // 3. the rows of the candidates that can be kept (finite d: a real id,
  // a position < C): into shared memory in the shared layout; their norms
  if (srows != nullptr) {
    if (a.vec) {
      constexpr int VE = 16 / sizeof(T);
      const int chunks = d / VE;
#pragma unroll 4
      for (int i = tid; i < Cp * chunks; i += kSelThreads) {
        const int s = i / chunks;
        const int v = i - s * chunks;
        if (isfinite(sd[s]))
          reinterpret_cast<uint4*>(srows + static_cast<int64_t>(s) * stride)[v] =
              reinterpret_cast<const uint4*>(source_row<T>(a, r, s, sid, spos))[v];
      }
    } else {
      for (int i = tid; i < Cp * d; i += kSelThreads) {
        const int s = i / d;
        const int e = i - s * d;
        if (isfinite(sd[s]))
          srows[static_cast<int64_t>(s) * stride + e] =
              source_row<T>(a, r, s, sid, spos)[e];
      }
    }
    __syncthreads();
  }
  for (int s0 = 0; s0 < Cp; s0 += ngroups) {
    const int s = s0 + g;
    const T* src = nullptr;
    if (s < Cp && isfinite(sd[s]))
      src = srows != nullptr ? srows + static_cast<int64_t>(s) * stride
                             : source_row<T>(a, r, s, sid, spos);
    const float n = row_norm<T>(src, d, group, gl, a.vec);
    if (s < Cp && gl == 0) {
      nrm[s] = n;
      dmin[s] = CUDART_INF_F;
      kept[s] = 0;
    }
  }
  __syncthreads();
  // 4. the keep loop: every thread reads the same values, so every thread
  // takes the same branches
  int cnt = 0;
  for (int s = 0; s < Cp && cnt < m; ++s) {
    const float dc = sd[s];
    if (!(isfinite(dc) && dc < dmin[s])) continue;
    ++cnt;
    if (tid == 0) kept[s] = 1;
    if (cnt == m) break;  // no later decision reads dmin
    const T* rs = srows != nullptr ? srows + static_cast<int64_t>(s) * stride
                                   : source_row<T>(a, r, s, sid, spos);
    if constexpr (sizeof(T) == 1) {
      for (int e = tid; e < d; e += kSelThreads)
        reinterpret_cast<int8_t*>(ks)[e] = rs[e];
    } else {
      for (int e = tid; e < d; e += kSelThreads)
        ks[ks_slot(e, d, 16 / sizeof(T), a.vec)] = to_f32(rs[e]);
    }
    __syncthreads();
    const float ns = nrm[s];
    for (int t0 = s + 1; t0 < Cp; t0 += ngroups) {
      const int t = t0 + g;
      const bool live = t < Cp && isfinite(sd[t]);
      const T* rt = nullptr;
      if (live)
        rt = srows != nullptr ? srows + static_cast<int64_t>(t) * stride
                              : source_row<T>(a, r, t, sid, spos);
      const float dot = row_dot<T>(rt, ks, d, group, gl, a.vec);
      // d_cc[t, s] of the plain version: row t against the kept row s
      if (live && gl == 0)
        dmin[t] = nan_min(dmin[t], epilogue(dot, nrm[t], ns, a.metric));
    }
    __syncthreads();
  }
  __syncthreads();
  // 5. the output keys, in ud, their sort keys in nrm's words; their
  // stable order
  keys = reinterpret_cast<unsigned*>(nrm);
  for (int s = tid; s < Cp; s += kSelThreads) {
    const float v = sd[s];
    const float key = kept[s] ? v : (isfinite(v) ? __fadd_rn(v, kBig) : CUDART_INF_F);
    ud[s] = key;
    keys[s] = sort_key(key);
  }
  __syncthreads();
  for (int s = tid; s < Cp; s += kSelThreads) {
    const int rank = rank_of(keys, Cp, s);
    if (rank < m) out[rank] = isfinite(ud[s]) ? sid[s] : -1;
  }
}

// The first layout whose shared memory fits a block
inline int select_layout(int Cp, int d, int esize) {
  for (int layout : {kShared, kRowsGlobal})
    if (select_row_bytes(Cp, d, esize, layout) <= kSelMaxSmem) return layout;
  return kAllGlobal;
}

template <typename T>
int launch_select(SelectArgs a, int A, cudaStream_t s) {
  select_grouping(a.d, sizeof(T), a.group, a.vec, a.stride);
  const int64_t row = select_row_bytes(a.Cp, a.d, sizeof(T), a.layout);
  const int smem = a.layout == kAllGlobal ? 0 : static_cast<int>(row);
  if (a.layout == kAllGlobal && (a.ws == nullptr || a.ws_row < row))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.layout == kShared) {
    // as many blocks on an SM as its shared memory holds
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_kernel<T><<<A, kSelThreads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vss

// The layout the kernel takes for Cp = max(C, m) candidates of d elements
// of esize bytes when none is forced: 0 shared, 1 rows global, 2 all
// global, the first whose shared memory fits a block.
extern "C" int vss_select_layout(int Cp, int d, int esize) {
  return vss::select_layout(Cp, d, esize);
}

// The workspace bytes a row needs in `layout` (-1: the one
// vss_select_layout picks): 0 unless the layout is 2 (all global).
extern "C" int64_t vss_select_workspace_bytes(int Cp, int d, int esize,
                                              int layout) {
  if (layout < 0) layout = vss::select_layout(Cp, d, esize);
  return layout == vss::kAllGlobal
             ? vss::select_row_bytes(Cp, d, esize, layout)
             : 0;
}

// cand_i / cand_d [A, C]; `rows` the tape [cap, d] (gathered = 0) or
// cand_vecs [A, C, d] (gathered = 1) in `dtype`; `active` [A] bool or null;
// out [A, m]; `layout` -1 for vss_select_layout's, or one forced. In
// layout 2, `ws` holds ws_row bytes for each row
// (vss_select_workspace_bytes). A shape or layout the kernel does not take
// (m or d below 1, C below 0, a forced layout whose shared memory passes
// 227 KB, layout 2 without a large enough workspace) is refused before
// anything is launched.
extern "C" int vss_select_neighbors(const int32_t* cand_i, const float* cand_d,
                                    const void* rows, const uint8_t* active,
                                    int32_t* out, void* ws, int64_t ws_row,
                                    int A, int C, int m, int d, int dtype,
                                    int metric, int gathered, int layout,
                                    void* stream) {
  using namespace vss;
  const int Cp = C > m ? C : m;
  const int esize = dtype == I8 ? 1 : dtype == BF16 ? 2 : 4;
  if (C < 0 || m < 1 || d < 1 || layout < -1 || layout > kAllGlobal)
    return static_cast<int>(cudaErrorInvalidValue);
  if (layout < 0) layout = select_layout(Cp, d, esize);
  if (layout != kAllGlobal &&
      select_row_bytes(Cp, d, esize, layout) > kSelMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (A <= 0) return 0;
  SelectArgs a;
  a.cand_i = cand_i, a.cand_d = cand_d, a.rows = rows, a.active = active;
  a.out = out, a.ws = static_cast<unsigned char*>(ws), a.ws_row = ws_row;
  a.C = C, a.Cp = Cp, a.m = m, a.d = d, a.metric = metric;
  a.layout = layout, a.group = 1, a.stride = d, a.gathered = gathered != 0;
  a.vec = false;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8) return launch_select<int8_t>(a, A, s);
  if (dtype == BF16) return launch_select<__nv_bfloat16>(a, A, s);
  return launch_select<float>(a, A, s);
}
