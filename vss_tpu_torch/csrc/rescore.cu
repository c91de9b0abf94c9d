// rescore_topk: phases B and C of the exact scan (`scan_topk`) in one
// launch for every query: the kept sub-segments' rows scored, their m
// least selected, and (with a rerank tape) those m rows rescored from the
// side tape in f32 and sorted.
//
// Replaces the XLA after K2 in the JAX package, vss_tpu/ops/scan.py:216-321
// (`_rescore_native`, `_gather_segment_blocks`, `_rescore_native_block`):
// the gather of every kept 32-row sub-segment into a [nq, keep*32, d]
// block, its cast, the batched matrix-vector product, the epilogue and
// mask, the selection of the m-pool, the rerank gather and the stable
// sort. The port's plain version is vss_tpu_torch/ops/scan.py:_rescore_plain;
// this kernel computes the same function:
//   * candidate position p = s*32 + lane of query b is row
//     segs[b, s]*32 + lane; a segment of -1, a row at or past nx (the last
//     sub-segment may be ragged), or a row that `valid` clears scores +inf,
//     and no row past the tape is read;
//   * phase B's value is common.cuh's `epilogue` of the row's dot with the
//     query, the query's squared norm qn (the wrapper's, not recomputed)
//     and the row's x_norms entry, +inf where NaN. With a rerank tape the
//     dot takes bf16 inputs (the query and an f32 tape rounded to nearest
//     even; int8 and bf16 values are exact) and f32 sums; without one, f32
//     inputs;
//   * the m least in select_k's order (selectk.cuh's key and composite
//     key << 32 | position: ties to the lower position); a pool entry
//     whose value is not finite has id -1;
//   * phase C (rerank tape only): the pool's rows from the f32 or bf16 side
//     tape as f32; l2sq as the direct difference sum (q - r)^2, ip and
//     cosine through `epilogue` with the rows' own squared norms; +inf
//     where the id is -1 or the value NaN; sorted stably by (value, pool
//     position); the first k out, id -1 where the value is not finite.
//     Without a rerank tape the output is phase B's first k (m = k).
// Outputs past the pool (k above the candidates) are +inf and -1.
//
// Bound on the H100: bytes. Each kept sub-segment is 32 contiguous rows
// (4 KB at int8 d=128), read once, with its norms (128 B) and valid flags
// (32 B); with a rerank tape, m rows of 4*d bytes. At `scan_search`'s
// k=100 batch (512 queries, keep 200, m 200) that is 488 MB counted per
// query, 0.146 ms at 3.35 TB/s; the sums, about 0.4 GFLOP, are far under
// any pipe's rate. The parent's route moved the block three times (int8,
// bf16, f32: 1.9 GB a 327-query chunk).
// Design:
//   * one block of 256 threads a query; where queries are too few to give
//     the SMs a few blocks each (SQL's single queries), a query's segments
//     split over several blocks, and the last to finish merges their
//     lists (selectk.cuh `merge_splits`) and runs phase C. No host sync;
//   * a group of lanes scores a row (K1's grouping, gather.cuh
//     `row_grouping`: 8 lanes of 16-byte loads a row at int8 d=128, so a
//     pass of 256 threads covers one sub-segment), and each group keeps
//     the loads of kRsUnroll rows in flight before it sums any of them;
//   * the values go to shared memory, kRsValMax positions at a time (256
//     sub-segments, all of `scan_search`'s), and selectk.cuh's `filter`
//     keeps the m least over them; a longer list takes several rounds;
//   * phase C scores the m rows the same way and sorts m composites
//     (value key << 32 | pool position) by selectk.cuh's bitonic network;
//   * no tensor cores: each query is a matrix-vector product over rows of
//     its own;
//   * every barrier and shuffle sits in control flow that every thread of
//     the block takes alike (tests/cuda_emulation.h runs nothing else).
// Measured on the H100 (`chip_smoke.py`, PERF.md): about 0.36 ms at that
// batch, whose distinct rows are 175 MB of the 488; decoding the int8
// bytes without the conversion instruction made no difference, so the
// rows each query reads again are the likely limit (not profiled).
#include "gather.cuh"
#include "selectk.cuh"

namespace vss {

constexpr int kRsSub = 32;        // rows of a sub-segment
constexpr int kRsUnroll = 4;      // rows a group of lanes loads before it sums
constexpr int kRsValMax = 8192;   // positions scored into shared memory a round
constexpr int kRsPool = kSkMaxK;  // the widest m

struct RescoreArgs {
  const float* q;        // [nq, d]
  const float* qn;       // [nq] squared query norms
  const int32_t* segs;   // [nq, keep] sub-segment ids, -1 padding
  const void* tape;      // [nx, d] int8 / bf16 / f32
  const float* xn;       // [nx] squared row norms
  const uint8_t* valid;  // [nx]
  const void* rerank;    // [nx, d] f32 / bf16, or null
  float* out_d;          // [nq, k]
  int32_t* out_i;        // [nq, k]
  u64* part;             // [nq, splits, mb]: each split's mb least
  int* done;             // [nq]: blocks of the query finished (zero at launch)
  int64_t nx;
  int keep, d, metric, m, mb, k, splits, vmax;
  int group, rgroup;  // lanes a tape row, a rerank row
  bool vec, rvec;     // rows in 16-byte loads
};

// Byte offsets of the dynamic shared memory: the selection's buffer, the
// query as phase B takes it (bf16-rounded with a rerank tape) and as f32,
// a round's segment ids and values, the pool's ids and phase C's values.
struct RescoreLayout {
  size_t qs, qf, seg, vals, pid, rdv, total;
  __host__ __device__ RescoreLayout(int d, int vmax) {
    qs = (sizeof(SelectKSmem) + 15) / 16 * 16;
    qf = qs + (static_cast<size_t>(d) * 4 + 15) / 16 * 16;
    seg = qf + (static_cast<size_t>(d) * 4 + 15) / 16 * 16;
    vals = seg + (static_cast<size_t>(vmax / kRsSub) * 4 + 15) / 16 * 16;
    pid = vals + static_cast<size_t>(vmax) * 4;
    rdv = pid + kRsPool * 4;
    total = rdv + kRsPool * 4;
  }
};

// The row of lane `lane` of sub-segment `seg`: the segment clamped at 0,
// then masked (-1 for a -1 segment or a row at or past the tape's end).
__device__ __forceinline__ int64_t seg_row(int seg, int lane, int64_t nx) {
  const int64_t row = static_cast<int64_t>(seg < 0 ? 0 : seg) * kRsSub + lane;
  return seg < 0 || row >= nx ? -1 : row;
}

// dot += chunk . query, in element order: the query's value of element e
// at qc[e * stride] (the staged query's layout, `stage_query`). ROUND rounds
// each f32 value to bf16 (int8 and bf16 values are exact in bf16 already).
template <typename T, bool ROUND>
__device__ __forceinline__ void dot_chunk(const uint4& r, bool vec, const float* qc, int stride,
                                          float& dot) {
  constexpr int VE = 16 / sizeof(T);
  if (!vec) {
    const float x = __uint_as_float(r.x);
    dot = fmaf(ROUND ? round_bf16(x) : x, qc[0], dot);
    return;
  }
  float v[16];
  decode(r, T(), v);
#pragma unroll
  for (int e = 0; e < VE; ++e)
    dot = fmaf(ROUND ? round_bf16(v[e]) : v[e], qc[e * stride], dot);
}

// The query in shared memory for rows of `step` elements a chunk:
// element j of chunk c at dst[j * chunks + c], so that the lanes of a row,
// which read neighbouring chunks, read neighbouring words.
__device__ __forceinline__ void stage_query(float* dst, const float* q, int d, int step,
                                            bool round) {
  const int chunks = d / step;
  for (int e = threadIdx.x; e < d; e += kSkThreads) {
    const float v = q[e];
    dst[(e % step) * chunks + e / step] = round ? round_bf16(v) : v;
  }
}

// Sum `v` over the `group` lanes of a row (every lane gets the sum).
__device__ __forceinline__ float group_sum(float v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Phase B over one round: vals[i] for the np positions (a multiple of 32)
// of the segments in `sseg`, the query staged in `qs`. ROUND: the tape is
// f32 and a rerank tape follows.
template <typename T, bool ROUND>
__device__ __forceinline__ void score_round(const RescoreArgs& a, const float* qs,
                                            const int* sseg, float* vals, int np, float qnb) {
  const T* tape = static_cast<const T*>(a.tape);
  const int step = a.vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int chunks = a.d / step;
  const int g = threadIdx.x / a.group, gl = threadIdx.x % a.group;
  const int ngroups = kSkThreads / a.group;
  for (int base = 0; base < np; base += kRsUnroll * ngroups) {
    int64_t row[kRsUnroll];
    float dot[kRsUnroll], xn[kRsUnroll];
    bool ok[kRsUnroll];
#pragma unroll
    for (int u = 0; u < kRsUnroll; ++u) {
      const int i = base + u * ngroups + g;
      row[u] = i < np ? seg_row(sseg[i / kRsSub], i % kRsSub, a.nx) : -1;
      dot[u] = 0.0f;
      xn[u] = 0.0f;
      ok[u] = false;
      if (gl == 0 && row[u] >= 0) {
        xn[u] = a.xn[row[u]];
        ok[u] = a.valid[row[u]] != 0;
      }
    }
    for (int c = gl; c < chunks; c += a.group) {
      uint4 raw[kRsUnroll];
#pragma unroll
      for (int u = 0; u < kRsUnroll; ++u)
        if (row[u] >= 0) raw[u] = load_chunk(tape + row[u] * a.d + c * step, a.vec);
#pragma unroll
      for (int u = 0; u < kRsUnroll; ++u)
        if (row[u] >= 0) dot_chunk<T, ROUND>(raw[u], a.vec, qs + c, chunks, dot[u]);
    }
#pragma unroll
    for (int u = 0; u < kRsUnroll; ++u) dot[u] = group_sum(dot[u], a.group);
    if (gl == 0) {
#pragma unroll
      for (int u = 0; u < kRsUnroll; ++u) {
        const int i = base + u * ngroups + g;
        if (i >= np) continue;
        float v = CUDART_INF_F;
        if (row[u] >= 0 && ok[u]) {
          v = epilogue(dot[u], qnb, xn[u], a.metric);
          if (isnan(v)) v = CUDART_INF_F;
        }
        vals[i] = v;
      }
    }
  }
}

// A round's values in shared memory, position p at vals[p - p0], for
// selectk.cuh's `filter`: 4 consecutive values a thread (rounds and tiles
// start at multiples of 4). No value is NaN (phase B made them +inf).
struct ValSource {
  typedef float Raw;
  const float* vals;
  int64_t p0;
  __device__ __forceinline__ int64_t pos(int64_t b0, int v) const {
    return b0 + 4 * threadIdx.x + v;
  }
  __device__ __forceinline__ void load(int64_t b0, int64_t b1, float (&raw)[kSkPer]) const {
    const int64_t p = pos(b0, 0);
    if (p < b1) {
      const float4 f = *reinterpret_cast<const float4*>(vals + (p - p0));
      raw[0] = f.x;
      raw[1] = f.y;
      raw[2] = f.z;
      raw[3] = f.w;
    }
  }
  __device__ __forceinline__ bool maybe(float r, float tf) const { return !(r > tf); }
  __device__ __forceinline__ u64 key(float r, int64_t p) const {
    return (static_cast<u64>(order_key(r, false)) << 32) | static_cast<unsigned>(p);
  }
};

// Phase C: rdv[i] for the m pool rows of ids pid[i] (-1: +inf), from the
// rerank tape of type RT, the f32 query staged in `qf` for its rows.
template <typename RT>
__device__ __forceinline__ void score_pool(const RescoreArgs& a, const float* qf,
                                           const int* pid, float* rdv, float qnb) {
  const RT* rr = static_cast<const RT*>(a.rerank);
  const int step = a.rvec ? 16 / static_cast<int>(sizeof(RT)) : 1;
  const int chunks = a.d / step;
  const int g = threadIdx.x / a.rgroup, gl = threadIdx.x % a.rgroup;
  const int ngroups = kSkThreads / a.rgroup;
  const bool l2 = a.metric == L2SQ;
  for (int base = 0; base < a.m; base += kRsUnroll * ngroups) {
    int id[kRsUnroll];
    float s0[kRsUnroll], s1[kRsUnroll];  // l2sq: sum (q - r)^2; else dot, |r|^2
#pragma unroll
    for (int u = 0; u < kRsUnroll; ++u) {
      const int i = base + u * ngroups + g;
      id[u] = i < a.m ? pid[i] : -1;
      s0[u] = 0.0f;
      s1[u] = 0.0f;
    }
    for (int c = gl; c < chunks; c += a.rgroup) {
      uint4 raw[kRsUnroll];
#pragma unroll
      for (int u = 0; u < kRsUnroll; ++u)
        if (id[u] >= 0)
          raw[u] = load_chunk(rr + static_cast<int64_t>(id[u]) * a.d + c * step, a.rvec);
#pragma unroll
      for (int u = 0; u < kRsUnroll; ++u) {
        if (id[u] < 0) continue;
        float v[16];
        int nv = 1;
        if (a.rvec) {
          decode(raw[u], RT(), v);
          nv = step;
        } else {
          v[0] = __uint_as_float(raw[u].x);
        }
#pragma unroll
        for (int e = 0; e < 16 / static_cast<int>(sizeof(RT)); ++e) {
          if (e >= nv) break;
          const float qe = qf[c + e * chunks];
          if (l2) {
            const float diff = __fsub_rn(qe, v[e]);
            s0[u] = fmaf(diff, diff, s0[u]);
          } else {
            s0[u] = fmaf(v[e], qe, s0[u]);
            s1[u] = fmaf(v[e], v[e], s1[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRsUnroll; ++u) {
      s0[u] = group_sum(s0[u], a.rgroup);
      s1[u] = group_sum(s1[u], a.rgroup);
    }
    if (gl == 0) {
#pragma unroll
      for (int u = 0; u < kRsUnroll; ++u) {
        const int i = base + u * ngroups + g;
        if (i >= a.m) continue;
        float v = CUDART_INF_F;
        if (id[u] >= 0) {
          v = l2 ? s0[u] : epilogue(s0[u], qnb, s1[u], a.metric);
          if (isnan(v)) v = CUDART_INF_F;
        }
        rdv[i] = v;
      }
    }
  }
}

// The query's outputs from the sorted buffer, which holds its n least
// composites of phase B.
template <typename RT>
__device__ __forceinline__ void finish(const RescoreArgs& a, SelectKSmem& s,
                                       unsigned char* smem, const RescoreLayout& lay,
                                       int64_t b, int n, float qnb) {
  float* out_d = a.out_d + b * a.k;
  int32_t* out_i = a.out_i + b * a.k;
  const int32_t* segs = a.segs + b * a.keep;
  // the pool: value and id of each entry, -1 where the value is not finite
  auto entry = [&](int i, float& v, int& id) {
    v = CUDART_INF_F;
    id = -1;
    if (i < n) {
      const u64 c = s.buf[i];
      const int p = static_cast<int>(c & 0xffffffffull);
      v = key_float(static_cast<unsigned>(c >> 32));
      if (isfinite(v)) id = static_cast<int>(seg_row(segs[p / kRsSub], p % kRsSub, a.nx));
    }
  };
  if (a.rerank == nullptr) {
    for (int j = threadIdx.x; j < a.k; j += kSkThreads) {
      float v;
      int id;
      entry(j, v, id);
      out_d[j] = v;
      out_i[j] = id;
    }
    return;
  }
  const float* qf = reinterpret_cast<const float*>(smem + lay.qf);
  int* pid = reinterpret_cast<int*>(smem + lay.pid);
  float* rdv = reinterpret_cast<float*>(smem + lay.rdv);
  for (int i = threadIdx.x; i < a.m; i += kSkThreads) {
    float v;
    entry(i, v, pid[i]);
  }
  __syncthreads();
  score_pool<RT>(a, qf, pid, rdv, qnb);
  __syncthreads();
  int m2 = 1;
  while (m2 < a.m) m2 <<= 1;
  for (int i = threadIdx.x; i < m2; i += kSkThreads)
    s.buf[i] = i < a.m ? (static_cast<u64>(order_key(rdv[i], false)) << 32) |
                             static_cast<unsigned>(i)
                       : kNone;
  __syncthreads();
  bitonic_sort(s.buf, m2);
  for (int j = threadIdx.x; j < a.k; j += kSkThreads) {
    float v = CUDART_INF_F;
    int id = -1;
    if (j < a.m) {
      const int slot = static_cast<int>(s.buf[j] & 0xffffffffull);
      v = rdv[slot];
      if (isfinite(v)) id = pid[slot];
    }
    out_d[j] = v;
    out_i[j] = id;
  }
}

// at most 64 registers a thread, so that 4 blocks fit an SM: `scan_search`'s
// 512 queries then run in one wave on the 132 SMs
template <typename T, typename RT, bool ROUND>
__global__ void __launch_bounds__(kSkThreads, 4) rescore_topk_kernel(RescoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SelectKSmem& s = *reinterpret_cast<SelectKSmem*>(smem);
  const RescoreLayout lay(a.d, a.vmax);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* qf = reinterpret_cast<float*>(smem + lay.qf);
  int* sseg = reinterpret_cast<int*>(smem + lay.seg);
  float* vals = reinterpret_cast<float*>(smem + lay.vals);
  const int64_t b = blockIdx.x / a.splits;
  const int split = blockIdx.x % a.splits;
  stage_query(qs, a.q + b * a.d, a.d, a.vec ? 16 / static_cast<int>(sizeof(T)) : 1,
              a.rerank != nullptr);
  if (a.rerank != nullptr)
    stage_query(qf, a.q + b * a.d, a.d, a.rvec ? 16 / static_cast<int>(sizeof(RT)) : 1, false);
  const float qnb = a.qn[b];
  // this block's sub-segments [s0, s1) of the query's keep
  const int per = (a.keep + a.splits - 1) / a.splits;
  const int s0 = split * per < a.keep ? split * per : a.keep;
  const int s1 = s0 + per < a.keep ? s0 + per : a.keep;
  const int32_t* segs = a.segs + b * a.keep;
  int n = 0;
  u64 T_ = kNone;
  // the first cut sorts 256 values (512 above m = 128), as select_k's
  int first = a.mb > 128 ? 2 * kSkThreads : kSkThreads;
  for (int c0 = s0; c0 < s1; c0 += a.vmax / kRsSub) {
    const int c1 = c0 + a.vmax / kRsSub < s1 ? c0 + a.vmax / kRsSub : s1;
    for (int i = threadIdx.x; i < c1 - c0; i += kSkThreads) sseg[i] = segs[c0 + i];
    __syncthreads();
    score_round<T, ROUND>(a, qs, sseg, vals, (c1 - c0) * kRsSub, qnb);
    __syncthreads();
    const ValSource src{vals, static_cast<int64_t>(c0) * kRsSub};
    filter(s, src, static_cast<int64_t>(c0) * kRsSub, static_cast<int64_t>(c1) * kRsSub, first,
           a.mb, n, T_);
    first = kSkTile;
  }
  if (a.splits > 1 &&
      !merge_splits(s, a.part + b * a.splits * a.mb, a.done + b, split, a.splits, a.mb, n, T_))
    return;
  __syncthreads();
  finish<RT>(a, s, smem, lay, b, n, qnb);
}

template <typename T, typename RT, bool ROUND>
int launch(const RescoreArgs& a, int nq, cudaStream_t stream) {
  const auto kernel = rescore_topk_kernel<T, RT, ROUND>;
  const size_t smem = RescoreLayout(a.d, a.vmax).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // as many blocks on an SM as its shared memory holds
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nq * a.splits, kSkThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the rerank tape's type (phase C), then whether phase B rounds an f32 tape
template <typename T>
int launch_rerank(RescoreArgs& a, int nq, int rdtype, cudaStream_t stream) {
  if (rdtype == BF16) {
    row_grouping<__nv_bfloat16>(a.d, a.rgroup, a.rvec);
    return launch<T, __nv_bfloat16, sizeof(T) == 4>(a, nq, stream);
  }
  if (rdtype == F32) {
    row_grouping<float>(a.d, a.rgroup, a.rvec);
    return launch<T, float, sizeof(T) == 4>(a, nq, stream);
  }
  a.rgroup = 1, a.rvec = false;
  return launch<T, float, false>(a, nq, stream);
}

}  // namespace vss

// Phases B and C of the exact scan for nq queries q [nq, d] (f32, their
// squared norms qn [nq]) over the kept sub-segments segs [nq, keep]
// (int32, -1 padding) of the tape [nx, d] (dtype: common.cuh `DType`),
// its squared row norms xn [nx] and valid flags [nx] (bool), under
// `metric` (common.cuh `Metric`): out_d [nq, k] f32 ascending and out_i
// [nq, k] int32 (-1 where the distance is not finite). rerank [nx, d]
// (rdtype F32 or BF16) reranks the m-pool; rdtype -1 and a null rerank
// tape give phase B's first k. With splits > 1 each query's segments are
// cut into that many parts, one block each, and `ws` holds nq * splits *
// min(m, 32 keep) 8-byte entries followed by nq ints. A shape the kernel
// does not take (keep outside 1 .. 2^26 - 1, nx < 1, d < 1, m or k
// outside 1 .. 256, splits outside 1 .. keep, splits > 1 without a
// workspace, an unknown dtype, rerank dtype or metric, a rerank dtype
// without a tape or a tape without one) is refused before anything is
// launched; nq = 0 launches nothing.
extern "C" int vss_rescore_topk(const float* q, const float* qn, const int32_t* segs,
                                const void* tape, const float* xn, const uint8_t* valid,
                                const void* rerank, float* out_d, int32_t* out_i, void* ws,
                                int nq, int keep, int64_t nx, int d, int dtype, int rdtype,
                                int metric, int m, int k, int splits, void* stream) {
  using namespace vss;
  if (nq < 0 || keep < 1 || keep >= (1 << 26) || nx < 1 || d < 1 || m < 1 || m > kSkMaxK ||
      k < 1 || k > kSkMaxK || splits < 1 || splits > keep || (splits > 1 && ws == nullptr) ||
      static_cast<int64_t>(nq) * splits > 0x7fffffffLL || dtype < F32 || dtype > I8 ||
      rdtype < -1 || rdtype > BF16 || (rdtype >= 0) != (rerank != nullptr) || metric < L2SQ ||
      metric > IP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RescoreArgs a;
  a.q = q, a.qn = qn, a.segs = segs, a.tape = tape, a.xn = xn, a.valid = valid;
  a.rerank = rerank, a.out_d = out_d, a.out_i = out_i;
  a.nx = nx, a.keep = keep, a.d = d, a.metric = metric, a.m = m, a.k = k, a.splits = splits;
  a.mb = m < keep * kRsSub ? m : keep * kRsSub;
  const int per = (keep + splits - 1) / splits;
  a.vmax = (per < kRsValMax / kRsSub ? per : kRsValMax / kRsSub) * kRsSub;
  a.part = static_cast<u64*>(ws);
  a.done = splits > 1 ? reinterpret_cast<int*>(a.part + static_cast<int64_t>(nq) * splits * a.mb)
                      : nullptr;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(a.done, 0, sizeof(int) * static_cast<size_t>(nq), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == I8) {
    row_grouping<int8_t>(d, a.group, a.vec);
    return launch_rerank<int8_t>(a, nq, rdtype, s);
  }
  if (dtype == BF16) {
    row_grouping<__nv_bfloat16>(d, a.group, a.vec);
    return launch_rerank<__nv_bfloat16>(a, nq, rdtype, s);
  }
  row_grouping<float>(d, a.group, a.vec);
  return launch_rerank<float>(a, nq, rdtype, s);
}
