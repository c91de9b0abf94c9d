// rerank_pool: the graph search's f32 rerank (`hnsw_search` with a rerank
// tape) in one launch for every query: the beam's ef-wide result pool
// rescored from the full-precision side tape by id, sorted stably and cut
// to its first k.
//
// Replaces the XLA after K5 in the JAX package, vss_tpu/index/search.py:
// 537-552 (`jnp.take` of the pool's rows, the direct difference or
// `gathered_distances`, the -1 mask, `lax.sort` with `is_stable`, then the
// k cut and the empty graph's `where`s), which the port ran as about ten
// torch ops that wrote the gathered block and read it again for each of
// them. The port's plain version is
// vss_tpu_torch/index/search.py:_rerank_pool_plain; this kernel computes
// the same function, for every ef, k <= ef and d:
//   * pool position p of query b holds the id ids[b, p]; an id of -1 (or
//     one outside the tape) scores +inf and reads nothing;
//   * l2sq is the direct difference sum (q - r)^2, each difference
//     rounded on its own (`__fsub_rn`) and squared into the sum by `fmaf`:
//     the dot-product identity loses digits to cancellation at the tape's
//     magnitudes. cosine and ip go through common.cuh's `epilogue` with the
//     query's squared norm qn (the caller's, not recomputed) and the row's
//     own, summed in the same pass. A NaN value scores +inf;
//   * the pool sorted stably by (value, pool position): the composites
//     order_key(value) << 32 | position through selectk.cuh's bitonic
//     network, the order torch.sort(stable=True) gives (-0 equal to +0;
//     no distance here is -0, so a value is read back from its key);
//   * the first k out, id -1 where the value is not finite; every slot
//     +inf and -1 where *entry < 0 (an empty graph), read on the device,
//     so the caller does not synchronise.
//
// Bound on the H100: bytes. Each pool row is read once, one contiguous run
// of 4 d (f32) or 2 d (bf16) bytes, with the query and its ids. At the
// serving batch of 512 queries, ef 64, that is 512 x 64 x 960 x 4 B =
// 126 MB (+2 MB of queries) at d = 960, 0.0382 ms at 3.35 TB/s, and 201 MB
// (+3 MB) at d = 1,536, 0.0611 ms. (Rows repeat across a batch's queries,
// so the distinct bytes are fewer; this counts each query's own.) The
// sums, 3 d flops a row, are far under any pipe's rate.
// Design:
//   * one block of 256 threads a query (512 blocks: one wave at 4 an SM);
//   * a warp scores kRpUnroll rows at a time, lane l taking their 16-byte
//     chunks l, l + 32, ... (one element a load where d x item size is not
//     a multiple of 16), the loads of all of them issued before any is
//     summed, the query's matching values read from device memory (L1
//     holds them: every row of the block reads the same ones); the sums
//     reduced by shuffles. 8 warps x 4 rows x 16 bytes a lane keep 16 KB
//     in flight a block, 64 KB an SM, over the bytes that the card's
//     bandwidth times its latency asks of one SM;
//   * the composites stay in shared memory, kRpChunk positions at a time:
//     a pool of at most kRpChunk is scored and sorted once (a buffer of
//     the power of two at or above ef); a wider one in chunks, each sorted
//     with the best kRpChunk so far (a buffer of 2 kRpChunk); a k past
//     kRpChunk in rounds of kRpChunk outputs, each scoring the pool again
//     and keeping the composites past the last one written (the scores are
//     the same each time, so the composites are);
//   * no workspace, no host sync, nothing allocated; every barrier and
//     shuffle sits in control flow that every thread of the block (of
//     the warp, for a warp's) takes alike (tests/cuda_emulation.h runs
//     nothing else).
// Measured on the H100 (`chip_smoke.py --rerank-only`, PERF.md): 0.0491 ms
// at 512 x 64 x 960 (1.29x the bound), 0.0742 ms at 512 x 64 x 1,536
// (1.21x), 0.0405 ms at 512 x 320 x 128 (1.60x), pools of random rows of
// 1M-row tapes; the torch ops it replaces took 0.583, 1.271 and 0.637 ms
// on the same inputs. A ring of bulk copies into shared memory in place of
// the direct loads read the same at d = 960 and slower at 1,536 and at
// ef 320 (CUDA events: 0.056 / 0.081 / 0.077 ms against 0.055 / 0.077 /
// 0.044), faster only over a bf16 tape (0.036 against 0.041).
#include "gather.cuh"
#include "selectk.cuh"

namespace vss {

constexpr int kRpWarps = kSkThreads / 32;  // warps of a block, kRpUnroll rows each at a time
constexpr int kRpUnroll = 4;               // rows a warp loads before it sums any
constexpr int kRpChunk = 4096;             // pool positions a block sorts at a time

struct RerankArgs {
  const float* q;        // [B, d]
  const float* qn;       // [B] squared query norms (read under cosine alone)
  const int32_t* ids;    // [B, ef] the pool's ids, -1 for an empty slot
  const void* rows;      // [cap, d] f32 / bf16: the rerank tape
  const int32_t* entry;  // the graph's entry slot, -1 when empty
  float* out_d;          // [B, k]
  int32_t* out_i;        // [B, k]
  int64_t cap;
  int d, ef, k, metric;
  bool vec;  // rows and the query in 16-byte chunks
};

// The composite buffer's entries: the power of two at or above ef, or two
// chunks' for a pool wider than one.
__host__ __device__ inline int sort_entries(int ef) {
  if (ef > kRpChunk) return 2 * kRpChunk;
  int n2 = 1;
  while (n2 < ef) n2 <<= 1;
  return n2;
}

// s0 += (q - r)^2 (l2), or s0 += q r and s1 += r r.
__device__ __forceinline__ void accumulate(float r, float q, bool l2, float& s0, float& s1) {
  if (l2) {
    const float diff = __fsub_rn(q, r);
    s0 = fmaf(diff, diff, s0);
  } else {
    s0 = fmaf(r, q, s0);
    s1 = fmaf(r, r, s1);
  }
}

// One chunk of a row: 16 bytes, or without `vec` one element as f32 bits.
template <typename T>
__device__ __forceinline__ uint4 row_chunk(const T* p, bool vec) {
  uint4 r;
  if (vec) {
    r = *reinterpret_cast<const uint4*>(p);
  } else {
    r.x = __float_as_uint(to_f32(*p));
    r.y = r.z = r.w = 0u;
  }
  return r;
}

// The chunk's values as f32: 16 / sizeof(T) of them.
__device__ __forceinline__ void chunk_values(const uint4& r, __nv_bfloat16, float v[8]) {
  bf16x2(r.x, v[0], v[1]);
  bf16x2(r.y, v[2], v[3]);
  bf16x2(r.z, v[4], v[5]);
  bf16x2(r.w, v[6], v[7]);
}
__device__ __forceinline__ void chunk_values(const uint4& r, float, float v[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

// The composites of pool positions [p0, p1) of one query into dst[0, p1 -
// p0): order_key(value) << 32 | position, or kNone for a composite below
// `lo` (one that an earlier round wrote out). Every thread of the block
// calls this together.
template <typename RT>
__device__ __forceinline__ void score_range(const RerankArgs& a, const float* q,
                                            const int32_t* ids, float qnb, int p0, int p1,
                                            u64 lo, u64* dst) {
  constexpr int VE = 16 / sizeof(RT);
  const RT* rows = static_cast<const RT*>(a.rows);
  const int step = a.vec ? VE : 1;
  const int chunks = a.d / step;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool l2 = a.metric == L2SQ;
  for (int base = p0 + warp; base < p1; base += kRpUnroll * kRpWarps) {
    int id[kRpUnroll];
    float s0[kRpUnroll], s1[kRpUnroll];
#pragma unroll
    for (int u = 0; u < kRpUnroll; ++u) {
      const int p = base + u * kRpWarps;
      const int i = p < p1 ? ids[p] : -1;
      id[u] = i >= 0 && i < a.cap ? i : -1;
      s0[u] = 0.0f;
      s1[u] = 0.0f;
    }
    for (int c = lane; c < chunks; c += 32) {
      uint4 raw[kRpUnroll];
#pragma unroll
      for (int u = 0; u < kRpUnroll; ++u)
        raw[u] = id[u] >= 0 ? row_chunk(rows + static_cast<int64_t>(id[u]) * a.d + c * step,
                                        a.vec)
                            : make_uint4(0u, 0u, 0u, 0u);
      float qv[VE];
      if (a.vec) {
#pragma unroll
        for (int j = 0; j < VE / 4; ++j) {
          const float4 f = reinterpret_cast<const float4*>(q + c * VE)[j];
          qv[4 * j] = f.x;
          qv[4 * j + 1] = f.y;
          qv[4 * j + 2] = f.z;
          qv[4 * j + 3] = f.w;
        }
      } else {
        qv[0] = q[c];
      }
#pragma unroll
      for (int u = 0; u < kRpUnroll; ++u) {
        if (id[u] < 0) continue;
        if (a.vec) {
          float v[VE];
          chunk_values(raw[u], RT(), v);
#pragma unroll
          for (int e = 0; e < VE; ++e) accumulate(v[e], qv[e], l2, s0[u], s1[u]);
        } else {
          accumulate(__uint_as_float(raw[u].x), qv[0], l2, s0[u], s1[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRpUnroll; ++u) {
      for (int off = 16; off > 0; off >>= 1) {
        s0[u] += __shfl_xor_sync(0xffffffffu, s0[u], off);
        s1[u] += __shfl_xor_sync(0xffffffffu, s1[u], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kRpUnroll; ++u) {
        const int p = base + u * kRpWarps;
        if (p >= p1) continue;
        float v = CUDART_INF_F;
        if (id[u] >= 0) {
          v = l2 ? s0[u] : epilogue(s0[u], qnb, s1[u], a.metric);
          if (isnan(v)) v = CUDART_INF_F;
        }
        const u64 c = (static_cast<u64>(order_key(v, false)) << 32) | static_cast<unsigned>(p);
        dst[p - p0] = c < lo ? kNone : c;
      }
    }
  }
}

// at most 64 registers a thread, so that 4 blocks fit an SM: the serving
// batch's 512 queries then run in one wave on the 132 SMs
template <typename RT>
__global__ void __launch_bounds__(kSkThreads, 4) rerank_pool_kernel(RerankArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  float* out_d = a.out_d + b * a.k;
  int32_t* out_i = a.out_i + b * a.k;
  if (*a.entry < 0) {  // an empty graph: nothing (alike in every thread)
    for (int j = tid; j < a.k; j += kSkThreads) {
      out_d[j] = CUDART_INF_F;
      out_i[j] = -1;
    }
    return;
  }
  const float* q = a.q + b * a.d;
  const int32_t* ids = a.ids + b * a.ef;
  const float qnb = a.metric == COSINE ? a.qn[b] : 0.0f;
  const int first = a.ef > kRpChunk ? kRpChunk : sort_entries(a.ef);
  u64 lo = 0;  // the least composite this round may write out
  for (int done = 0; done < a.k; done += kRpChunk) {
    // the kRpChunk least composites from lo on, sorted, into buf[0, kRpChunk)
    for (int p0 = 0; p0 < a.ef; p0 += kRpChunk) {
      const int p1 = p0 + kRpChunk < a.ef ? p0 + kRpChunk : a.ef;
      u64* dst = p0 == 0 ? buf : buf + kRpChunk;
      const int width = p0 == 0 ? first : kRpChunk;
      score_range<RT>(a, q, ids, qnb, p0, p1, lo, dst);
      for (int i = p1 - p0 + tid; i < width; i += kSkThreads) dst[i] = kNone;
      __syncthreads();
      bitonic_sort(buf, p0 == 0 ? first : 2 * kRpChunk);
    }
    const int n = a.k - done < kRpChunk ? a.k - done : kRpChunk;
    for (int j = tid; j < n; j += kSkThreads) {
      const u64 c = buf[j];
      const float v = key_float(static_cast<unsigned>(c >> 32));
      out_d[done + j] = v;
      out_i[done + j] = isfinite(v) ? ids[static_cast<int>(c & 0xffffffffull)] : -1;
    }
    // another round follows only where k > kRpChunk, so ef > kRpChunk and
    // the buffer holds kRpChunk composites
    if (done + kRpChunk < a.k) lo = buf[kRpChunk - 1] + 1;
    __syncthreads();  // every thread has read the buffer before the next round writes it
  }
}

template <typename RT>
int launch(RerankArgs& a, int nq, cudaStream_t stream) {
  const auto kernel = rerank_pool_kernel<RT>;
  a.vec = a.d * static_cast<int>(sizeof(RT)) % 16 == 0;
  const size_t smem = static_cast<size_t>(sort_entries(a.ef)) * sizeof(u64);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nq, kSkThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vss

// The f32 rerank of nq queries q [nq, d] (f32, 16-byte aligned; their
// squared norms qn [nq], read under cosine alone) over their pools ids
// [nq, ef] (int32, -1 for an empty slot) from the rerank tape rows [cap, d]
// (rdtype: common.cuh `DType`, F32 or BF16; 16-byte aligned) under `metric`
// (common.cuh `Metric`): out_d [nq, k] f32 ascending and out_i [nq, k]
// int32, -1 where the distance is not finite; every slot +inf and -1 where
// *entry (int32, on the device) is below 0. Arguments that name no such
// call (ef < 1, k outside 1 .. ef, d < 1, cap < 0, an unknown rdtype or
// metric, cosine without norms, no entry) are refused before anything is
// launched; nq = 0 launches nothing.
extern "C" int vss_rerank_pool(const float* q, const float* qn, const int32_t* ids,
                               const void* rows, const int32_t* entry, float* out_d,
                               int32_t* out_i, int nq, int ef, int64_t cap, int d, int rdtype,
                               int metric, int k, void* stream) {
  using namespace vss;
  if (nq < 0 || ef < 1 || k < 1 || k > ef || d < 1 || cap < 0 ||
      (rdtype != F32 && rdtype != BF16) || metric < L2SQ || metric > IP ||
      (metric == COSINE && qn == nullptr) || entry == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  RerankArgs a;
  a.q = q, a.qn = qn, a.ids = ids, a.rows = rows, a.entry = entry;
  a.out_d = out_d, a.out_i = out_i;
  a.cap = cap, a.d = d, a.ef = ef, a.k = k, a.metric = metric;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rdtype == BF16) return launch<__nv_bfloat16>(a, nq, s);
  return launch<float>(a, nq, s);
}
