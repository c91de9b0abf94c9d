// Two kernels: K1 (fused gather + distance) here, K5 (whole-row gather)
// at the end of the file.
//
// K1: fused gather + distance, the beam search's hot step.
//
// Replaces vss_tpu/ops/gather.py:_gather_dist_kernel (launched by
// _gather_distances_impl). out[b, c] = distance(q[b], table[ids[b, c]])
// with f32 accumulation and the metric epilogue; an id < 0 issues no
// load and gives +inf. The table is read in its own dtype (int8 / bf16 /
// f32) at any width: the TPU kernel's i32-word packing existed only for
// Mosaic's 128-lane DMA rule and is not carried over.
//
// Bound on the H100: one beam step at the flagship (512 queries x 32
// candidates, int8 rows of 128 B) moves ~2 MB, under a microsecond of
// bandwidth, so the kernel is bound by latency: dependent random row
// reads and the launch itself. Design: one block per query keeps q[b] in
// shared memory; a group of G lanes (a power of two, G = 16-byte chunks
// per row up to 32; 8 lanes for a 128-B int8 row) scores one candidate
// with 16-byte loads, computing the dot and the row norm in one pass,
// and reduces with shuffles inside the group. Each warp has 32/G
// candidates' loads in flight at once; sentinel ids cost nothing. The
// row scorer (`score_row`) and K5's row copy (`copy_row`) live in
// gather.cuh, which the beam kernel (beam.cu) shares.
#include "gather.cuh"

namespace vss {

template <typename T>
__global__ void __launch_bounds__(256)
    gather_dist_kernel(const int32_t* __restrict__ ids,
                       const float* __restrict__ q,
                       const float* __restrict__ qn,
                       const T* __restrict__ table, float* __restrict__ out,
                       int C, int d, int metric, int group, bool vec) {
  extern __shared__ float qs[];
  const int64_t b = blockIdx.x;
  for (int e = threadIdx.x; e < d; e += blockDim.x) qs[e] = q[b * d + e];
  __syncthreads();
  const float qnb = qn[b];
  const int g = threadIdx.x / group;
  const int gl = threadIdx.x % group;
  const int ngroups = blockDim.x / group;
  for (int base = 0; base < C; base += ngroups) {
    const int c = base + g;
    const int id = c < C ? ids[b * C + c] : -1;
    float dot, xn;
    score_row<T>(id >= 0 ? table + static_cast<int64_t>(id) * d : nullptr, qs,
                 d, group, gl, vec, dot, xn);
    if (gl == 0 && c < C)
      out[b * C + c] = id >= 0 ? epilogue(dot, qnb, xn, metric) : CUDART_INF_F;
  }
}

template <typename T>
int launch(const int32_t* ids, const float* q, const float* qn,
           const void* table, float* out, int B, int C, int d, int metric,
           cudaStream_t s) {
  int group;
  bool vec;
  row_grouping<T>(d, group, vec);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_dist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_dist_kernel<T><<<B, 256, smem, s>>>(
      ids, q, qn, static_cast<const T*>(table), out, C, d, metric, group, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vss

extern "C" int vss_gather_distances(const int32_t* ids, const float* q,
                                    const float* qn, const void* table,
                                    float* out, int B, int C, int d,
                                    int dtype, int metric, void* stream) {
  using namespace vss;
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8) return launch<int8_t>(ids, q, qn, table, out, B, C, d, metric, s);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(ids, q, qn, table, out, B, C, d, metric, s);
  return launch<float>(ids, q, qn, table, out, B, C, d, metric, s);
}

// K5: whole-row gather, out[i, :] = table[max(ids[i], 0), :].
//
// Replaces vss_tpu/ops/gather.py:_gather_kernel (launched by
// _gather_rows_impl behind gather_rows_pallas / gather_rows). A copy of
// bytes whatever the element type: int8 / bf16 / f32 vector rows and i32
// adjacency rows. With skip_neg an id < 0 issues no load and its output
// row is zeros (the TPU kernel left it undefined).
//
// Bound on the H100: bytes only, (2 * row_bytes + 4) per row over
// 3.35 TB/s. Permuting a 2M-row tape moves 0.26 GB (128-B int8 rows) or
// 1.0 GB (512-B f32 rows), 0.16 ms and 0.62 ms; one wave's candidate
// gather (1024 x 144 rows of 128 B) moves 38 MB, 0.011 ms, so that shape
// is bound by launch and the latency of dependent random reads. Design:
// nothing of the TPU kernel's rolling DMA window, semaphores, 512-row
// programs or 128-lane width rule is carried over. A power-of-two group
// of lanes copies one row with the widest accesses (16, 8, 4, 2 or 1
// bytes) that the row width and both base pointers allow, neighbouring
// lanes on neighbouring addresses; a warp keeps 32/group rows' loads in
// flight; each block reads its own ids; one block per 256/group rows
// covers the card at any id count. Offsets are 64-bit: rows * row_bytes
// passes 2^31 for large tapes.
namespace vss {

template <typename V>
__global__ void __launch_bounds__(256)
    gather_rows_kernel(const int32_t* __restrict__ ids,
                       const V* __restrict__ table, V* __restrict__ out,
                       int64_t n, int64_t chunks, int group, bool skip_neg) {
  const int rows_per_block = blockDim.x / group;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * rows_per_block + threadIdx.x / group;
  if (i >= n) return;
  const int gl = threadIdx.x % group;
  const int id = ids[i];
  V* dst = out + i * chunks;
  if (id < 0 && skip_neg) {
    const V zero{};
    for (int64_t c = gl; c < chunks; c += group) dst[c] = zero;
    return;
  }
  const V* src = table + static_cast<int64_t>(id < 0 ? 0 : id) * chunks;
  copy_row(dst, src, chunks, gl, group);
}

template <typename V>
int launch_rows(const int32_t* ids, const void* table, void* out, int64_t n,
                int64_t row_bytes, bool skip_neg, cudaStream_t s) {
  const int64_t chunks = row_bytes / static_cast<int64_t>(sizeof(V));
  int group = 1;
  while (group < chunks && group < 32) group <<= 1;
  const int64_t rows_per_block = 256 / group;
  const int64_t blocks = cdiv(n, rows_per_block);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      ids, static_cast<const V*>(table), static_cast<V*>(out), n, chunks,
      group, skip_neg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vss

extern "C" int vss_gather_rows(const int32_t* ids, const void* table,
                               void* out, int64_t n, int64_t row_bytes,
                               int skip_neg, void* stream) {
  using namespace vss;
  if (n <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest access that divides the row width and both base addresses
  const uint64_t align = static_cast<uint64_t>(row_bytes) |
                         reinterpret_cast<uint64_t>(table) |
                         reinterpret_cast<uint64_t>(out);
  const bool skip = skip_neg != 0;
  if (align % 16 == 0)
    return launch_rows<uint4>(ids, table, out, n, row_bytes, skip, s);
  if (align % 8 == 0)
    return launch_rows<uint2>(ids, table, out, n, row_bytes, skip, s);
  if (align % 4 == 0)
    return launch_rows<uint32_t>(ids, table, out, n, row_bytes, skip, s);
  if (align % 2 == 0)
    return launch_rows<uint16_t>(ids, table, out, n, row_bytes, skip, s);
  return launch_rows<uint8_t>(ids, table, out, n, row_bytes, skip, s);
}
