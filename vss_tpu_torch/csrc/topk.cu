// K3: exact-scan segment minima, the oracle's scan.
//
// Replaces vss_tpu/ops/topk.py:_scan_segmin_kernel (launched by
// _segmin_scan_pallas). For every query and every 128-row segment of
// the f32 tape it computes the minimum full distance (l2sq / cosine /
// ip with the _epilogue guards, query norm included), with invalid rows,
// rows past the tape and NaN distances as +inf. Output [ceil(nx/128), nq].
//
// Bound on the H100: 2*nq*nx*d FLOP on f32 inputs against 4*nx*d bytes
// read (512 MB at 10^6 x 128 for 134 GFLOP per 512 queries), so it is
// bound by operations on the f32 pipes (67 TFLOP/s), not by the bytes.
// Design: the shared SIMT tile loop of common.cuh with exact f32 FMAs
// (TF32 would not be exact), row and query norms computed from the staged
// values in the same pass, and the segment minimum taken in registers
// and warp shuffles, so the [nq, nx] distance matrix never reaches
// device memory. One 128-row tile is one segment. precision='default'
// rounds the staged inputs to bf16 first (products exact, sums f32).
#include "common.cuh"

namespace vss {

template <bool ROUND>
__global__ void __launch_bounds__(NT, 2)
    scan_segmin_kernel(const float* __restrict__ q,
                       const float* __restrict__ x,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ out, int nq, int64_t nx, int d,
                       int metric, int q_tiles) {
  __shared__ TileSmem sm;
  int64_t row0;
  int q0;
  tile_origin(q_tiles, row0, q0);
  if (threadIdx.x < TR) {
    const int64_t row = row0 + threadIdx.x;
    sm.ok[threadIdx.x] = row < nx && (valid == nullptr || valid[row]);
  }
  float acc[8][8];
  tile_dots<float, float, true, ROUND>(x, q, nx, nq, d, row0, q0, sm, acc);

  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = tile_row(i);
    const bool ok = sm.ok[lr];
    const float xn = sm.xnorm[lr];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = epilogue(acc[i][j], sm.qnorm[tile_query(j)], xn, metric);
      if (!ok || isnan(v)) v = CUDART_INF_F;
      m[j] = fminf(m[j], v);
    }
  }
  // the 16 threads sharing a query set hold the tile's 128 rows
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m[j] = fminf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
  if ((threadIdx.x & 15) == 0) {
    const int64_t seg = row0 / TR;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = q0 + tile_query(j);
      if (qi < nq) out[seg * nq + qi] = m[j];
    }
  }
}

}  // namespace vss

extern "C" int vss_scan_segmin(const float* q, const float* x,
                               const unsigned char* valid, float* out, int nq,
                               int64_t nx, int d, int metric, int round_bf16,
                               void* stream) {
  using namespace vss;
  if (nq <= 0 || nx <= 0) return 0;
  const int q_tiles = static_cast<int>(cdiv(nq, TQ));
  const int64_t blocks = cdiv(nx, TR) * q_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (round_bf16)
    scan_segmin_kernel<true><<<static_cast<unsigned>(blocks), NT, 0, s>>>(
        q, x, valid, out, nq, nx, d, metric, q_tiles);
  else
    scan_segmin_kernel<false><<<static_cast<unsigned>(blocks), NT, 0, s>>>(
        q, x, valid, out, nq, nx, d, metric, q_tiles);
  return static_cast<int>(cudaGetLastError());
}
