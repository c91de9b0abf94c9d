// K4: tiled pairwise distance matrix with the metric epilogue fused in.
//
// Replaces vss_tpu/ops/distance.py:_pairwise_kernel (launched by
// _pairwise_pallas_padded). out[i, j] = distance(q[i], x[j]) at exact
// f32 for l2sq / cosine / ip, shape [nq, nx].
//
// Bound on the H100: 2*nq*nx*d FLOP on f32 inputs and 4*nq*nx bytes of
// output; at d=128 that is 64 FLOP per output byte, above the f32 pipes'
// ridge (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by operations.
// Design: K3's tile loop (common.cuh) with exact f32 FMAs and both norms
// computed in the same pass; the epilogue is applied in registers and
// each thread writes its 4 consecutive tape rows per query as one
// 16-byte store where the row count allows it.
#include "common.cuh"

namespace vss {

__global__ void __launch_bounds__(NT, 2)
    pairwise_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    float* __restrict__ out, int nq, int64_t nx, int d,
                    int metric, int q_tiles) {
  __shared__ TileSmem sm;
  int64_t row0;
  int q0;
  tile_origin(q_tiles, row0, q0);
  float acc[8][8];
  tile_dots<float, float, true, false>(x, q, nx, nq, d, row0, q0, sm, acc);
  const bool vec = (nx % 4) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qi = q0 + tile_query(j);
    if (qi >= nq) continue;
    const float qn = sm.qnorm[tile_query(j)];
    float* orow = out + static_cast<int64_t>(qi) * nx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = tile_row(4 * h);  // first of 4 consecutive rows
      const int64_t row = row0 + lr;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = epilogue(acc[4 * h + i][j], qn, sm.xnorm[lr + i], metric);
      if (vec && row + 3 < nx) {
        *reinterpret_cast<float4*>(orow + row) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (row + i < nx) orow[row + i] = v[i];
      }
    }
  }
}

}  // namespace vss

extern "C" int vss_pairwise(const float* q, const float* x, float* out, int nq,
                            int64_t nx, int d, int metric, void* stream) {
  using namespace vss;
  if (nq <= 0 || nx <= 0) return 0;
  const int q_tiles = static_cast<int>(cdiv(nq, TQ));
  const int64_t blocks = cdiv(nx, TR) * q_tiles;
  pairwise_kernel<<<static_cast<unsigned>(blocks), NT, 0,
                    static_cast<cudaStream_t>(stream)>>>(q, x, out, nq, nx, d,
                                                         metric, q_tiles);
  return static_cast<int>(cudaGetLastError());
}
