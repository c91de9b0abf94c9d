// K2: phase A of the storage-native scan, 32-row sub-segment minima.
//
// Replaces vss_tpu/ops/scan.py:_native_segmin_kernel (launched by
// _native_segmin_scan). The tape is read once per 128-query block in its
// stored dtype (int8 / bf16 / f32); values are decoded to bf16 (exact for
// int8 and bf16, round-to-nearest-even for f32) and multiplied with the
// bf16 query in f32. The proxy distance drops the per-query constant:
// l2sq ||x||^2 - 2 q.x, ip -q.x, cosine -q.x/||x|| (0 for zero rows),
// with the stored-value row norms taken from the precomputed norm tape.
// Invalid rows and rows past the tape give +inf. Output
// [4*ceil(nx/128), nq]: row s is the minimum over tape rows [32s, 32s+32).
//
// Bound on the H100: 2*nq*nx*d products of bf16 inputs (134 G at 512
// queries x 10^6 x 128) against ~nx*(d+5) bytes in and 4*nq*nx/32 bytes
// out. The work is bf16 products, so the bound is the tensor cores'
// operation rate; this first kernel runs them on the SIMT f32 pipes (see
// common.cuh), well above that bound. What it does keep from the TPU
// design: the sub-segment minimum is fused into the epilogue (registers
// and warp shuffles), so only nx/32 values per query reach device
// memory, not the [nq, nx] proxy matrix. The TPU kernel's corpus
// chunking and transposed layout were VMEM workarounds and are gone.
#include "common.cuh"

namespace vss {

template <typename TX>
__global__ void __launch_bounds__(NT, 2)
    native_segmin_kernel(const __nv_bfloat16* __restrict__ q,
                         const TX* __restrict__ x,
                         const float* __restrict__ xn,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ out, int nq, int64_t nx, int d,
                         int metric, int q_tiles) {
  __shared__ TileSmem sm;
  int64_t row0;
  int q0;
  tile_origin(q_tiles, row0, q0);
  if (threadIdx.x < TR) {
    const int64_t row = row0 + threadIdx.x;
    const bool in = row < nx;
    sm.ok[threadIdx.x] = in && valid[row];
    sm.xnorm[threadIdx.x] = in ? xn[row] : 0.0f;
  }
  float acc[8][8];
  // an f32 tape rounds to bf16 like the TPU kernel's astype(bfloat16);
  // int8 and bf16 values are already exact in bf16
  tile_dots<TX, __nv_bfloat16, false, sizeof(TX) == 4>(x, q, nx, nq, d, row0,
                                                       q0, sm, acc);
  float lo[8], hi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) lo[j] = hi[j] = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = tile_row(i);
    const bool ok = sm.ok[lr];
    const float n2 = sm.xnorm[lr];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dot = acc[i][j];
      float v;
      if (metric == L2SQ)
        v = __fsub_rn(n2, __fmul_rn(2.0f, dot));
      else if (metric == IP)
        v = -dot;
      else
        v = n2 > 0.0f ? __fmul_rn(-dot, rsqrtf(fmaxf(n2, 1e-30f))) : 0.0f;
      if (!ok) v = CUDART_INF_F;
      if (i < 4)
        lo[j] = nan_min(lo[j], v);
      else
        hi[j] = nan_min(hi[j], v);
    }
  }
  // threads r = 0..7 hold rows 0..31 (lo) and 64..95 (hi); r = 8..15
  // hold rows 32..63 and 96..127
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lo[j] = nan_min(lo[j], __shfl_xor_sync(0xffffffffu, lo[j], off));
      hi[j] = nan_min(hi[j], __shfl_xor_sync(0xffffffffu, hi[j], off));
    }
  const int r = threadIdx.x & 15;
  if ((r & 7) == 0) {
    const int64_t sub = row0 / 32 + (r >> 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = q0 + tile_query(j);
      if (qi < nq) {
        out[sub * nq + qi] = lo[j];
        out[(sub + 2) * nq + qi] = hi[j];
      }
    }
  }
}

template <typename TX>
void launch(const void* q, const void* x, const float* xn,
            const unsigned char* valid, float* out, int nq, int64_t nx, int d,
            int metric, cudaStream_t s) {
  const int q_tiles = static_cast<int>(cdiv(nq, TQ));
  const int64_t blocks = cdiv(nx, TR) * q_tiles;
  native_segmin_kernel<TX><<<static_cast<unsigned>(blocks), NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TX*>(x), xn,
      valid, out, nq, nx, d, metric, q_tiles);
}

}  // namespace vss

extern "C" int vss_native_segmin(const void* q, const void* x, const float* xn,
                                 const unsigned char* valid, float* out,
                                 int nq, int64_t nx, int d, int dtype,
                                 int metric, void* stream) {
  using namespace vss;
  if (nq <= 0 || nx <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8)
    launch<int8_t>(q, x, xn, valid, out, nq, nx, d, metric, s);
  else if (dtype == BF16)
    launch<__nv_bfloat16>(q, x, xn, valid, out, nq, nx, d, metric, s);
  else
    launch<float>(q, x, xn, valid, out, nq, nx, d, metric, s);
  return static_cast<int>(cudaGetLastError());
}
