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
// Bound on the H100: 2*nq*nx*d products of bf16 inputs (131 G at 512
// queries x 10^6 x 128) against ~nx*(d+5) bytes in and 4*nq*nx/32 bytes
// out, so the bound is the tensor cores' bf16 rate. The products run on
// the tensor cores through warp-level mma.sync (m16n8k16, bf16 in, f32
// sums) fed by ldmatrix (mma.cuh). A block of 256 threads scores 128 tape
// rows against 128 queries: each step stages 64 columns of both in shared
// memory as bf16 (the tape decoded on the way), rows padded to 72 values
// so that the 8 row addresses of an ldmatrix fall in distinct banks. Warp
// w owns the 32 rows 32*(w%4).. (one sub-segment, two m16 tiles) and the
// 64 queries 64*(w/4).. (eight n8 tiles): 64 f32 accumulators a thread.
// The sub-segment minimum is taken in registers and by three shuffles,
// so only nx/32 values per query reach device memory, not the [nq, nx]
// proxy matrix. Staging is synchronous (no cp.async / TMA ring), and
// mma.sync reaches only part of wgmma's rate: see PERF.md.
#include "common.cuh"
#include "mma.cuh"

namespace vss {

constexpr int KS = 64;      // columns staged per step
constexpr int LD = KS + 8;  // staged row stride in bf16 values (144 bytes)

struct ScanSmem {
  uint16_t xs[TR][LD];  // tape rows as bf16 bits, [row][column]
  uint16_t qs[TQ][LD];  // queries as bf16 bits, [query][column]
  float xnorm[TR];      // squared norms of the stored rows
  unsigned char ok[TR];  // row is inside the tape and valid
};

// two bf16 bit patterns (from f32 values already exact in bf16) in one word
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

__device__ __forceinline__ void pack16(const float v[16], uint4 o[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    o[h] = make_uint4(pack_bf16(v[8 * h], v[8 * h + 1]),
                      pack_bf16(v[8 * h + 2], v[8 * h + 3]),
                      pack_bf16(v[8 * h + 4], v[8 * h + 5]),
                      pack_bf16(v[8 * h + 6], v[8 * h + 7]));
}

// 16 consecutive stored values -> 16 bf16 (pointer 16-byte aligned)
__device__ __forceinline__ void bf16x16(const int8_t* p, uint4 o[2]) {
  float v[16];
  load16(p, v);  // int8 values are exact in bf16
  pack16(v, o);
}
__device__ __forceinline__ void bf16x16(const __nv_bfloat16* p, uint4 o[2]) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
  o[0] = s[0];
  o[1] = s[1];
}
__device__ __forceinline__ void bf16x16(const float* p, uint4 o[2]) {
  float v[16];
  load16(p, v);
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = round_bf16(v[e]);  // astype(bfloat16)
  pack16(v, o);
}

template <typename TX>
__global__ void __launch_bounds__(NT, 2)
    native_segmin_kernel(const __nv_bfloat16* __restrict__ q,
                         const TX* __restrict__ x,
                         const float* __restrict__ xn,
                         const unsigned char* __restrict__ valid,
                         float* __restrict__ out, int nq, int64_t nx, int d,
                         int metric, int q_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem);
  int64_t row0;
  int q0;
  tile_origin(q_tiles, row0, q0);
  const int tid = threadIdx.x;
  if (tid < TR) {
    const int64_t row = row0 + tid;
    const bool in = row < nx;
    sm.ok[tid] = in && valid[row];
    sm.xnorm[tid] = in ? xn[row] : 0.0f;
  }
  __syncthreads();  // read by the epilogue
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = 32 * (warp & 3);   // the warp's first tile row
  const int wq = 64 * (warp >> 2);  // the warp's first tile query
  // this lane's ldmatrix row addresses: A (rows) takes matrices
  // (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15); B (queries,
  // two n8 tiles) takes (0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  const int a_row = wr + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = wq + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += KS) {
    // stage: 128 rows x 4 runs of 16 columns of each operand, two runs
    // of each a thread; runs past d are left alone (never read), rows
    // past nx and queries past nq are zeros
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = tid + h * NT;
      const int r = u >> 2, c = (u & 3) * 16;
      if (k0 + c < d) {
        uint4 v[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
        if (row0 + r < nx) bf16x16(x + (row0 + r) * d + k0 + c, v);
        uint4* dst = reinterpret_cast<uint4*>(&sm.xs[r][c]);
        dst[0] = v[0];
        dst[1] = v[1];
        uint4 w[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
        if (q0 + r < nq) bf16x16(q + static_cast<int64_t>(q0 + r) * d + k0 + c, w);
        dst = reinterpret_cast<uint4*>(&sm.qs[r][c]);
        dst[0] = w[0];
        dst[1] = w[1];
      }
    }
    __syncthreads();
    const int kn = d - k0 < KS ? d - k0 : KS;  // a multiple of 16
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      if (kk < kn) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], &sm.xs[a_row + 16 * mt][kk + a_col]);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          ldmatrix_x4(b, &sm.qs[b_row + 16 * p][kk + b_col]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc[mt][2 * p], a[mt], b);
            mma_bf16_16816(acc[mt][2 * p + 1], a[mt], b + 2);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: lane 4g + t holds rows wr + 16 mt + g (+8) at queries
  // wq + 8 nt + 2t (lo) and + 1 (hi)
  const int g = lane >> 2, t = lane & 3;
  float lo[8], hi[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) lo[nt] = hi[nt] = CUDART_INF_F;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wr + 16 * mt + g + 8 * h;
      const bool ok = sm.ok[lr];
      const float n2 = sm.xnorm[lr];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dot = acc[mt][nt][2 * h + e];
          float v;
          if (metric == L2SQ)
            v = __fsub_rn(n2, __fmul_rn(2.0f, dot));
          else if (metric == IP)
            v = -dot;
          else
            v = n2 > 0.0f ? __fmul_rn(-dot, rsqrtf(fmaxf(n2, 1e-30f))) : 0.0f;
          if (!ok) v = CUDART_INF_F;
          if (e == 0)
            lo[nt] = nan_min(lo[nt], v);
          else
            hi[nt] = nan_min(hi[nt], v);
        }
    }
  // the minimum over g: the warp's 32 rows, one sub-segment
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      lo[nt] = nan_min(lo[nt], __shfl_xor_sync(0xffffffffu, lo[nt], off));
      hi[nt] = nan_min(hi[nt], __shfl_xor_sync(0xffffffffu, hi[nt], off));
    }
  if (g == 0) {
    float* o = out + (row0 / 32 + (warp & 3)) * nq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int qi = q0 + wq + 8 * nt + 2 * t;
      if (qi < nq) o[qi] = lo[nt];
      if (qi + 1 < nq) o[qi + 1] = hi[nt];
    }
  }
}

template <typename TX>
void launch(const void* q, const void* x, const float* xn,
            const unsigned char* valid, float* out, int nq, int64_t nx, int d,
            int metric, cudaStream_t s) {
  const int q_tiles = static_cast<int>(cdiv(nq, TQ));
  const int64_t blocks = cdiv(nx, TR) * q_tiles;
  native_segmin_kernel<TX><<<static_cast<unsigned>(blocks), NT, sizeof(ScanSmem), s>>>(
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
