// Shared pieces of the port's Hopper kernels (sm_90a).
//
// * `epilogue`: the metric epilogue of vss_tpu/ops/distance.py:_epilogue
//   (l2sq clamped at 0 with NaN kept, cosine zero-vector guards,
//   ip = 1 - dot), with the additions and products rounded one by one so
//   the compiler cannot contract them into an FMA the plain PyTorch
//   version does not do.
// * 16-element row loaders that decode int8 / bf16 / f32 to f32 (exact).
// * `tile_dots`: the SIMT f32 tile loop that K3 (topk.cu) and K4
//   (distance.cu) share. A block of 256 threads scores a tile of
//   128 tape rows against 128 queries, staging 16 columns of both in
//   shared memory per step; each thread keeps an 8x8 block of f32
//   accumulators in registers (rows r*4+{0..3} and 64+r*4+{0..3},
//   queries c*4+{0..3} and 64+c*4+{0..3}, with r = tid % 16 and
//   c = tid / 16). Inner step: four 16-byte shared loads feed 64 FMAs.
//
// Bound on the H100: at the main path's shapes (128 columns, 512
// queries, 10^6 rows) the tile loop does 2*512*128 multiply-adds per
// tape row against 512 B (f32) read, so it is bound by operations, not
// bytes. The SIMT loop runs on the f32 pipes (67 TFLOP/s peak), far under
// the tensor cores; it is kept because it is exact for the f32 oracle
// (TF32 is not) and simple. K2, whose products take bf16 inputs, runs
// them on the tensor cores instead, as Hopper's warpgroup products
// (scan.cu, wgmma.cuh: bound by the bf16 rate, 989 TFLOP/s, the tape
// streamed through a ring of bulk copies and decoded in registers); it
// shares only the enums and `round_bf16` with this file.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

extern "C" const char* vss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace vss {

enum Metric : int { L2SQ = 0, COSINE = 1, IP = 2 };
enum DType : int { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float epilogue(float dot, float qn, float xn,
                                          int metric) {
  if (metric == IP) return __fsub_rn(1.0f, dot);
  if (metric == L2SQ) {
    float v = __fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.0f, dot));
    return v < 0.0f ? 0.0f : v;  // keeps NaN, like jnp.maximum
  }
  float denom = __fsqrt_rn(__fmul_rn(qn, xn));
  float c = denom > 0.0f ? __fdiv_rn(dot, denom) : 0.0f;
  return (qn == 0.0f && xn == 0.0f) ? 0.0f : __fsub_rn(1.0f, c);
}

// min that keeps NaN (jnp.min / torch.amin semantics)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- 16 consecutive elements -> f32 (pointer 16-byte aligned)
__device__ __forceinline__ void load16(const float* p, float v[16]) {
  const float4* s = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 a = s[i];
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}

__device__ __forceinline__ void bf16x2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[16]) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 u = s[i];
    bf16x2(u.x, v[8 * i], v[8 * i + 1]);
    bf16x2(u.y, v[8 * i + 2], v[8 * i + 3]);
    bf16x2(u.z, v[8 * i + 4], v[8 * i + 5]);
    bf16x2(u.w, v[8 * i + 6], v[8 * i + 7]);
  }
}

__device__ __forceinline__ void i8x4(uint32_t w, float* v) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    v[b] = static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xffu));
}

__device__ __forceinline__ void load16(const int8_t* p, float v[16]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  i8x4(u.x, v);
  i8x4(u.y, v + 4);
  i8x4(u.z, v + 8);
  i8x4(u.w, v + 12);
}

// ---- the shared tile loop
constexpr int TR = 128;  // tape rows per block
constexpr int TQ = 128;  // queries per block
constexpr int TK = 16;   // columns staged per step
constexpr int NT = 256;  // threads per block
constexpr int PAD = 4;   // keeps rows 16-byte aligned for float4 reads

struct TileSmem {
  float xs[TK][TR + PAD];  // staged tape columns, [column][row]
  float qs[TK][TQ + PAD];  // staged query columns, [column][query]
  float xnorm[TR];         // squared row norms (computed or staged)
  float qnorm[TQ];         // squared query norms (computed)
  unsigned char ok[TR];    // row is inside the tape and valid
};

// tile-local row / query held in accumulator slot i / j by this thread
__device__ __forceinline__ int tile_row(int i) {
  const int r = threadIdx.x & 15;
  return i < 4 ? r * 4 + i : 64 + r * 4 + (i - 4);
}
__device__ __forceinline__ int tile_query(int j) {
  const int c = threadIdx.x >> 4;
  return j < 4 ? c * 4 + j : 64 + c * 4 + (j - 4);
}

// Decode the block index into (first tape row, first query): query tiles
// vary fastest so the blocks sharing one tape tile run together and the
// tile is read from device memory about once.
__device__ __forceinline__ void tile_origin(int q_tiles, int64_t& row0,
                                            int& q0) {
  const int64_t bid = blockIdx.x;
  q0 = static_cast<int>(bid % q_tiles) * TQ;
  row0 = (bid / q_tiles) * TR;
}

// acc[i][j] = sum_k x[row0 + tile_row(i), k] * q[q0 + tile_query(j), k].
// Threads 0..127 stage one tape row each, 128..255 one query each, 16
// columns (one or more 16-byte loads) per step. NORMS: also write the
// squared norms of the unrounded values to sm.xnorm / sm.qnorm. ROUND:
// round staged values to bf16 first (bf16-input products, f32 sums).
// Rows past nx and queries past nq stage zeros; d % 16 == 0.
template <typename TX, typename TQT, bool NORMS, bool ROUND>
__device__ __forceinline__ void tile_dots(const TX* __restrict__ x,
                                          const TQT* __restrict__ q,
                                          int64_t nx, int nq, int d,
                                          int64_t row0, int q0, TileSmem& sm,
                                          float acc[8][8]) {
  const int t = threadIdx.x;
  const bool stage_x = t < TR;
  const int lr = stage_x ? t : t - TR;
  const bool live = stage_x ? (row0 + lr < nx) : (q0 + lr < nq);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int r4 = (t & 15) * 4;
  const int c4 = (t >> 4) * 4;
  for (int k0 = 0; k0 < d; k0 += TK) {
    float v[16];
    if (live) {
      if (stage_x)
        load16(x + (row0 + lr) * d + k0, v);
      else
        load16(q + static_cast<int64_t>(q0 + lr) * d + k0, v);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = 0.0f;
    }
    if (NORMS) {
#pragma unroll
      for (int e = 0; e < 16; ++e) sq = fmaf(v[e], v[e], sq);
    }
    if (ROUND) {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = round_bf16(v[e]);
    }
    float(*dst)[TR + PAD] = stage_x ? sm.xs : sm.qs;
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e][lr] = v[e];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.xs[k][r4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.xs[k][64 + r4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.qs[k][c4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.qs[k][64 + c4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (NORMS) {
    if (stage_x)
      sm.xnorm[lr] = sq;
    else
      sm.qnorm[lr] = sq;
    __syncthreads();
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace vss
