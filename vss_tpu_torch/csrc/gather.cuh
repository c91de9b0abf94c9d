// Per-row device functions of the gather kernels, shared by K1 / K5
// (gather.cu) and the beam kernel (beam.cu): the row scorer and the row
// copy. Both kernels score a row with the same lane grouping, the same
// loads and the same order of fused multiply-adds, so a distance is the
// same to the last bit whichever kernel computed it.
#pragma once

#include "common.cuh"

namespace vss {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// The tape's storage format, read a chunk at a time: one chunk of a row
// is 16 bytes (16 int8, 8 bf16 or 4 f32 values), or with `vec` false
// (rows whose bytes are not a multiple of 16) one element as f32 bits.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, bool vec) {
  uint4 r;
  if (vec) {
    r = *reinterpret_cast<const uint4*>(p);
  } else {
    r.x = __float_as_uint(to_f32(*p));
    r.y = r.z = r.w = 0u;
  }
  return r;
}

// A 16-byte chunk's values as f32: 16 / sizeof(T) of them.
__device__ __forceinline__ void decode(const uint4& r, int8_t, float v[16]) {
  i8x4(r.x, v);
  i8x4(r.y, v + 4);
  i8x4(r.z, v + 8);
  i8x4(r.w, v + 12);
}
__device__ __forceinline__ void decode(const uint4& r, __nv_bfloat16, float v[8]) {
  bf16x2(r.x, v[0], v[1]);
  bf16x2(r.y, v[2], v[3]);
  bf16x2(r.z, v[4], v[5]);
  bf16x2(r.w, v[6], v[7]);
}
__device__ __forceinline__ void decode(const uint4& r, float, float v[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

// one 16-byte chunk at p (16-byte aligned) as f32; f32 chunks by a float4
// load of their own (through `load_chunk`'s uint4, select_kernel<float>
// compiles to other code)
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float v[16]) {
  decode(load_chunk(p, true), T(), v);
}
__device__ __forceinline__ void load_vec(const float* p, float v[16]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// Lanes per row: the power of two at or above the row's 16-byte chunks
// (its elements when the width rules 16-byte loads out), at most a warp.
template <typename T>
inline void row_grouping(int d, int& group, bool& vec) {
  constexpr int VE = 16 / sizeof(T);
  vec = d % VE == 0;
  const int chunks = vec ? d / VE : d;
  group = 1;
  while (group < chunks && group < 32) group <<= 1;
}

// dot(row, qs) and |row|^2 over one row of d elements, by a group of
// `group` lanes of which this is lane `gl`; every lane of the group
// returns both sums. `row` is the row in device or shared memory, or null
// to load nothing (both sums 0). `qs` is the query in shared memory. With
// `vec` the row is read in 16-byte loads (d a multiple of 16 bytes, row
// 16-byte aligned). Every lane of the warp must call this together.
template <typename T>
__device__ __forceinline__ void score_row(const T* row, const float* qs,
                                          int d, int group, int gl, bool vec,
                                          float& dot, float& xn) {
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte load
  dot = 0.0f;
  xn = 0.0f;
  if (row != nullptr) {
    if (vec) {
      for (int v = gl; v < d / VE; v += group) {
        float xv[16];
        load_vec(row + v * VE, xv);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          dot = fmaf(xv[e], qs[v * VE + e], dot);
          xn = fmaf(xv[e], xv[e], xn);
        }
      }
    } else {
      for (int e = gl; e < d; e += group) {
        const float xv = to_f32(row[e]);
        dot = fmaf(xv, qs[e], dot);
        xn = fmaf(xv, xv, xn);
      }
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
    xn += __shfl_xor_sync(0xffffffffu, xn, off);
  }
}

// A 16-byte chunk's values as f32, without the conversion unit for int8
// (`decode`'s I2F runs at a quarter of the FMA rate): each byte b, biased
// to b + 128, becomes the low byte of 2^23's pattern, and 2^23 + 128 is
// subtracted; exact, so the values are `decode`'s bit for bit.
__device__ __forceinline__ void decode_wide(const uint4& r, int8_t, float v[16]) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                         r.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v[4 * j + b] =
          __fsub_rn(__uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7540u | b)), 8388736.0f);
}
template <typename T>
__device__ __forceinline__ void decode_wide(const uint4& r, T, float v[16]) {
  decode(r, T(), v);
}

// Where `score_row_wide` reads query value e of a row of `chunks` 16-byte
// chunks: the values of 4-value quad i of chunk v lie at (i * chunks + v) * 4,
// so that the 32 lanes of a warp, each on its own chunk, read 32
// neighbouring quads (no bank conflict; in the row's own order lanes 64 B
// apart would share banks four ways).
template <typename T>
__device__ __forceinline__ int wide_query_pos(int e, int chunks) {
  constexpr int VE = 16 / sizeof(T);
  return (((e % VE) >> 2) * chunks + e / VE) * 4 + (e & 3);
}

// dot(row, q) and |row|^2 over one row of `chunks` 16-byte chunks, by the
// 32 lanes of a warp, of which this is lane `lane`, with the query `qw` in
// shared memory in `wide_query_pos`'s order; every lane returns both sums.
// `score_row`'s arithmetic with a warp's 32 lanes a row and 16-byte loads
// (lane l sums its chunks l, l + 32, ... in that order with the same
// multiply-adds, then the same xor-shuffle tree), so each distance is
// score_row's to the last bit. `row` in device or shared memory (16-byte
// aligned), or null (both sums 0). Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void score_row_wide(const T* row, const float* qw, int chunks,
                                               int lane, float& dot, float& xn) {
  constexpr int VE = 16 / sizeof(T);
  dot = 0.0f;
  xn = 0.0f;
  if (row != nullptr) {
    for (int v = lane; v < chunks; v += 32) {
      float xv[16];
      decode_wide(load_chunk(row + v * VE, true), T(), xv);
#pragma unroll
      for (int i = 0; i < VE / 4; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + (i * chunks + v) * 4);
        const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dot = fmaf(xv[4 * i + e], qv[e], dot);
          xn = fmaf(xv[4 * i + e], xv[4 * i + e], xn);
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
    xn += __shfl_xor_sync(0xffffffffu, xn, off);
  }
}

// Lane `gl` of `group` copies its share of one row of `chunks` elements
// of type V (a 16-, 8-, 4-, 2- or 1-byte access each), neighbouring lanes
// on neighbouring addresses.
template <typename V>
__device__ __forceinline__ void copy_row(V* dst, const V* src, int64_t chunks,
                                         int gl, int group) {
  for (int64_t c = gl; c < chunks; c += group) dst[c] = src[c];
}

}  // namespace vss
