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

// one 16-byte load: 16 int8, 8 bf16 or 4 f32 values
__device__ __forceinline__ void load_vec(const int8_t* p, float v[16]) {
  load16(p, v);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float v[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  bf16x2(u.x, v[0], v[1]);
  bf16x2(u.y, v[2], v[3]);
  bf16x2(u.z, v[4], v[5]);
  bf16x2(u.w, v[6], v[7]);
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

// Lane `gl` of `group` copies its share of one row of `chunks` elements
// of type V (a 16-, 8-, 4-, 2- or 1-byte access each), neighbouring lanes
// on neighbouring addresses.
template <typename V>
__device__ __forceinline__ void copy_row(V* dst, const V* src, int64_t chunks,
                                         int gl, int group) {
  for (int64_t c = gl; c < chunks; c += group) dst[c] = src[c];
}

}  // namespace vss
