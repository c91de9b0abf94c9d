// The tile code that K2 (scan.cu) and pivot_product (pivots.cu) share:
// rows of a stored tape decoded in registers into wgmma's A fragments,
// against queries written once in shared memory as wgmma's B (128-byte
// swizzle), with a ring of stages per consumer warpgroup. A block is a
// producer warpgroup and CONSUMERS consumer warpgroups; a consumer takes
// tiles of ROWS rows, warp w rows 32w..32w+31 (one sub-segment) in two m64
// tiles (rows 32w + 16 mt + 8 h + g). The kernels differ in their
// queries' image (K2: one bf16 image; pivot_product: three planes), their
// products' width (n64 and n32) and their producers (bulk copies and
// cp.async by slot): see each file's head note.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace vss {

constexpr int ROWS = 128;       // rows of a tile: one consumer's products
constexpr int STEPS = 8;        // k16 steps of a slab, at most (128 columns)
constexpr int CONSUMERS = 2;    // consumer warpgroups a block
constexpr int THREADS = 128 * (1 + CONSUMERS);
// the queries' image: 128-byte swizzle atoms of 8 queries x 64 values
// (4 k16 steps), a query's 128 bytes a row
constexpr int ATOM_ROW = 128;
constexpr int ATOM = 8 * ATOM_ROW;
constexpr int ATOM_STEPS = 4;
constexpr unsigned RING_OFF = 1024;  // the ring's offset in shared memory, after the barriers

inline unsigned align_up(unsigned v, unsigned a) { return (v + a - 1) / a * a; }

// Byte offset of query n, column c (of a slab of 16 S columns) in the
// query image of a tile of nqt queries (1024-byte aligned in shared
// memory): thread t of a row takes columns 4 S t .. 4 S t + 4 S - 1; its
// four columns of step s (4 S t + 4 s + j, j = 0..3) sit at wgmma's k =
// 2t, 2t+1, 2t+8, 2t+9 of that step. Steps 4i..4i+3 of all nqt queries
// are a column of atoms, nqt * 128 bytes; in an atom, query n % 8's row
// holds its 32 bytes of each step, and the 16-byte chunks of a row are
// XORed with the row (128-byte swizzle: K2 ran 5% faster with it than with
// 8 x 8 core matrices without swizzle on an H100 SXM at 700 W).
__device__ __forceinline__ unsigned q_offset(int n, int c, int S, int nqt) {
  const int t = c / (4 * S), r = c % (4 * S);
  const int s = r >> 2, j = r & 3;
  const int k = 2 * t + (j & 1) + 8 * (j >> 1);
  const unsigned a = (s / ATOM_STEPS) * nqt * ATOM_ROW + (n >> 3) * ATOM + (n & 7) * ATOM_ROW +
                     (s % ATOM_STEPS) * 32 + k * 2;
  return a ^ (((a >> 7) & 7) << 4);
}

// The descriptor of B for a product's queries' step whose bytes start at
// shared address `addr`: 128-byte swizzle, SBO one atom (LBO unused).
__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(ATOM >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// two f32 values exact in bf16 -> one bf16x2 word (lo in the low half)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// four stored values (columns 4s..4s+3 of this thread's run, in the words
// at w) -> the two A words: lo = values 0, 1 (k 2t, 2t+1), hi = values 2,
// 3 (k 2t+8, 2t+9)
__device__ __forceinline__ void decode4(const uint32_t* w, int8_t, uint32_t& lo, uint32_t& hi) {
  // bias each byte by 128 and place it under the exponent of 2^23: the
  // f32 value 2^23 + 128 + x, less 2^23 + 128, is x exactly
  const uint32_t u = w[0] ^ 0x80808080u;
  const float m = 8388736.0f;  // 2^23 + 128
  const float v0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - m;
  const float v1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - m;
  const float v2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - m;
  const float v3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - m;
  lo = pack2(v0, v1);
  hi = pack2(v2, v3);
}
__device__ __forceinline__ void decode4(const uint32_t* w, __nv_bfloat16, uint32_t& lo,
                                        uint32_t& hi) {
  lo = w[0];
  hi = w[1];
}
// f32 (K2 alone): each value rounded to bf16, to nearest even
__device__ __forceinline__ void decode4(const uint32_t* w, float, uint32_t& lo, uint32_t& hi) {
  lo = pack2(round_bf16(__uint_as_float(w[0])), round_bf16(__uint_as_float(w[1])));
  hi = pack2(round_bf16(__uint_as_float(w[2])), round_bf16(__uint_as_float(w[3])));
}

// This thread's A fragments of a staged slab of 16 S columns: rows
// 32 warp + 16 mt + 8 h + g of the tile, its run of 4 S columns, read in
// 16-byte loads where the run is a multiple of 16 bytes.
template <typename TX, int S>
__device__ __forceinline__ void decode_slab(uint32_t a[2][STEPS][4], const unsigned char* stage,
                                            int warp, int g, int t) {
  constexpr int WORDS = S * sizeof(TX);  // 32-bit words of a run
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 32 * warp + 16 * mt + 8 * h + g;
      const uint32_t* run = reinterpret_cast<const uint32_t*>(
          stage + (r * 16 * S + 4 * S * t) * static_cast<int>(sizeof(TX)));
      uint32_t w[WORDS];
      if constexpr (WORDS % 4 == 0) {
#pragma unroll
        for (int k = 0; k < WORDS / 4; ++k) {
          const uint4 u = reinterpret_cast<const uint4*>(run)[k];
          w[4 * k] = u.x;
          w[4 * k + 1] = u.y;
          w[4 * k + 2] = u.z;
          w[4 * k + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < WORDS; ++k) w[k] = run[k];
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
        decode4(w + s * sizeof(TX), TX(), a[mt][s][h], a[mt][s][2 + h]);
    }
}

// Wait until at most N groups of products are in flight, then let the
// accumulators (W a row: 32 for n64, 16 for n32) of those that landed be
// read.
template <int N, int W>
__device__ __forceinline__ void await_products(float (&acc)[2][W]) {
  wgmma_wait<N>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < W; ++i) fence_operand(acc[mt][i]);
}

// f(std::integral_constant<int, S>) for the slab's steps S (1..8), so
// that its decode and products are unrolled with no branch between them
template <typename F>
__device__ __forceinline__ void with_steps(int S, F&& f) {
  switch (S) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 5: f(std::integral_constant<int, 5>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 7: f(std::integral_constant<int, 7>()); break;
    default: f(std::integral_constant<int, 8>()); break;
  }
}

// A consumer's place in its ring: the stage and the parity of its next
// use, advanced a use at a time
struct RingPos {
  int st = 0, parity = 0;
  __device__ __forceinline__ void advance(int nsw) {
    if (++st == nsw) {
      st = 0;
      parity ^= 1;
    }
  }
};

}  // namespace vss
