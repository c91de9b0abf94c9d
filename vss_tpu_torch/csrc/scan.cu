// K2: phase A of the storage-native scan, 32-row sub-segment minima.
//
// Replaces vss_tpu/ops/scan.py:_native_segmin_kernel (launched by
// _native_segmin_scan). The tape is read once per query tile in its
// stored dtype (int8 / bf16 / f32); values are decoded to bf16 (exact for
// int8 and bf16, round-to-nearest-even for f32) and multiplied with the
// bf16 query in f32. The proxy distance drops the per-query constant:
// l2sq ||x||^2 - 2 q.x, ip -q.x, cosine -q.x/||x|| (0 for zero rows),
// with the stored-value row norms taken from the precomputed norm tape.
// Invalid rows and rows past the tape give +inf. Output
// [4*ceil(nx/128), nq]: row s is the minimum over tape rows [32s, 32s+32).
//
// Bound on the H100: 2*nq*nx*d products of bf16 inputs (131 G at 512
// queries x 10^6 x 128: 0.1325 ms at 989 TFLOP/s) against ~nx*(d+5) bytes
// in and 4*nq*nx/32 out, so the bound is the tensor cores' bf16 rate; at
// one query the tape's bytes (0.04 ms). The design, for Hopper:
//  * Persistent blocks, one an SM, of three warpgroups: a producer and two
//    consumers. The grid is query tiles x blocks; a block walks the 128-row
//    tape tiles first, first + P, ... and its consumers take them in turn.
//  * The queries resident: a block writes its query tile once, in wgmma's
//    B layout (128-byte swizzle), so each tape tile is read and decoded
//    once per query tile:
//    up to d = 128 as many queries as shared memory holds beside the ring
//    (640 at int8 and bf16, 384 at f32); wider rows go in slabs of 128
//    columns with 64 queries a tile (up to d = 1,536 at int8). Past that
//    the queries are streamed: each consumer writes the queries' slab
//    beside each tape slab.
//  * The tape through a ring of stages, each consumer's own 1-4, which it
//    alone reads, in order (an mbarrier's wait tells a phase only by its
//    parity, so a stage shared by two consumers could be awaited a phase
//    early and pass). Up to d = 128 one thread of the producer warp fills a
//    stage with one bulk copy (cp.async.bulk) of the tile on the stage's
//    mbarrier; a slab of a wider tile is 16-byte cp.async from the
//    producer warpgroup's 128 threads, each reporting its copies to the
//    mbarrier. A consumer releases a stage as soon as it has decoded it.
//  * Decoded in registers, products on wgmma: each thread decodes its A
//    fragment of the tile (int8 by a byte permute and an f32 subtract)
//    from the staged bytes, 16 bytes a load, and keeps it across the
//    query tile's chunks of 64; a chunk is two m64n64k16 products a k16
//    step, issued back to back (the decode and products are unrolled for
//    the slab's step count). The k order is free: thread t of a row takes
//    its 4S consecutive columns (S steps), and the queries are written in
//    the same order. The rows are free too: warp w holds rows
//    32w..32w+31, one sub-segment, in two m64 tiles (rows 32w + 16 mt +
//    8 h + g), so the minimum is taken in registers and by a
//    reduce-scatter of three shuffles after which lane l holds queries 2l
//    and 2l+1.
//  * The epilogue: fmaf(alpha, dot, beta) a value (alpha, beta per row and
//    metric; l2sq's fmaf(-2, dot, n2) equals n2 - 2 dot, as 2 dot is
//    exact), min.NaN, and the select for invalid (or cosine zero) rows only
//    in warps whose sub-segment holds one; one coalesced store a lane. The
//    rows' norms and flags are loaded a tile ahead.
// One group of products is in flight a consumer: the other consumer's
// products run while one decodes or takes its minima. Measured times and
// what holds the kernel back: PERF.md.
#include <type_traits>

#include "common.cuh"
#include "cpasync.cuh"
#include "wgmma.cuh"

namespace vss {
namespace k2 {

constexpr int ROWS = 128;          // tape rows of a tile: one consumer's products
constexpr int NC = 64;             // queries of a product (wgmma's n)
constexpr int SLAB = 128;          // columns a stage holds, at most
constexpr int STEPS = SLAB / 16;   // k16 steps of a slab, at most
constexpr int CONSUMERS = 2;       // consumer warpgroups a block
constexpr int THREADS = 128 * (1 + CONSUMERS);
// the queries' image: 128-byte swizzle atoms of 8 queries x 64 values
// (4 k16 steps), a query's 128 bytes a row
constexpr int ATOM_ROW = 128;
constexpr int ATOM = 8 * ATOM_ROW;
constexpr int ATOM_STEPS = 4;
constexpr unsigned RING_OFF = 1024;  // the ring's offset in shared memory, after the barriers

// The block's plan, the same for every block (computed by `plan` below).
struct Plan {
  int nsw;             // ring stages of each consumer
  int nslab;           // slabs of SLAB columns a tape row
  int nqt;             // queries of a tile (a multiple of NC)
  int q_tiles;         // query tiles
  int per_q;           // blocks a query tile
  int streamed;        // queries written a slab at a time
  int64_t ntiles;      // 128-row tape tiles
  unsigned stage_bytes;
  unsigned q_off;      // byte offset of the queries in shared memory
  unsigned smem;       // bytes of shared memory
};

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

// The descriptor of B for 64 queries' step whose bytes start at shared
// address `addr`: 128-byte swizzle, SBO one atom (LBO unused).
__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(ATOM >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Write queries q0.. (nqt of them, zeros past nq), columns col0..col0+w-1,
// into the image at `dst`, thread `i` of `n`: runs of 8 columns, four
// runs' loads in flight, two columns a store.
__device__ __forceinline__ void stage_queries(unsigned char* dst, const __nv_bfloat16* q, int nq,
                                              int d, int q0, int nqt, int col0, int w, int i,
                                              int n) {
  const int S = w / 16, runs = w / 8, units = nqt * runs;
  for (int u0 = i; u0 < units; u0 += 4 * n) {
    uint4 v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int u = u0 + b * n, qn = u / runs;
      v[b] = make_uint4(0, 0, 0, 0);
      if (u < units && q0 + qn < nq)
        v[b] = *reinterpret_cast<const uint4*>(q + static_cast<int64_t>(q0 + qn) * d + col0 +
                                               8 * (u % runs));
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int u = u0 + b * n, qn = u / runs, c = 8 * (u % runs);
      if (u < units) {
        const uint32_t word[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
          *reinterpret_cast<uint32_t*>(dst + q_offset(qn, c + 2 * m, S, nqt)) = word[m];
      }
    }
  }
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

// Issue the products of a slab of S steps with 64 queries as one group,
// back to back: B's descriptor `desc` for the first step, `dcol` (in its
// address field) a column of atoms after; the sums of earlier slabs kept
// when ACCUMULATE, else the first step writes the accumulators.
template <int S, bool ACCUMULATE>
__device__ __forceinline__ void issue_products(float acc[2][32], const uint32_t a[2][STEPS][4],
                                               uint64_t desc, uint64_t dcol) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint64_t ds = desc + (s / ATOM_STEPS) * dcol + (s % ATOM_STEPS) * (32 >> 4);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (ACCUMULATE || s > 0)
        wgmma_m64n64k16(acc[mt], a[mt][s], ds);
      else
        wgmma_m64n64k16_zero(acc[mt], a[mt][s], ds);
    }
  }
  wgmma_commit();
}

// Wait until at most N groups are in flight, then let the accumulators of
// the group that landed be read.
template <int N>
__device__ __forceinline__ void await_products(float acc[2][32]) {
  wgmma_wait<N>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[mt][i]);
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

// One chunk's minima: `acc` holds the products of the warp's 32 rows
// with queries qb..qb+63; row (mt, h) maps dot to fmaf(alpha, dot, beta),
// or to `sval` where `special` (only when MASK). Lane l writes queries
// qb + 2l and qb + 2l + 1 of output row `orow`.
template <bool MASK>
__device__ __forceinline__ void epilogue(const float acc[2][32], const float alpha[2][2],
                                         const float beta[2][2], const bool special[2][2],
                                         const float sval[2][2], float* __restrict__ out,
                                         int64_t orow, int nq, int qb, int lane) {
  const int g = lane >> 2;
  float m[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = 0.0f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float y = fmaf(alpha[mt][h], acc[mt][4 * j + 2 * h + e], beta[mt][h]);
          if (MASK) y = special[mt][h] ? sval[mt][h] : y;
          v = (mt == 0 && h == 0) ? y : min_nan(v, y);
        }
      m[j][e] = v;
    }
  // the minimum over g (lanes 4g + t), scattered: after the three rounds
  // lane 4g + t holds block j = g, columns 2t and 2t+1
  float r1[4][2], r2[2][2], r3[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool up = g & 4;
      const float send = up ? m[j][e] : m[j + 4][e];
      const float keep = up ? m[j + 4][e] : m[j][e];
      r1[j][e] = min_nan(keep, __shfl_xor_sync(0xffffffffu, send, 16));
    }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool up = g & 2;
      const float send = up ? r1[j][e] : r1[j + 2][e];
      const float keep = up ? r1[j + 2][e] : r1[j][e];
      r2[j][e] = min_nan(keep, __shfl_xor_sync(0xffffffffu, send, 8));
    }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool up = g & 1;
    const float send = up ? r2[0][e] : r2[1][e];
    const float keep = up ? r2[1][e] : r2[0][e];
    r3[e] = min_nan(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
  float* o = out + orow * nq;
  const int qi = qb + 2 * lane;
  if (qi + 1 < nq && !(nq & 1)) {
    *reinterpret_cast<float2*>(o + qi) = make_float2(r3[0], r3[1]);
  } else {
    if (qi < nq) o[qi] = r3[0];
    if (qi + 1 < nq) o[qi + 1] = r3[1];
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

// the index of consumer c's stage st among the ring's stages
__device__ __forceinline__ int ring_stage(const Plan& p, int c, int st) {
  return c * p.nsw + st;
}

// The producer: thread i of n fills the ring. Tile j goes to consumer
// j % 2; the two consumers' tiles 2m and 2m + 1 are filled slab by slab in
// turn, so that both consumers go on at once however many slabs a tile
// has. One thread issues a tile's bulk copy (d <= 128); a slab takes n
// threads' 16-byte copies and one arrival from each.
template <typename TX>
__device__ __forceinline__ void produce(const TX* __restrict__ x, int64_t nx, int d,
                                        const Plan& p, int64_t first, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int i, int n) {
  RingPos pos[CONSUMERS];
  for (int64_t m = 0; first + CONSUMERS * m * p.per_q < p.ntiles; ++m)
    for (int z = 0; z < p.nslab; ++z)
      for (int c = 0; c < CONSUMERS; ++c) {
        const int64_t tile = first + (CONSUMERS * m + c) * p.per_q;
        if (tile >= p.ntiles) break;
        const int64_t row0 = tile * ROWS;
        const int rows = static_cast<int>(nx - row0 < ROWS ? nx - row0 : ROWS);
        const int st = ring_stage(p, c, pos[c].st);
        mbar_wait(&empty[st], pos[c].parity ^ 1);
        pos[c].advance(p.nsw);
        const int col0 = z * SLAB, w = d - col0 < SLAB ? d - col0 : SLAB;
        const int row_bytes = w * sizeof(TX);
        unsigned char* dst = ring + st * p.stage_bytes;
        if (w == d) {  // the tile is one contiguous span: one bulk copy
          if (i == 0) {
            mbar_expect_tx(&full[st], rows * row_bytes);
            bulk_copy(dst, x + row0 * d, rows * row_bytes, &full[st]);
          }
        } else {
          const int per_row = row_bytes / 16;
          const unsigned char* src = reinterpret_cast<const unsigned char*>(x + row0 * d + col0);
          for (int u = i; u < rows * per_row; u += n) {
            const int r = u / per_row, k = 16 * (u % per_row);
            cp_async16(dst + r * row_bytes + k, src + static_cast<int64_t>(r) * d * sizeof(TX) + k,
                       16);
          }
          cp_async_arrive(&full[st]);
        }
      }
}

// A consumer warpgroup (wg 0 or 1): tiles first + (wg + 2i) P.
template <typename TX>
__device__ __forceinline__ void consume(const __nv_bfloat16* __restrict__ q,
                                        const float* __restrict__ xn,
                                        const unsigned char* __restrict__ valid,
                                        float* __restrict__ out, int nq, int64_t nx, int d,
                                        int metric, const Plan& p, int64_t first, int q0,
                                        unsigned char* ring, unsigned char* qs, uint64_t* full,
                                        uint64_t* empty, int wg, int ltid) {
  const int warp = ltid >> 5, lane = ltid & 31, g = lane >> 2, t = lane & 3;
  // this warpgroup's query image: the tile's, or its own slab buffer
  unsigned char* qimg = p.streamed ? qs + wg * NC * SLAB * 2 : qs;
  const unsigned qaddr = smem_addr(qimg);
  const int nchunks = p.nqt / NC;
  const uint64_t dcol = (p.nqt * ATOM_ROW) >> 4;  // a column of atoms, in 16 bytes
  uint32_t a[2][STEPS][4];
  float acc[2][32];
  RingPos pos;
  // this thread's four rows of a tile: 32 warp + 16 mt + 8 h + g; their
  // norms and flags are loaded a tile ahead, so that no tile waits on them
  float n2_next[2][2];
  bool ok_next[2][2];
  auto load_rows = [&](int64_t tile) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = tile * ROWS + 32 * warp + 16 * mt + 8 * h + g;
        const bool in = tile < p.ntiles && r < nx;
        ok_next[mt][h] = in && valid[r];
        n2_next[mt][h] = in ? xn[r] : 0.0f;
      }
  };
  load_rows(first + wg * p.per_q);
  for (int64_t j = wg;; j += CONSUMERS) {
    const int64_t tile = first + j * p.per_q;
    if (tile >= p.ntiles) break;
    // the epilogue's terms for this thread's four rows
    float alpha[2][2], beta[2][2], sval[2][2];
    bool special[2][2], plain = true;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = ok_next[mt][h];
        const float n2 = n2_next[mt][h];
        if (metric == L2SQ) {
          alpha[mt][h] = -2.0f;
          beta[mt][h] = n2;
        } else if (metric == IP) {
          alpha[mt][h] = -1.0f;
          beta[mt][h] = 0.0f;
        } else {  // cosine: -dot/||x||, 0 for zero rows
          alpha[mt][h] = n2 > 0.0f ? -rsqrtf(fmaxf(n2, 1e-30f)) : 0.0f;
          beta[mt][h] = 0.0f;
        }
        special[mt][h] = !ok || (metric == COSINE && !(n2 > 0.0f));
        sval[mt][h] = ok ? 0.0f : CUDART_INF_F;
        plain = plain && !special[mt][h];
      }
    plain = __all_sync(0xffffffffu, plain);
    load_rows(tile + CONSUMERS * p.per_q);
    const int64_t orow = tile * 4 + warp;
    auto minima = [&](const float (&acc)[2][32], int c) {
      if (plain)
        epilogue<false>(acc, alpha, beta, special, sval, out, orow, nq, q0 + c * NC, lane);
      else
        epilogue<true>(acc, alpha, beta, special, sval, out, orow, nq, q0 + c * NC, lane);
    };
    // decode slab z of the tile into `a` and release its stage
    auto take_slab = [&](int z, int w) {
      const int st = ring_stage(p, wg, pos.st);
      mbar_wait(&full[st], pos.parity);
      with_steps(w / 16, [&](auto steps) {
        decode_slab<TX, decltype(steps)::value>(a, ring + st * p.stage_bytes, warp, g, t);
      });
      mbar_arrive(&empty[st]);
      pos.advance(p.nsw);
    };
    if (p.nslab == 1) {
      // one slab, decoded once, then the chunks of 64 queries in turn (the
      // other consumer's products run during this one's minima: a second
      // group in flight here made ptxas serialize the products and spill)
      take_slab(0, d);
      with_steps(d / 16, [&](auto steps) {
        constexpr int S = decltype(steps)::value;
        for (int c = 0; c < nchunks; ++c) {
          issue_products<S, false>(acc, a, b_desc(qaddr + c * (NC / 8) * ATOM), dcol);
          await_products<0>(acc);
          minima(acc, c);
        }
      });
    } else {
      // slab after slab into one chunk's accumulators (nqt is 64 here)
      for (int z = 0; z < p.nslab; ++z) {
        const int col0 = z * SLAB, w = d - col0 < SLAB ? d - col0 : SLAB;
        take_slab(z, w);
        if (p.streamed) {  // this slab of the queries, once the last products are done
          warpgroup_sync(1 + wg);
          stage_queries(qimg, q, nq, d, q0, NC, col0, w, ltid, 128);
          fence_proxy_async();
          warpgroup_sync(1 + wg);
        }
        const unsigned qz =
            qaddr + (p.streamed ? 0 : z * (STEPS / ATOM_STEPS) * p.nqt * ATOM_ROW);
        with_steps(w / 16, [&](auto steps) {
          if (z == 0)
            issue_products<decltype(steps)::value, false>(acc, a, b_desc(qz), dcol);
          else
            issue_products<decltype(steps)::value, true>(acc, a, b_desc(qz), dcol);
        });
        await_products<0>(acc);
      }
      minima(acc, 0);
    }
  }
}

}  // namespace k2

template <typename TX>
__global__ void __launch_bounds__(k2::THREADS, 1)
    native_segmin_kernel(const __nv_bfloat16* __restrict__ q, const TX* __restrict__ x,
                         const float* __restrict__ xn, const unsigned char* __restrict__ valid,
                         float* __restrict__ out, int nq, int64_t nx, int d, int metric,
                         k2::Plan p) {
  using namespace k2;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + CONSUMERS * p.nsw;
  unsigned char* ring = smem + RING_OFF;
  unsigned char* qs = smem + p.q_off;
  const int qt = static_cast<int>(blockIdx.x % p.q_tiles);
  const int64_t first = blockIdx.x / p.q_tiles;
  const int q0 = qt * p.nqt;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < CONSUMERS * p.nsw; ++s) {
      mbar_init(&full[s], p.nslab > 1 ? 128 : 1);  // the producers' copies, or one bulk copy
      mbar_init(&empty[s], 128);
    }
    mbar_init_fence();
  }
  if (!p.streamed)  // the tile's queries, slab after slab
    for (int z = 0; z < p.nslab; ++z)
      stage_queries(qs + z * (STEPS / ATOM_STEPS) * p.nqt * ATOM_ROW, q, nq, d, q0, p.nqt, z * SLAB,
                    d - z * SLAB < SLAB ? d - z * SLAB : SLAB, tid, THREADS);
  fence_proxy_async();
  __syncthreads();
  const int wg = tid >> 7;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    const int producers = p.nslab > 1 ? 128 : 32;  // a warp, its lane 0 copying
    if (tid < producers) produce<TX>(x, nx, d, p, first, ring, full, empty, tid, producers);
  } else {
    setmaxnreg_inc<232>();
    consume<TX>(q, xn, valid, out, nq, nx, d, metric, p, first, q0, ring, qs, full, empty,
                wg - 1, tid & 127);
  }
}

namespace k2 {

inline unsigned align_up(unsigned v, unsigned a) { return (v + a - 1) / a * a; }

// The plan for nq queries over nx rows of d (a multiple of 16) values of
// `elem` bytes, on a card of `sms` SMs with `smem_max` bytes a block.
inline Plan plan(int nq, int64_t nx, int d, int elem, int sms, int smem_max) {
  Plan p;
  const int w = d < SLAB ? d : SLAB;
  p.nslab = static_cast<int>(cdiv(d, SLAB));
  p.stage_bytes = ROWS * w * elem;
  const int q_slabs = CONSUMERS * NC * SLAB * 2;  // the slab buffers when streamed
  // a query's bytes in the image: whole columns of atoms (64 values each)
  const int q_bytes = static_cast<int>(cdiv(d, ATOM_STEPS * 16)) * ATOM_ROW;
  const int nq_pad = static_cast<int>(cdiv(nq, NC)) * NC;
  // resident if 64 queries fit beside 2 stages a consumer (up to 16 KB a
  // stage), or else 1
  p.streamed = 1;
  for (int nsw = p.stage_bytes <= 16384 ? 2 : 1; nsw >= 1 && p.streamed; --nsw) {
    const unsigned q_off = align_up(RING_OFF + CONSUMERS * nsw * p.stage_bytes, 1024);
    const int fit = (smem_max - static_cast<int>(q_off)) / q_bytes / NC * NC;
    if (fit < NC) continue;
    p.streamed = 0;
    p.nsw = nsw;
    p.q_off = q_off;
    p.nqt = p.nslab > 1 ? NC : (nq_pad < fit ? nq_pad : fit);
    p.smem = q_off + p.nqt * q_bytes;
  }
  if (p.streamed) {  // a shorter wait per slab: as many stages as fit, up to 4
    const int fit = (smem_max - 1024 - q_slabs) / (CONSUMERS * static_cast<int>(p.stage_bytes));
    p.nsw = fit < 1 ? 1 : (fit > 4 ? 4 : fit);
    p.q_off = align_up(RING_OFF + CONSUMERS * p.nsw * p.stage_bytes, 1024);
    p.nqt = NC;
    p.smem = p.q_off + q_slabs;
  }
  p.q_tiles = static_cast<int>(cdiv(nq, p.nqt));
  p.ntiles = cdiv(nx, ROWS);
  int per = sms / p.q_tiles;
  if (per < 1) per = 1;
  if (per > p.ntiles) per = static_cast<int>(p.ntiles);
  p.per_q = per;
  return p;
}

}  // namespace k2

template <typename TX>
int launch(const void* q, const void* x, const float* xn, const unsigned char* valid,
           float* out, int nq, int64_t nx, int d, int metric, cudaStream_t s) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const k2::Plan p = k2::plan(nq, nx, d, sizeof(TX), sms, smem_max);
  if (p.nqt < k2::NC || static_cast<int>(p.smem) > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(native_segmin_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       p.smem);
  const unsigned blocks = static_cast<unsigned>(p.q_tiles) * p.per_q;
  native_segmin_kernel<TX><<<blocks, k2::THREADS, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TX*>(x), xn, valid, out, nq, nx,
      d, metric, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vss

extern "C" int vss_native_segmin(const void* q, const void* x, const float* xn,
                                 const unsigned char* valid, float* out,
                                 int nq, int64_t nx, int d, int dtype,
                                 int metric, void* stream) {
  using namespace vss;
  if (nq <= 0 || nx <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8) return launch<int8_t>(q, x, xn, valid, out, nq, nx, d, metric, s);
  if (dtype == BF16) return launch<__nv_bfloat16>(q, x, xn, valid, out, nq, nx, d, metric, s);
  return launch<float>(q, x, xn, valid, out, nq, nx, d, metric, s);
}
