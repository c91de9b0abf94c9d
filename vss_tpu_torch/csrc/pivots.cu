// pivot_product: the graph search's pivot product on the tensor cores,
// dots[b, p] = q[b] . x[p] in f32, [B, P] row-major, over the pivots' rows
// x [P, d] as the tape stores them; 0 where slot_p is -1 (for finite
// queries).
//
// Replaces the product of the pivot seeding that the JAX package leaves
// to XLA (vss_tpu/index/search.py:451-493, `pivot_seeds`: dot_general of
// the f32 queries with the pivots' f32 rows), which the port ran as a
// cuBLAS f32 GEMM on the SIMT pipes. The `pivot_seeds` kernel (seeds.cu)
// takes the product as it took cuBLAS's.
//
// The product stays f32-accurate on bf16 inputs. The pivots' rows are the
// tape's, int8 or bf16, exact in bf16, read from the contiguous copy of
// them that the pivot caches keep: gathered from the 1M-row tape by slot
// in 64-byte pieces, the same product took 1.36 ms, read from the copy
// 0.55 ms, on an H100 SXM at 700 W. A
// query row q is split into three bf16 planes: hi = q' cut to bf16 (its
// f32 bits with the low 16 cleared), mid = (q' - hi) cut, lo =
// (q' - hi - mid) cut, with q' = q 2^s. Each cut keeps the top 8
// significant bits of what is left, so hi + mid + lo = q' bit for bit
// wherever every set bit of q' is worth at least 2^-133, the least bf16
// subnormal. s, a whole number in [0, 23] a query, is the least that lifts
// the row's lowest set bit to 2^-126, so that no plane and no product is
// subnormal, capped so that the row's largest value stays below 2; 0 for a
// row with an inf or a NaN, which goes whole into hi. So the split is
// exact for every query whose lowest set bit is worth 2^-126 or more, or
// lies at most 126 binades below its highest: all values of 2^-103 or
// more, and every row of subnormals. A product of a plane value (8 bits)
// and a pivot value (8 bits) is exact in f32, and
// the three planes' products go into one f32 accumulator, so the result
// is the f32 product up to the order of its sums (the f32 dot bound
// 2 d 2^-24 sum |q||x|, held in tests), times 2^-s (exact unless the
// result is subnormal). Past the split's reach a value loses its bits
// below 2^(-133-s), and the product at most those times |x|. The one
// product that can overflow where the f32 one would not: a query with
// s > 0 against a bf16 tape whose values pass 2^127 / 2d.
//
// Bound on the H100: 6 B P d operations of bf16 inputs (three planes:
// 193 G at 512 queries x 65,536 pivots x 960, 0.195 ms at 989 TFLOP/s)
// against P d bytes of pivot rows, 4 B d of queries and 4 B P of output
// (0.06 ms at 3.35 TB/s): the bound is the tensor cores' rate. The
// design is K2's (scan.cu), with its decode, query image and ring
// (tiles.cuh):
//  * Persistent blocks of three warpgroups: a producer and two consumers.
//    The grid is query tiles x blocks; a block walks the 128-row pivot
//    tiles first, first + per_q, ... and its consumers take them in turn,
//    so the blocks of all query tiles read each pivot tile at about the
//    same time and the tape is read from device memory about once.
//  * The queries resident in wgmma's B layout (128-byte swizzle), three
//    planes each, written once a block with each row's s. Rows of up to
//    128 values (d16, the width padded to whole k16 steps) are one slab:
//    as many queries as fit beside two stages a consumer, a multiple of
//    32 (192 at d = 128 int8). Wider rows go in slabs of 128 columns, or
//    of 64 where 128 do not fit (int8 above 1,024, bf16 above 832), with
//    32 queries a tile, which is what shared memory holds at
//    the gist width: 32 x 960 x 3 planes x 2 bytes = 184,320 bytes, the
//    ring of 128-column stages (one a consumer, 16 KB each) 32,768, the
//    barriers 1,024 and the shifts 128, 218,240 of the block's 232,448.
//    Wider rows (above 1,088 at int8, 1,024 at bf16) go in column
//    groups: the fewest of equal width in whole atoms (64 columns) whose
//    planes fit, one launch a group over the same tiles, each group's
//    products added to the sums of those before it in `out` (the
//    text-embedding width 1,536: two groups of 768 columns, 128-column
//    slabs, two stages a consumer). A group's queries get their own s
//    over its columns. Group i's sum is within 2 w_i 2^-24 S_i of its
//    columns' (S_i: their sum |q||x|), and each addition within 2^-24 S,
//    so g >= 2 groups stay within (2 max w_i + g) 2^-24 S <= 2 d 2^-24 S,
//    the f32 dot bound, at every width; a one-hot pivot's value comes from one
//    group and zeros from the others, so it stays bit for bit.
//  * The pivot rows through a ring of stages, each consumer's own:
//    producer thread i copies row i of each tile (zeros where its slot is
//    -1), in 16-byte cp.async with the tail zero-filled where a row is a
//    whole number of 16-byte chunks, else value by value; each producer
//    thread reports its copies to the stage's mbarrier.
//  * Decoded once in registers, products on wgmma m64n32k16: each
//    consumer thread decodes its A fragment of a slab (int8 by a byte
//    permute and an f32 subtract) and issues the three planes' products
//    with it into one accumulator, so the decode is paid once for three
//    products and the accumulator is half K2's. Wide rows keep two
//    fragments, so that slab z + 1 is decoded while slab z's products
//    run; a one-slab tile's fragment is kept across the query tile's
//    chunks of 32.
//  * The epilogue multiplies by 2^-s and writes each thread's 32 values;
//    a warp's store covers four runs of eight consecutive pivots.
// The other consumer's products run while one waits on its ring or
// stores. Measured times: PERF.md.
#include <type_traits>

#include "cpasync.cuh"
#include "tiles.cuh"

namespace vss {
namespace pp {

constexpr int NC = 32;           // queries of a product (wgmma's n)
constexpr int PLANES = 3;        // hi, mid, lo
constexpr int ATOM_COLS = 64;    // columns of an atom of the queries' image

// The block's plan, the same for every block (computed by `plan` below).
struct Plan {
  int d16;             // the row width padded to whole k16 steps
  int slab;            // columns a stage holds (the last slab may hold fewer)
  int nslab;           // slabs a row
  int nsw;             // ring stages of each consumer
  int nqt;             // queries of a tile (a multiple of NC)
  int q_tiles;         // query tiles
  int per_q;           // blocks a query tile
  int64_t ntiles;      // 128-row pivot tiles
  unsigned stage_bytes;
  unsigned q_off;      // byte offset of the query image in shared memory
  unsigned plane_bytes;  // one plane of the image: nqt queries x d16 values
  unsigned shift_off;  // each query's s
  unsigned smem;       // bytes of shared memory
};

// s of a query row (the head note), by one warp: the row's highest and
// lowest set bits, and whether it holds an inf or a NaN
__device__ __forceinline__ int query_shift(const float* row, int d, int lane) {
  int top = -1000, low = 1000, bad = 0;
  for (int k = lane; k < d; k += 32) {
    const uint32_t u = __float_as_uint(row[k]);
    const int e = static_cast<int>((u >> 23) & 0xff);
    const uint32_t m = u & 0x7fffffu;
    if (e == 0xff) {
      bad = 1;
    } else if (e != 0) {
      top = e - 127 > top ? e - 127 : top;
      const int l = e - 151 + __ffs(static_cast<int>(m | 0x800000u));
      low = l < low ? l : low;
    } else if (m != 0) {  // subnormal: m 2^-149
      const int h = 63 - __clzll(static_cast<long long>(m)) - 149;
      top = h > top ? h : top;
      const int l = __ffs(static_cast<int>(m)) - 150;
      low = l < low ? l : low;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int t2 = __shfl_xor_sync(0xffffffffu, top, o);
    const int l2 = __shfl_xor_sync(0xffffffffu, low, o);
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
    top = t2 > top ? t2 : top;
    low = l2 < low ? l2 : low;
  }
  if (bad || low > 500) return 0;  // an inf or a NaN, or a row of zeros
  const int s = -126 - low < -top ? -126 - low : -top;
  return s > 0 ? s : 0;
}

// The three bf16 planes of v 2^s, as bit patterns (the head note); an inf
// or a NaN goes whole into hi (a NaN stays one), a zero keeps its sign in
// every plane.
__device__ __forceinline__ void split3(float v, int s, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7f800000u) == 0x7f800000u) {
    hi = (u >> 16) | ((u & 0x7fffffu) ? 0x40u : 0u);
    mid = lo = 0;
    return;
  }
  if ((u & 0x7fffffffu) == 0) {
    hi = mid = lo = u >> 16;
    return;
  }
  const float x = __fmul_rn(v, __uint_as_float(static_cast<uint32_t>(127 + s) << 23));
  const uint32_t ux = __float_as_uint(x);
  const float r1 = __fsub_rn(x, __uint_as_float(ux & 0xffff0000u));
  const uint32_t u1 = __float_as_uint(r1);
  const float r2 = __fsub_rn(r1, __uint_as_float(u1 & 0xffff0000u));
  hi = ux >> 16;
  mid = u1 >> 16;
  lo = __float_as_uint(r2) >> 16;
}

// Write the three planes of queries q0.. (nqt of them, zeros past nq; d
// values a row, rows ld apart) into the image at `img`, thread `i` of
// `n`: two columns a unit, one 32-bit store a plane.
__device__ __forceinline__ void stage_queries(unsigned char* img, const float* q,
                                              const int* shift, int nq, int d, int64_t ld,
                                              int q0, const Plan& p, int i, int n) {
  const int half = p.d16 / 2;
  for (int u = i; u < p.nqt * half; u += n) {
    const int qn = u / half, c = 2 * (u % half);
    float v0 = 0.0f, v1 = 0.0f;
    if (q0 + qn < nq) {
      const float* row = q + (q0 + qn) * ld;
      if (c < d) v0 = row[c];
      if (c + 1 < d) v1 = row[c + 1];
    }
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(v0, shift[qn], h0, m0, l0);
    split3(v1, shift[qn], h1, m1, l1);
    const int z = c / p.slab, cz = c - z * p.slab;
    const int w = p.d16 - z * p.slab < p.slab ? p.d16 - z * p.slab : p.slab;
    unsigned char* at = img + z * (p.slab / ATOM_COLS) * p.nqt * ATOM_ROW +
                        q_offset(qn, cz, w / 16, p.nqt);
    *reinterpret_cast<uint32_t*>(at) = h0 | (h1 << 16);
    *reinterpret_cast<uint32_t*>(at + p.plane_bytes) = m0 | (m1 << 16);
    *reinterpret_cast<uint32_t*>(at + 2 * p.plane_bytes) = l0 | (l1 << 16);
  }
}

// Issue the products of a slab of S steps with 32 queries, the three
// planes with the same A, as one group: B's descriptor `desc` for the hi
// plane's first step, `dcol` (in its address field) a column of atoms
// after, `dplane` a plane after; the sums of earlier slabs kept when
// ACCUMULATE, else the first product writes the accumulators.
template <int S, bool ACCUMULATE>
__device__ __forceinline__ void issue_planes(float acc[2][16],
                                             const uint32_t a[2][STEPS][4], uint64_t desc,
                                             uint64_t dcol, uint64_t dplane) {
  wgmma_fence();
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl) {  // hi, mid, lo
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint64_t ds =
          desc + pl * dplane + (s / ATOM_STEPS) * dcol + (s % ATOM_STEPS) * (32 >> 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (ACCUMULATE || pl > 0 || s > 0)
          wgmma_m64n32k16(acc[mt], a[mt][s], ds);
        else
          wgmma_m64n32k16_zero(acc[mt], a[mt][s], ds);
      }
    }
  }
  wgmma_commit();
}

// the columns of slab z
__device__ __forceinline__ int slab_width(const Plan& p, int z) {
  const int left = p.d16 - z * p.slab;
  return left < p.slab ? left : p.slab;
}

// The producer: thread i (of 128) copies row i of every tile of the
// pivots' rows into the ring. Tile j goes to consumer j % 2; the two consumers' tiles 2m and
// 2m + 1 are filled slab by slab in turn. A row past P or of slot -1 is
// zeros; the columns past d are zeros (rows ld values apart). `wide`:
// rows that start on 16 bytes, copied by cp.async in 16-byte chunks; else
// value by value.
template <typename TX>
__device__ __forceinline__ void produce(const TX* __restrict__ rows, const int* __restrict__ slots,
                                        int P, int d, int64_t ld, bool wide, const Plan& p,
                                        int64_t first,
                                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        int i) {
  using Raw = typename std::conditional<sizeof(TX) == 1, uint8_t, uint16_t>::type;
  RingPos pos[CONSUMERS];
  for (int64_t m = 0; first + CONSUMERS * m * p.per_q < p.ntiles; ++m) {
    int slot[CONSUMERS];
#pragma unroll
    for (int c = 0; c < CONSUMERS; ++c) {
      const int64_t r = (first + (CONSUMERS * m + c) * p.per_q) * ROWS + i;
      slot[c] = r < P ? slots[r] : -1;
    }
    for (int z = 0; z < p.nslab; ++z)
      for (int c = 0; c < CONSUMERS; ++c) {
        if (first + (CONSUMERS * m + c) * p.per_q >= p.ntiles) break;
        const int st = c * p.nsw + pos[c].st;
        mbar_wait(&empty[st], pos[c].parity ^ 1);
        pos[c].advance(p.nsw);
        const int col0 = z * p.slab, w = slab_width(p, z);
        const int have = slot[c] < 0 ? 0 : (d - col0 < w ? d - col0 : w);  // columns of the row
        unsigned char* dst = ring + st * p.stage_bytes + i * w * static_cast<int>(sizeof(TX));
        const int64_t row = slot[c] < 0 ? 0 : (first + (CONSUMERS * m + c) * p.per_q) * ROWS + i;
        const TX* src = rows + row * ld + col0;
        if (wide) {
          const int bytes = have * static_cast<int>(sizeof(TX));
          const unsigned char* s8 = reinterpret_cast<const unsigned char*>(src);
          for (int k = 0; k < w * static_cast<int>(sizeof(TX)); k += 16) {
            const int n = bytes - k < 0 ? 0 : (bytes - k > 16 ? 16 : bytes - k);
            cp_async16(dst + k, s8 + (n > 0 ? k : 0), n);
          }
          cp_async_arrive(&full[st]);
        } else {
          const Raw* s = reinterpret_cast<const Raw*>(src);
          Raw* o = reinterpret_cast<Raw*>(dst);
          for (int k = 0; k < w; ++k) o[k] = k < have ? s[k] : Raw(0);
          mbar_arrive(&full[st]);
        }
      }
  }
}

// A consumer warpgroup (wg 0 or 1): tiles first + (wg + 2i) per_q.
template <typename TX>
__device__ __forceinline__ void consume(float* __restrict__ out, int nq, int P, bool accumulate,
                                        const Plan& p, int64_t first, int q0,
                                        const unsigned char* ring,
                                        const unsigned char* qs, const int* shift,
                                        uint64_t* full, uint64_t* empty, int wg, int ltid) {
  const int warp = ltid >> 5, lane = ltid & 31, g = lane >> 2, t = lane & 3;
  const unsigned qaddr = smem_addr(qs);
  const int nchunks = p.nqt / NC;
  const uint64_t dcol = (p.nqt * ATOM_ROW) >> 4;  // a column of atoms, in 16 bytes
  const uint64_t dplane = p.plane_bytes >> 4;
  uint32_t a[2][2][STEPS][4];  // two A fragments: one decoded while the other's products run
  float acc[2][16];
  RingPos pos;
  for (int64_t j = wg;; j += CONSUMERS) {
    const int64_t tile = first + j * p.per_q;
    if (tile >= p.ntiles) break;
    // decode a slab of the tile into `frag` and release its stage
    auto take_slab = [&](uint32_t (&frag)[2][STEPS][4], int w) {
      const int st = wg * p.nsw + pos.st;
      mbar_wait(&full[st], pos.parity);
      with_steps(w / 16, [&](auto steps) {
        decode_slab<TX, decltype(steps)::value>(frag, ring + st * p.stage_bytes, warp, g, t);
      });
      mbar_arrive(&empty[st]);
      pos.advance(p.nsw);
    };
    // chunk c's products, times 2^-s, into out (added to what is there
    // when `accumulate`: an earlier column group's sums, which this thread
    // wrote): lane (g, t) holds pivot rows 32 warp + 16 mt + 8 h + g and
    // queries 8 j + 2 t + e
    auto store = [&](int c) {
      const int qb = c * NC;
#pragma unroll
      for (int jn = 0; jn < NC / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qb + 8 * jn + 2 * t + e;
          if (q0 + qi >= nq) continue;
          const float scale = __uint_as_float(static_cast<uint32_t>(127 - shift[qi]) << 23);
          float* o = out + static_cast<int64_t>(q0 + qi) * P;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int64_t r = tile * ROWS + 32 * warp + 16 * mt + 8 * h + g;
              if (r < P) {
                const float v = __fmul_rn(acc[mt][4 * jn + 2 * h + e], scale);
                o[r] = accumulate ? __fadd_rn(o[r], v) : v;
              }
            }
        }
    };
    if (p.nslab == 1) {
      // one slab, decoded once, then the chunks of 32 queries in turn
      take_slab(a[0], p.d16);
      with_steps(p.d16 / 16, [&](auto steps) {
        constexpr int S = decltype(steps)::value;
        for (int c = 0; c < nchunks; ++c) {
          issue_planes<S, false>(acc, a[0], b_desc(qaddr + c * (NC / 8) * ATOM), dcol, dplane);
          await_products<0>(acc);
          store(c);
        }
      });
    } else {
      // slab after slab into the one chunk's accumulators (nqt is 32
      // here), slab z's fragment in a[z % 2]: its products go as one
      // group, and once the group before is done (wait 1) the other
      // fragment is free for slab z + 1
      auto slab = [&](auto buf, int z) {
        uint32_t (&frag)[2][STEPS][4] = a[decltype(buf)::value];
        const int w = slab_width(p, z);
        take_slab(frag, w);
        const unsigned qz = qaddr + z * (p.slab / ATOM_COLS) * p.nqt * ATOM_ROW;
        with_steps(w / 16, [&](auto steps) {
          if (z == 0)
            issue_planes<decltype(steps)::value, false>(acc, frag, b_desc(qz), dcol, dplane);
          else
            issue_planes<decltype(steps)::value, true>(acc, frag, b_desc(qz), dcol, dplane);
        });
        wgmma_wait<1>();
      };
      for (int z = 0; z < p.nslab; z += 2) {
        slab(std::integral_constant<int, 0>(), z);
        if (z + 1 < p.nslab) slab(std::integral_constant<int, 1>(), z + 1);
      }
      await_products<0>(acc);
      store(0);
    }
  }
}

}  // namespace pp

template <typename TX>
__global__ void __launch_bounds__(THREADS, 1)
    pivot_product_kernel(const float* __restrict__ q, const TX* __restrict__ rows,
                         const int* __restrict__ slots, float* __restrict__ out, int nq, int P,
                         int d, int64_t ld, int wide, int accumulate, pp::Plan p) {
  using namespace pp;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + CONSUMERS * p.nsw;
  unsigned char* ring = smem + RING_OFF;
  unsigned char* qs = smem + p.q_off;
  int* shift = reinterpret_cast<int*>(smem + p.shift_off);
  const int qt = static_cast<int>(blockIdx.x % p.q_tiles);
  const int64_t first = blockIdx.x / p.q_tiles;
  const int q0 = qt * p.nqt;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < CONSUMERS * p.nsw; ++s) {
      mbar_init(&full[s], 128);  // each producer thread's copies
      mbar_init(&empty[s], 128);
    }
    mbar_init_fence();
  }
  // each query's s, a warp a query, then the tile's planes
  for (int n = tid >> 5; n < p.nqt; n += THREADS / 32) {
    const int s = q0 + n < nq ? query_shift(q + (q0 + n) * ld, d, tid & 31) : 0;
    if ((tid & 31) == 0) shift[n] = s;
  }
  __syncthreads();
  stage_queries(qs, q, shift, nq, d, ld, q0, p, tid, THREADS);
  fence_proxy_async();
  __syncthreads();
  const int wg = tid >> 7;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    produce<TX>(rows, slots, P, d, ld, wide != 0, p, first, ring, full, empty, tid);
  } else {
    setmaxnreg_inc<232>();
    consume<TX>(out, nq, P, accumulate != 0, p, first, q0, ring, qs, shift, full, empty, wg - 1,
                tid & 127);
  }
}

namespace pp {

// The plan for nq queries over P pivots of d values of `elem` bytes, on a
// card of `sms` SMs with `smem_max` bytes a block. False where nothing
// fits.
// One slab (d16 <= slab): two stages a consumer, else one, and as many
// queries as fit. More slabs: 32 queries, the widest slab and then the
// most stages (up to 4) that fit (at the gist width one 128-column stage
// a consumer: 0.55 ms against 0.59 for two of 64 columns).
inline bool plan(Plan& p, int nq, int P, int d, int elem, int sms, int smem_max) {
  p.d16 = static_cast<int>(cdiv(d, 16)) * 16;
  const int qcols = static_cast<int>(cdiv(p.d16, ATOM_COLS));
  const int per_query = PLANES * qcols * ATOM_ROW + 4;  // the planes and the shift
  const int nq_pad = static_cast<int>(cdiv(nq, NC)) * NC;
  const int tries[8][2] = {{128, 4}, {128, 3}, {128, 2}, {128, 1},
                           {64, 4},  {64, 3},  {64, 2},  {64, 1}};
  bool found = false;
  for (int i = 0; i < 8 && !found; ++i) {
    const int w = tries[i][0], nsw = tries[i][1];
    const int nslab = static_cast<int>(cdiv(p.d16, w));
    if (nslab == 1 && nsw > 2) continue;
    const unsigned stage = ROWS * (p.d16 < w ? p.d16 : w) * elem;
    const unsigned q_off = align_up(RING_OFF + CONSUMERS * nsw * stage, 1024);
    if (static_cast<int>(q_off) >= smem_max) continue;
    const int fit = (smem_max - static_cast<int>(q_off)) / per_query / NC * NC;
    if (fit < NC) continue;
    found = true;
    p.slab = nslab == 1 ? p.d16 : w;
    p.nslab = nslab;
    p.nsw = nsw;
    p.stage_bytes = stage;
    p.q_off = q_off;
    p.nqt = nslab == 1 ? (nq_pad < fit ? nq_pad : fit) : NC;
  }
  if (!found) return false;
  p.plane_bytes = qcols * p.nqt * ATOM_ROW;
  p.shift_off = p.q_off + PLANES * p.plane_bytes;
  p.smem = p.shift_off + p.nqt * 4;
  p.q_tiles = static_cast<int>(cdiv(nq, p.nqt));
  p.ntiles = cdiv(P, ROWS);
  int per = sms / p.q_tiles;
  if (per < 1) per = 1;
  if (per > p.ntiles) per = static_cast<int>(p.ntiles);
  p.per_q = per;
  return true;
}

// The columns of a group for rows of d values: d itself where the plan
// fits the whole row (one group, the plan as for any narrower row), else
// the width of the fewest groups of equal width in whole atoms that the
// plan fits (the last group takes what is left); 0 where not even one
// atom fits. The plan's fit does not depend on nq or P.
inline int group_width(int d, int elem, int sms, int smem_max) {
  Plan p;
  if (plan(p, 1, 1, d, elem, sms, smem_max)) return d;
  const int d16 = static_cast<int>(cdiv(d, 16)) * 16;
  for (int g = 2; g <= cdiv(d16, ATOM_COLS); ++g) {
    const int w = static_cast<int>(cdiv(cdiv(d16, g), ATOM_COLS)) * ATOM_COLS;
    if (plan(p, 1, 1, w, elem, sms, smem_max)) return w;
  }
  return 0;
}

}  // namespace pp

// The product's launches, one a column group, with the groups launched
// in *groups.
template <typename TX>
int launch(const float* q, const void* x, const int* slots, float* out, int nq, int P, int d,
           int* groups, cudaStream_t s) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int gw = pp::group_width(d, sizeof(TX), sms, smem_max);
  if (gw == 0) return static_cast<int>(cudaErrorInvalidValue);
  // rows of whole 16-byte chunks from a 16-byte start: every group's row
  // starts on 16 bytes too (a group starts on a whole atom)
  const int wide = (d * sizeof(TX)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // the groups in turn on the stream, each after the one before it
  for (int c0 = 0; c0 < d; c0 += gw) {
    const int w = d - c0 < gw ? d - c0 : gw;
    pp::Plan p;
    if (!pp::plan(p, nq, P, w, sizeof(TX), sms, smem_max))
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(p.q_tiles) * p.per_q;
    cudaFuncSetAttribute(pivot_product_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         p.smem);
    pivot_product_kernel<TX><<<blocks, THREADS, p.smem, s>>>(
        q + c0, static_cast<const TX*>(x) + c0, slots, out, nq, P, w, d, wide, c0 > 0, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*groups;
  }
  return 0;
}

}  // namespace vss

// dots [nq, P] f32 = q [nq, d] f32 . x[p] for the pivots' rows x [P, d],
// int8 (dtype I8) or bf16 (BF16), 0 where slots[p] is -1; f32 rows are
// refused. Rows wider than one group fits take one launch a group;
// *launched receives the launches made (0 for no queries or pivots).
extern "C" int vss_pivot_product(const float* q, const void* x, const int* slots, float* out,
                                 int nq, int P, int d, int dtype, int* launched, void* stream) {
  using namespace vss;
  *launched = 0;
  if (d <= 0 || nq < 0 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == I8) return launch<int8_t>(q, x, slots, out, nq, P, d, launched, s);
  if (dtype == BF16) return launch<__nv_bfloat16>(q, x, slots, out, nq, P, d, launched, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan of the first column group for these sizes: its shared memory
// (0: refused), and through the pointers its slab width, stages a
// consumer, queries a tile and the group's columns (d for one group).
extern "C" int vss_pivot_product_plan(int nq, int P, int d, int elem, int smem_max,
                                      int* slab_out, int* nsw_out, int* nqt_out,
                                      int* group_out) {
  vss::pp::Plan p;
  if (d <= 0 || nq <= 0 || P <= 0) return 0;
  const int gw = vss::pp::group_width(d, elem, 132, smem_max);
  if (gw == 0 || !vss::pp::plan(p, nq, P, gw, elem, 132, smem_max)) return 0;
  *slab_out = p.slab;
  *nsw_out = p.nsw;
  *nqt_out = p.nqt;
  *group_out = gw;
  return static_cast<int>(p.smem);
}
