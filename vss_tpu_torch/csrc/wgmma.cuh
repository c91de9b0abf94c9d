// Hopper's warpgroup instructions for K2 (scan.cu), each behind one
// function so that the CPU emulation of the kernels
// (tests/cuda_emulation.h) can stand in for exactly these.
//
// wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 with A from
// registers and B from shared memory by descriptor (PTX ISA,
// "Asynchronous Warpgroup Level Matrix Multiply-Accumulate"): the four
// warps of a warpgroup (128 threads, the first a multiple of 128) issue it
// together, and warp w of the warpgroup holds rows 16w..16w+15 of A and D.
// lane = 4 g + t; rows below are counted within the warp's 16:
//  * A (64x16, four .b32 registers of two bf16, the lower k in the low
//    half): a[0] row g, k 2t and 2t+1; a[1] row g+8, k 2t, 2t+1; a[2] row
//    g, k 2t+8, 2t+9; a[3] row g+8, k 2t+8, 2t+9.
//  * D (64x64 f32, 32 registers): d[4j + i] of n8 block j sits at row g
//    (i = 0, 1) or g+8 (i = 2, 3), column n = 8j + 2t + (i & 1).
//  * B (16x64, "K-major": the k values of one n consecutive) by a 64-bit
//    descriptor: bits 0-13 the start address >> 4, 16-29 the leading
//    byte offset >> 4 (LBO), 32-45 the stride byte offset >> 4 (SBO),
//    62-63 the swizzle mode (0: none, 1: 128-byte). Without swizzle B is
//    made of core matrices of 8 n x 8 k values, each 128 contiguous bytes;
//    LBO separates the two along k, SBO consecutive 8-n groups: element
//    (n, k) sits at start + (n/8) SBO + (k/8) LBO + 16 (n%8) + 2 (k%8).
//    With 128-byte swizzle (K2's layout) each n has a row of 128 bytes in
//    an atom of 8 rows (1024 bytes, 1024-aligned), SBO between atoms: (n,
//    k) sits at a = start + (n/8) SBO + 128 (n%8) + 2k, its 16-byte chunk
//    XORed with the row, a ^ (((a >> 7) & 7) << 4); a step further along k
//    starts 32 bytes later in the same rows.
// A product's sums land in its accumulators only at the `wgmma_wait` that
// covers its group; neither they nor A's registers may be touched before
// it. `wgmma_fence` orders this thread's earlier register writes before
// the products that read them (PTX: before the first product and after
// any access to their registers).
#pragma once

#include <stdint.h>

namespace vss {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += a * B, B from the descriptor `desc`
__device__ __forceinline__ void wgmma_m64n64k16(float d[32], const uint32_t a[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d = a * B: the first product of a sum, which writes d and reads nothing
__device__ __forceinline__ void wgmma_m64n64k16_zero(float d[32], const uint32_t a[4],
                                                     uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),
        "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),
        "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
        "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// keeps the compiler from moving reads or writes of `r` across the
// asynchronous products (it emits no instruction)
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// shared-memory writes of this thread made visible to the products, which
// read shared memory through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15) of the 128 threads of one warpgroup
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// the registers a thread of this warpgroup may hold from here on
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// min that gives NaN if either input is NaN (torch.amin's), in one
// instruction
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

}  // namespace vss
