// Warp-level tensor-core product for K2 (scan.cu): the two PTX
// instructions it is built from, each behind one function, so that the
// CPU emulation of the kernels (tests/cuda_emulation.h) can stand in for
// exactly these two.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 with
// floating point type" and "ldmatrix"); lane = 4 g + t:
//  * ldmatrix .x4: lanes 8i..8i+7 give the row addresses of 8x8 matrix i
//    (8 consecutive b16 each, 16-byte aligned); register i of lane
//    4 g + t then holds row g, elements 2t and 2t+1 of matrix i.
//  * A (16x16, row): a[0] row g, cols 2t, 2t+1; a[1] row g+8; a[2] row g,
//    cols 2t+8, 2t+9; a[3] row g+8, cols 2t+8, 2t+9.
//  * B (16x8, col): b[0] k = 2t, 2t+1 of column n = g; b[1] k = 2t+8, 2t+9.
//  * C, D (16x8 f32): c[0], c[1] row g, cols 2t, 2t+1; c[2], c[3] row g+8.
// The lower-indexed element of a pair sits in the low 16 bits.
#pragma once

#include <stdint.h>

namespace vss {

// ldmatrix.sync.aligned.m8n8.x4.shared.b16: `row` is this lane's row
// address in shared memory.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace vss
