// Asynchronous copies from device memory to shared memory (sm_80 and
// later): `cp.async.cg`, 16 bytes a copy, cached in L2 only, grouped by
// `commit_group` and awaited by `wait_group`. The tests replace this
// header with the emulation's stand-ins (tests/cuda_emulation.h), which
// make a copy land only when its group is awaited.
#pragma once

#include <stdint.h>

namespace vss {

// Copy 16 bytes from `gmem` to `smem` (both 16-byte aligned); the last
// 16 - src_bytes bytes are zero-filled (src_bytes 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// Close the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace vss
