// Asynchronous copies from device memory to shared memory. `cp.async.cg`
// (sm_80 and later): 16 bytes a copy, cached in L2 only, grouped by
// `commit_group` and awaited by `wait_group`. The bulk copy (sm_90):
// one instruction copies a contiguous span of a multiple of 16 bytes and
// reports its bytes to an mbarrier in shared memory, whose phase completes
// once its expected arrivals have arrived and the bytes they announced
// (`mbar_expect_tx`) have landed; `cp_async_arrive` reports a thread's
// cp.async copies to an mbarrier instead of to a group. The tests replace
// this header with the emulation's stand-ins (tests/cuda_emulation.h),
// which make a copy land only when its group, or its barrier's phase, is
// awaited.
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier expecting `count` arrivals a phase (one thread initialises;
// then `mbar_init_fence` and a block barrier before any use).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also announces `bytes` of bulk copies for this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting for parity 1 returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on `bar`, made once every cp.async this thread issued before
// has landed (`.noinc`: the arrival is one of those the barrier expects).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// `gmem` to `smem`, reported to `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace vss
