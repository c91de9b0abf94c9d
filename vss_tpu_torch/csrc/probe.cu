// Probes of the card's dependent-read latencies, the floors that the
// beam_search (beam.cu), greedy_descent (descent.cu) and select_neighbors
// (select.cu) kernels are held against. They are measurements, not a part
// of any search or write path. `vss_pointer_chase`: one thread follows
// next[] for `steps` reads, each address the value of the read before it,
// starting where the last call stopped (*at), so that no call finds its
// path in the cache. Over a random cycle much larger than the L2 cache,
// the time per step is one round trip to device memory.
// `vss_shared_chase`: one thread copies next[0..n) into shared memory and
// follows it there for `steps` reads; the difference between two step
// counts, over their difference, is one dependent read of shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace vss {
__global__ void pointer_chase_kernel(const int32_t* __restrict__ next,
                                     int steps, int32_t* at) {
  int32_t i = *at;
  for (int s = 0; s < steps; ++s) i = next[i];
  *at = i;
}

__global__ void shared_chase_kernel(const int32_t* __restrict__ next, int n,
                                    int steps, int32_t* at) {
  extern __shared__ int32_t ring[];
  for (int k = 0; k < n; ++k) ring[k] = next[k];
  int32_t i = *at;
  for (int s = 0; s < steps; ++s) i = ring[i];
  *at = i;
}
}  // namespace vss

extern "C" int vss_pointer_chase(const int32_t* next, int steps, int32_t* at,
                                 void* stream) {
  vss::pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      next, steps, at);
  return static_cast<int>(cudaGetLastError());
}

// n values of next[] (a cycle through 0..n-1, *at < n) fit the 48 KB of
// dynamic shared memory a block has without opting in: n <= 12,288
extern "C" int vss_shared_chase(const int32_t* next, int n, int steps,
                                int32_t* at, void* stream) {
  if (n < 1 || n > 12288) return static_cast<int>(cudaErrorInvalidValue);
  vss::shared_chase_kernel<<<1, 1, static_cast<size_t>(n) * 4,
                             static_cast<cudaStream_t>(stream)>>>(next, n,
                                                                   steps, at);
  return static_cast<int>(cudaGetLastError());
}
