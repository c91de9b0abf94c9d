// A probe of the card's dependent-read latency, the floor that the
// beam_search kernel (beam.cu) is held against. It is a measurement, not
// a part of any search or write path: one thread follows next[] for
// `steps` reads, each address the value of the read before it, starting
// where the last call stopped (*at), so that no call finds its path in the
// cache. Over a random cycle much larger than the L2 cache, the time per
// step is one round trip to device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace vss {
__global__ void pointer_chase_kernel(const int32_t* __restrict__ next,
                                     int steps, int32_t* at) {
  int32_t i = *at;
  for (int s = 0; s < steps; ++s) i = next[i];
  *at = i;
}
}  // namespace vss

extern "C" int vss_pointer_chase(const int32_t* next, int steps, int32_t* at,
                                 void* stream) {
  vss::pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      next, steps, at);
  return static_cast<int>(cudaGetLastError());
}
