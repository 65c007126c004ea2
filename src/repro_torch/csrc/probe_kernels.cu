// A device probe, not a port kernel: one thread follows a chain of
// dependent 4-byte loads through a random cycle that the caller built
// (next[i] is the element after i), so a run's time over its steps is the
// latency of one dependent global load at the cycle's footprint.  The loads
// go through the read-only path (__ldg), as the index kernels' do.
// chip_smoke.py measures it on a cycle that fits the L2 and one that does
// not, for the index kernels' latency bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chase_kernel(const int32_t* __restrict__ next, int steps,
                             int32_t* __restrict__ out) {
  int j = 0;
  for (int s = 0; s < steps; ++s) j = __ldg(next + j);
  *out = j;
}

}  // namespace

extern "C" int rt_chase(const void* next, int steps, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next, steps,
                                                  (int32_t*)out);
  return (int)cudaGetLastError();
}
