// Device probes, not port kernels.
//
// chase: one thread follows a chain of dependent 4-byte loads through a
// random cycle that the caller built (next[i] is the element after i), so a
// run's time over its steps is the latency of one dependent global load at
// the cycle's footprint.  The loads go through the read-only path (__ldg),
// as the index kernels' do.  chip_smoke.py measures it on a cycle that fits
// the L2 and one that does not, for the index kernels' latency bounds.
//
// empty: a kernel that does nothing, one warp: its device time per launch,
// queued back to back, is the floor under every small kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chase_kernel(const int32_t* __restrict__ next, int steps,
                             int32_t* __restrict__ out) {
  int j = 0;
  for (int s = 0; s < steps; ++s) j = __ldg(next + j);
  *out = j;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int rt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int rt_chase(const void* next, int steps, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next, steps,
                                                  (int32_t*)out);
  return (int)cudaGetLastError();
}
