// Round-trip time of one dependent load from L2, for the step kernel's
// latency floor (python -m repro_torch.kernels.phase_timing); the engine
// does not use it.
//
// One thread follows a pointer chain j = next[j] through a buffer that fits
// in L2.  The loads use __ldcg (cache in L2, not L1), and each one's address
// is the value of the one before, so the time per step is one L2 round trip.
#include <cuda_runtime.h>

namespace {

__global__ void l2_chase_kernel(const int* next, int steps, int* out) {
  int j = 0;
  for (int k = 0; k < steps; ++k) j = __ldcg(next + j);
  *out = j;
}

}  // namespace

extern "C" int l2_chase_launch(const void* next, int steps, void* out,
                               void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
