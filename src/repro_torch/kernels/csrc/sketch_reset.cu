// The paper's section 3.3 reset for Hopper (sm_90a).
//
// Replaces the TPU kernel reset_pallas / _reset_kernel of
// src/repro/kernels/sketch_reset.py: every counter word becomes
// (x >> 1) & 0x77777777 on uint32_t (each 4-bit field halved, no bit
// borrowed across fields) and every doorkeeper word 0, in place.  The
// sketch's size register lives on the host and is halved there, once per
// reset, so no block of this grid reads or writes it: there is no
// cross-block decision to race on.
//
// What bounds it on this card: bytes, each counter word read and written
// once and each doorkeeper word written once (1.25 MB at C = 65,536).  The
// design is an elementwise grid-stride pass, neighbouring threads on
// neighbouring words.
#include "sketch_common.cuh"

namespace {

__global__ void sketch_reset_kernel(uint32_t* __restrict__ counters, int nc,
                                    uint32_t* __restrict__ dk, int nd) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nc; i += stride)
    counters[i] = (counters[i] >> 1) & 0x77777777u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nd; i += stride)
    dk[i] = 0u;
}

}  // namespace

extern "C" int sketch_reset_launch(int* counters, int n_counter_words,
                                   int* dk, int n_dk_words, void* stream) {
  const int n = n_counter_words > n_dk_words ? n_counter_words : n_dk_words;
  sketch_reset_kernel<<<sketch::blocks_for(n), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<uint32_t*>(counters), n_counter_words,
      reinterpret_cast<uint32_t*>(dk), n_dk_words);
  return static_cast<int>(cudaGetLastError());
}
