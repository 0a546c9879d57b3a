// Fused batched admission verdicts for Hopper (sm_90a).
//
// Replaces the TPU kernel admit_pallas / _admission_kernel of
// src/repro/kernels/admission.py: out[i] = estimate(candidate i) >
// estimate(victim i), both estimates and the comparison in one pass over
// the sketch (paper Fig. 1, batched).  This is the serving-tick path.
//
// What bounds it on this card: per pair, 2 * (rows + dk_probes) scattered
// loads from the L2-resident sketch, four lanes in and one byte out.  One
// thread per pair computes both estimates, every load of the pair issued
// before any is used, over a grid-stride loop.  At the prefix cache's batch
// of one pair the launch itself dominates; a batch of thousands fills the
// card.
#include "sketch_common.cuh"

namespace {

__global__ void admission_kernel(const uint32_t* __restrict__ counters,
                                 const uint32_t* __restrict__ dk,
                                 const uint32_t* __restrict__ clo,
                                 const uint32_t* __restrict__ chi,
                                 const uint32_t* __restrict__ vlo,
                                 const uint32_t* __restrict__ vhi,
                                 uint8_t* __restrict__ out, int b,
                                 sketch::Geometry g) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += gridDim.x * blockDim.x) {
    const int ce = sketch::estimate(counters, dk, clo[i], chi[i], g);
    const int ve = sketch::estimate(counters, dk, vlo[i], vhi[i], g);
    out[i] = ce > ve ? 1 : 0;
  }
}

}  // namespace

extern "C" int admission_launch(const int* counters, const int* dk,
                                const int* clo, const int* chi, const int* vlo,
                                const int* vhi, uint8_t* out, int b, int rows,
                                int width, int dk_bits, int dk_probes,
                                void* stream) {
  admission_kernel<<<sketch::blocks_for(b), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(counters),
      reinterpret_cast<const uint32_t*>(dk),
      reinterpret_cast<const uint32_t*>(clo),
      reinterpret_cast<const uint32_t*>(chi),
      reinterpret_cast<const uint32_t*>(vlo),
      reinterpret_cast<const uint32_t*>(vhi), out, b,
      sketch::Geometry{rows, width, dk_bits, dk_probes});
  return static_cast<int>(cudaGetLastError());
}
