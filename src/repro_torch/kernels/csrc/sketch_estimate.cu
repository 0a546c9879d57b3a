// Batched TinyLFU estimates for Hopper (sm_90a).
//
// Replaces the TPU kernel estimate_pallas / _estimate_kernel of
// src/repro/kernels/sketch_estimate.py: out[i] = min over rows of key i's
// 4-bit counters, +1 iff every doorkeeper probe bit of key i is set.  The
// TPU version gathers the words through one-hot fp32 matmuls on the MXU;
// here a gather is a plain load, so that workaround is not carried over.
//
// What bounds it on this card: per key, rows + dk_probes scattered 4-byte
// loads from a sketch that sits in the L2 (768 KB at C = 65,536), plus the
// lanes in and the estimate out.  The keys are independent, so the design
// is one thread per key, every load of a key issued before any is used,
// enough threads in flight to hide the L2 latency, and a grid-stride loop.
#include "sketch_common.cuh"

namespace {

__global__ void sketch_estimate_kernel(const uint32_t* __restrict__ counters,
                                       const uint32_t* __restrict__ dk,
                                       const uint32_t* __restrict__ lo,
                                       const uint32_t* __restrict__ hi,
                                       int* __restrict__ out, int b,
                                       sketch::Geometry g) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += gridDim.x * blockDim.x)
    out[i] = sketch::estimate(counters, dk, lo[i], hi[i], g);
}

}  // namespace

extern "C" int sketch_estimate_launch(const int* counters, const int* dk,
                                      const int* lo, const int* hi, int* out,
                                      int b, int rows, int width, int dk_bits,
                                      int dk_probes, void* stream) {
  sketch_estimate_kernel<<<sketch::blocks_for(b), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(counters),
      reinterpret_cast<const uint32_t*>(dk),
      reinterpret_cast<const uint32_t*>(lo),
      reinterpret_cast<const uint32_t*>(hi), out, b,
      sketch::Geometry{rows, width, dk_bits, dk_probes});
  return static_cast<int>(cudaGetLastError());
}
