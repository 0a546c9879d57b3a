// Fused batched admission verdicts for Hopper (sm_90a).
//
// Replaces the TPU kernel admit_pallas / _admission_kernel of
// src/repro/kernels/admission.py: out[i] = estimate(candidate i) >
// estimate(victim i), both estimates and the comparison in one pass over
// the sketch (paper Fig. 1, batched).  This is the serving-tick path.
//
// What bounds it on this card: per pair, 2 * (rows + dk_probes) scattered
// loads from the L2-resident sketch, four lanes in and one byte out.  The
// prefix cache decides one pair per launch, so there the launch itself and
// the pair's latency are the whole cost; a batch of thousands fills the
// card.  Two paths:
//
// - warp per pair (small batches): lane j hashes one of the pair's
//   2 * (rows + dk_probes) <= 32 probes and issues its one load, so the
//   pair waits on one hash and one L2 round trip, not 14 hashes in one
//   thread.  The two minima are __reduce_min_sync, the two doorkeeper ANDs
//   one ballot; lane 0 writes the verdict byte.
// - thread per pair (large batches): sketch::estimate twice, every load of
//   the pair issued before any is used, over a grid-stride loop.
#include "sketch_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void admission_warp_kernel(const uint32_t* __restrict__ counters,
                                      const uint32_t* __restrict__ dk,
                                      const uint32_t* __restrict__ clo,
                                      const uint32_t* __restrict__ chi,
                                      const uint32_t* __restrict__ vlo,
                                      const uint32_t* __restrict__ vhi,
                                      uint8_t* __restrict__ out, int b,
                                      sketch::Geometry g) {
  const int lane = threadIdx.x & 31;
  const int dkp = g.dk_bits ? g.dk_probes : 0;
  const int per = g.rows + dkp;           // probes of one key, <= 16
  const bool victim = lane >= per;
  const int p = victim ? lane - per : lane;
  const bool active = lane < 2 * per;
  const uint32_t wpr = static_cast<uint32_t>(g.width) >> 3;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < b;
       i += nwarps) {
    uint32_t v = 15u, miss = 0u;          // min-neutral; doorkeeper bit set
    if (active) {
      const uint32_t lo = victim ? vlo[i] : clo[i];
      const uint32_t hi = victim ? vhi[i] : chi[i];
      if (p < g.rows) {
        const uint32_t idx = sketch::probe_index(lo, hi, p, g.width);
        const uint32_t w = __ldg(counters + p * wpr + (idx >> 3));
        v = (w >> ((idx & 7u) * 4u)) & 0xFu;
      } else {
        const uint32_t bit = sketch::dk_probe_index(lo, hi, p - g.rows,
                                                    g.dk_bits);
        miss = ((__ldg(dk + (bit >> 5)) >> (bit & 31u)) & 1u) ^ 1u;
      }
    }
    const uint32_t cmin = __reduce_min_sync(kFull, victim ? 15u : v);
    const uint32_t vmin = __reduce_min_sync(kFull, victim ? v : 15u);
    const uint32_t misses = __ballot_sync(kFull, miss);
    if (lane == 0) {
      uint32_t ce = cmin, ve = vmin;
      if (dkp) {
        const uint32_t cmask = (1u << per) - 1u;
        ce += (misses & cmask) == 0u;
        ve += (misses & (cmask << per)) == 0u;
      }
      out[i] = ce > ve ? 1 : 0;
    }
  }
}

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

// per_thread != 0: a thread per pair (large batches); else a warp per pair.
extern "C" int admission_launch(const int* counters, const int* dk,
                                const int* clo, const int* chi, const int* vlo,
                                const int* vhi, uint8_t* out, int b, int rows,
                                int width, int dk_bits, int dk_probes,
                                int per_thread, void* stream) {
  if (rows < 0 || rows > sketch::kMaxRows || dk_probes < 0 ||
      dk_probes > sketch::kMaxDkp)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = sketch::Geometry{rows, width, dk_bits, dk_probes};
  const auto* c = reinterpret_cast<const uint32_t*>(counters);
  const auto* d = reinterpret_cast<const uint32_t*>(dk);
  const auto* a = reinterpret_cast<const uint32_t*>(clo);
  const auto* ah = reinterpret_cast<const uint32_t*>(chi);
  const auto* v = reinterpret_cast<const uint32_t*>(vlo);
  const auto* vh = reinterpret_cast<const uint32_t*>(vhi);
  if (per_thread) {
    admission_kernel<<<sketch::blocks_for(b), 256, 0, s>>>(
        c, d, a, ah, v, vh, out, b, args);
  } else {
    const int threads = b < 8 ? 32 * b : 256;     // 8 pairs a block
    admission_warp_kernel<<<sketch::blocks_for(b * 32), threads, 0, s>>>(
        c, d, a, ah, v, vh, out, b, args);
  }
  return static_cast<int>(cudaGetLastError());
}
