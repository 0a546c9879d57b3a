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
//   one ballot; lane 0 writes the verdict byte.  With more probes than
//   that (the kLoop instance), 16 lanes take each key and a lane its
//   probes p, p + 16, ... in turn.
// - thread per pair (large batches): sketch::estimate twice, every load of
//   the pair's first 8 doorkeeper probes issued before any is used, over a
//   grid-stride loop; the kMoreProbes instance reads probes 8 and up in a
//   loop after them.
// The instances for 2 * (rows + dk_probes) <= 32 and dk_probes <= 8 keep
// the first design's code, so their registers and times are its own
// (sketch_baseline.cu builds that design beside them).
#include "sketch_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <bool kLoop>
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
  const int per = g.rows + dkp;           // probes of one key
  const int half = kLoop ? 16 : per;      // lanes of one key (<= 16)
  const bool victim = lane >= half;
  const int p = victim ? lane - half : lane;
  const bool active = kLoop || lane < 2 * per;
  const uint32_t wpr = static_cast<uint32_t>(g.width) >> 3;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < b;
       i += nwarps) {
    uint32_t v = 15u, miss = 0u;          // min-neutral; doorkeeper bit set
    if (active) {
      const uint32_t lo = victim ? vlo[i] : clo[i];
      const uint32_t hi = victim ? vhi[i] : chi[i];
      if constexpr (kLoop) {
        for (int q = p; q < per; q += 16) {
          if (q < g.rows) {
            const uint32_t idx = sketch::probe_index(lo, hi, q, g.width);
            const uint32_t w = __ldg(counters + q * wpr + (idx >> 3));
            const uint32_t c = (w >> ((idx & 7u) * 4u)) & 0xFu;
            v = c < v ? c : v;
          } else {
            const uint32_t bit = sketch::dk_probe_index(lo, hi, q - g.rows,
                                                        g.dk_bits);
            miss |= ((__ldg(dk + (bit >> 5)) >> (bit & 31u)) & 1u) ^ 1u;
          }
        }
      } else if (p < g.rows) {            // one probe a lane
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
        const uint32_t cmask = kLoop ? 0xFFFFu : (1u << per) - 1u;
        ce += (misses & cmask) == 0u;
        ve += (misses & (cmask << half)) == 0u;
      }
      out[i] = ce > ve ? 1 : 0;
    }
  }
}

template <bool kMoreProbes>
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
    const int ce = sketch::estimate<kMoreProbes>(counters, dk, clo[i],
                                                 chi[i], g);
    const int ve = sketch::estimate<kMoreProbes>(counters, dk, vlo[i],
                                                 vhi[i], g);
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
  if (rows < 0 || rows > sketch::kMaxRows || dk_probes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = sketch::Geometry{rows, width, dk_bits, dk_probes};
  const auto* c = reinterpret_cast<const uint32_t*>(counters);
  const auto* d = reinterpret_cast<const uint32_t*>(dk);
  const auto* a = reinterpret_cast<const uint32_t*>(clo);
  const auto* ah = reinterpret_cast<const uint32_t*>(chi);
  const auto* v = reinterpret_cast<const uint32_t*>(vlo);
  const auto* vh = reinterpret_cast<const uint32_t*>(vhi);
  const int dkp = dk_bits ? dk_probes : 0;
  if (per_thread) {
    const auto kernel = dkp > sketch::kMaxDkp ? admission_kernel<true>
                                              : admission_kernel<false>;
    kernel<<<sketch::blocks_for(b), 256, 0, s>>>(c, d, a, ah, v, vh, out, b,
                                                 args);
  } else {
    const auto kernel = 2 * (rows + dkp) > 32 ? admission_warp_kernel<true>
                                              : admission_warp_kernel<false>;
    const int threads = b < 8 ? 32 * b : 256;     // 8 pairs a block
    kernel<<<sketch::blocks_for(b * 32), threads, 0, s>>>(c, d, a, ah, v, vh,
                                                          out, b, args);
  }
  return static_cast<int>(cudaGetLastError());
}
