// The first designs of the reset, estimate and admit kernels, kept so that
// chip_smoke.py phase 10 can time the current kernels against them on the
// same card in one run; the ops never launch them.
//
// - reset: a 4-byte grid-stride pass over the counter words, then a second
//   loop over the doorkeeper words, 256 threads a block, sketch::blocks_for
//   blocks;
// - estimate: one thread per key (sketch::estimate: every load of a key
//   issued before any is used), a grid-stride loop;
// - admit: a warp per pair (one probe per lane) and a thread per pair
//   (sketch::estimate twice), at most 8 doorkeeper probes, as in
//   admission.cu before its probe limit was lifted.
// All are plain launches in stream order, with no programmatic dependence.
#include "sketch_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void reset_kernel(uint32_t* __restrict__ counters, int nc,
                             uint32_t* __restrict__ dk, int nd) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nc; i += stride)
    counters[i] = (counters[i] >> 1) & 0x77777777u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nd; i += stride)
    dk[i] = 0u;
}

__global__ void estimate_kernel(const uint32_t* __restrict__ counters,
                                const uint32_t* __restrict__ dk,
                                const uint32_t* __restrict__ lo,
                                const uint32_t* __restrict__ hi,
                                int* __restrict__ out, int b,
                                sketch::Geometry g) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += gridDim.x * blockDim.x)
    out[i] = sketch::estimate(counters, dk, lo[i], hi[i], g);
}

__global__ void admit_warp_kernel(const uint32_t* __restrict__ counters,
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

__global__ void admit_thread_kernel(const uint32_t* __restrict__ counters,
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

extern "C" int baseline_reset_launch(int* counters, int n_counter_words,
                                     int* dk, int n_dk_words, void* stream) {
  const int n = n_counter_words > n_dk_words ? n_counter_words : n_dk_words;
  reset_kernel<<<sketch::blocks_for(n), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<uint32_t*>(counters), n_counter_words,
      reinterpret_cast<uint32_t*>(dk), n_dk_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int baseline_estimate_launch(const int* counters, const int* dk,
                                        const int* lo, const int* hi,
                                        int* out, int b, int rows, int width,
                                        int dk_bits, int dk_probes,
                                        void* stream) {
  if (rows < 0 || rows > sketch::kMaxRows || dk_probes < 0 ||
      dk_probes > sketch::kMaxDkp)
    return static_cast<int>(cudaErrorInvalidValue);
  estimate_kernel<<<sketch::blocks_for(b), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(counters),
      reinterpret_cast<const uint32_t*>(dk),
      reinterpret_cast<const uint32_t*>(lo),
      reinterpret_cast<const uint32_t*>(hi), out, b,
      sketch::Geometry{rows, width, dk_bits, dk_probes});
  return static_cast<int>(cudaGetLastError());
}

// per_thread != 0: a thread per pair (large batches); else a warp per pair.
extern "C" int baseline_admission_launch(const int* counters, const int* dk,
                                         const int* clo, const int* chi,
                                         const int* vlo, const int* vhi,
                                         uint8_t* out, int b, int rows,
                                         int width, int dk_bits,
                                         int dk_probes, int per_thread,
                                         void* stream) {
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
    admit_thread_kernel<<<sketch::blocks_for(b), 256, 0, s>>>(
        c, d, a, ah, v, vh, out, b, args);
  } else {
    const int threads = b < 8 ? 32 * b : 256;     // 8 pairs a block
    admit_warp_kernel<<<sketch::blocks_for(b * 32), threads, 0, s>>>(
        c, d, a, ah, v, vh, out, b, args);
  }
  return static_cast<int>(cudaGetLastError());
}
