// Batched TinyLFU estimates for Hopper (sm_90a).
//
// Replaces the TPU kernel estimate_pallas / _estimate_kernel of
// src/repro/kernels/sketch_estimate.py: out[i] = min over rows of key i's
// 4-bit counters (from 15), +1 iff every doorkeeper probe bit of key i is
// set (only with a doorkeeper).  The TPU version gathers the words through
// one-hot fp32 matmuls on the MXU; here a gather is a plain load, so that
// workaround is not carried over.
//
// What bounds it on this card: per key, rows + dk_probes scattered 4-byte
// loads from a sketch that sits in the L2 (768 KB at C = 65,536), plus the
// lanes in and the estimate out.  Each scattered load moves a 32-byte L2
// sector, and at S's 50,000 keys x 7 probes those sectors are what the
// time follows: it grows by about 0.3 us per probe a key on an H100, for
// this design and the first alike (chip_smoke.py phase 10).  For one key,
// or a few, what a key waits on is latency: salted hashes (two mix32
// finalizers each), then its loads, then a minimum; one thread per key
// runs its rows + dk_probes hashes in one chain (7 at S).  The design
// spreads a key over a group of G lanes, two probes a lane (G =
// pow2ceil(ceil((rows + dk_probes) / 2)), at most 32; 4 at S, eight keys a
// warp):
//
// - lane j of a group hashes probes j and j + G and issues their loads
//   before using either: counter rows first, doorkeeper probes after them;
//   with more than 64 probes a lane takes j + 2G, ... in turn, so any
//   dk_probes is taken;
// - the row minimum and the doorkeeper AND are __shfl_xor_sync butterflies
//   of width G, and lane 0 of the group writes the estimate;
// - so a key waits on two hashes and one L2 round trip; one probe a lane
//   (G = 8 at S) was slower at S's 50,000 keys in a trial (twice the
//   threads for the same sectors);
// - a programmatic dependent launch (sketch::launch_dependent): the grid
//   is scheduled while the kernel before it drains, and waits for it
//   (griddepcontrol.wait) before reading the sketch or the lanes.
#include "sketch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int G>
__global__ void __launch_bounds__(kThreads)
sketch_estimate_kernel(const uint32_t* __restrict__ counters,
                       const uint32_t* __restrict__ dk,
                       const uint32_t* __restrict__ lo,
                       const uint32_t* __restrict__ hi, int* __restrict__ out,
                       int b, sketch::Geometry g) {
  sketch::wait_for_prior_grid();
  const int j = threadIdx.x & (G - 1);
  const int i = blockIdx.x * (kThreads / G) + threadIdx.x / G;   // the key
  const int per = g.rows + (g.dk_bits ? g.dk_probes : 0);
  const uint32_t wpr = static_cast<uint32_t>(g.width) >> 3;
  uint32_t v = 15u, miss = 0u;          // min-neutral; no doorkeeper miss
  if (i < b) {
    const uint32_t klo = lo[i], khi = hi[i];
#pragma unroll 8
    for (int q = j; q < per; q += G) {
      if (q < g.rows) {
        const uint32_t idx = sketch::probe_index(klo, khi, q, g.width);
        const uint32_t w = __ldg(counters + static_cast<uint32_t>(q) * wpr
                                 + (idx >> 3));
        const uint32_t c = (w >> ((idx & 7u) * 4u)) & 0xFu;
        v = c < v ? c : v;
      } else {
        const uint32_t bit = sketch::dk_probe_index(klo, khi, q - g.rows,
                                                    g.dk_bits);
        miss |= ((__ldg(dk + (bit >> 5)) >> (bit & 31u)) & 1u) ^ 1u;
      }
    }
  }
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) {
    const uint32_t o = __shfl_xor_sync(kFull, v, m, G);
    v = o < v ? o : v;
    miss |= __shfl_xor_sync(kFull, miss, m, G);
  }
  if (j == 0 && i < b)
    out[i] = static_cast<int>(v + (g.dk_bits ? miss ^ 1u : 0u));
}

template <int G>
cudaError_t launch(const uint32_t* c, const uint32_t* d, const uint32_t* lo,
                   const uint32_t* hi, int* out, int b, sketch::Geometry g,
                   cudaStream_t s) {
  const long long blocks = (static_cast<long long>(b) * G + kThreads - 1)
                           / kThreads;
  return sketch::launch_dependent(sketch_estimate_kernel<G>,
                                  static_cast<int>(blocks), kThreads, s, c,
                                  d, lo, hi, out, b, g);
}

}  // namespace

extern "C" int sketch_estimate_launch(const int* counters, const int* dk,
                                      const int* lo, const int* hi, int* out,
                                      int b, int rows, int width, int dk_bits,
                                      int dk_probes, void* stream) {
  if (rows < 0 || rows > sketch::kMaxRows || dk_probes < 0 || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = (rows + (dk_bits ? dk_probes : 0) + 1) / 2;
  const auto g = sketch::Geometry{rows, width, dk_bits, dk_probes};
  const auto* c = reinterpret_cast<const uint32_t*>(counters);
  const auto* d = reinterpret_cast<const uint32_t*>(dk);
  const auto* l = reinterpret_cast<const uint32_t*>(lo);
  const auto* h = reinterpret_cast<const uint32_t*>(hi);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lanes <= 1) err = launch<1>(c, d, l, h, out, b, g, s);
  else if (lanes <= 2) err = launch<2>(c, d, l, h, out, b, g, s);
  else if (lanes <= 4) err = launch<4>(c, d, l, h, out, b, g, s);
  else if (lanes <= 8) err = launch<8>(c, d, l, h, out, b, g, s);
  else if (lanes <= 16) err = launch<16>(c, d, l, h, out, b, g, s);
  else err = launch<32>(c, d, l, h, out, b, g, s);
  return static_cast<int>(err);
}
