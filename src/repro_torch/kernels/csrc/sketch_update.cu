// Sequential conservative-update adds for Hopper (sm_90a).
//
// Replaces the TPU kernel add_pallas / _update_kernel of
// src/repro/kernels/sketch_update.py.  One launch adds the b keys of a
// batch, in order, to the sketch in device memory, in place (the
// analogue of the reference's input_output_aliases).  Per key: doorkeeper
// test-and-set, where each probe sees the bits the key's earlier probes
// set; then, iff the key was present (or there is no doorkeeper), +1 on
// every row whose counter equals the minimum, when that minimum is below
// cap.  The size register is the caller's: it lives on the host.
//
// What bounds it on this card: the add is order-dependent (a key reads what
// the keys before it wrote), so the batch is one dependent chain through
// the sketch.  The bytes are tiny (rows + dk_probes words per key against
// 3.35 TB/s); the time is one L2 round trip per key plus the instructions
// of one thread.
//
// What the design does about it: one warp, the state in global memory
// (L2-resident: 768 KB at C = 65,536).  The probes depend on the key only,
// so the warp hashes 32 keys at once (lane j hashes key j of a tile) and
// the lanes' loads and the hashing leave the chain.  Lane 0 then walks the
// tile in order, taking each key's probes by shuffles: it issues every
// load of the key (counter and doorkeeper words) before using any, so a key
// waits on one round trip, and resolves the doorkeeper carry in registers.
// A word's last store comes from the key's last probe into it, which
// carries the bits of every earlier probe, so no merge pass is needed.
// The doorkeeper probe count is a template parameter, so its loops unroll
// exactly; rows stay a runtime count under unrolled predicates.  Stores and
// the next key's loads come from one thread, so program order keeps them in
// order.
#include "sketch_common.cuh"

namespace {

using sketch::kMaxDkp;
using sketch::kMaxRows;
constexpr unsigned kFull = 0xffffffffu;

// One key's add by lane 0, from its counter probes and doorkeeper bits.
template <int D>
__device__ __forceinline__ void add_key(uint32_t* counters, uint32_t* dk,
                                        const uint32_t (&idx)[kMaxRows],
                                        const uint32_t (&bit)[D > 0 ? D : 1],
                                        int rows, int wpr, int cap) {
  uint32_t widx[D > 0 ? D : 1], dw[D > 0 ? D : 1];
  uint32_t flat[kMaxRows], sh[kMaxRows], cw[kMaxRows];
#pragma unroll
  for (int p = 0; p < D; ++p) {
    widx[p] = bit[p] >> 5;
    dw[p] = dk[widx[p]];
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) {
      flat[r] = r * wpr + (idx[r] >> 3);
      sh[r] = (idx[r] & 7u) * 4u;
      cw[r] = counters[flat[r]];
    }
  }
  bool gate = true;
#pragma unroll
  for (int p = 0; p < D; ++p) {
    // the word as the reference reads it: after the key's earlier probes
    // set their bits
    uint32_t w = dw[p];
#pragma unroll
    for (int q = 0; q < p; ++q)
      if (widx[q] == widx[p]) w |= 1u << (bit[q] & 31u);
    gate = gate && ((w >> (bit[p] & 31u)) & 1u);
    dk[widx[p]] = w | (1u << (bit[p] & 31u));
  }
  uint32_t m = 15u, v[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) {
      v[r] = (cw[r] >> sh[r]) & 0xFu;
      m = v[r] < m ? v[r] : m;
    }
  }
  if (gate && m < static_cast<uint32_t>(cap)) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)   // every row at the minimum
      if (r < rows && v[r] == m) counters[flat[r]] = cw[r] + (1u << sh[r]);
  }
}

// D: doorkeeper probes per key, 0 without a doorkeeper.
template <int D>
__global__ void __launch_bounds__(32) sketch_update_kernel(
    uint32_t* counters, uint32_t* dk, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ hi, int b, int rows, int width,
    int cap, int dk_bits) {
  const int lane = threadIdx.x;
  const int wpr = width >> 3;
  for (int base = 0; base < b; base += 32) {
    uint32_t ridx[kMaxRows] = {}, rbit[D > 0 ? D : 1] = {};
    if (base + lane < b) {
      const uint32_t klo = lo[base + lane], khi = hi[base + lane];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < rows) ridx[r] = sketch::probe_index(klo, khi, r, width);
#pragma unroll
      for (int p = 0; p < D; ++p)
        rbit[p] = sketch::dk_probe_index(klo, khi, p, dk_bits);
    }
    const int tile = b - base < 32 ? b - base : 32;
    for (int j = 0; j < tile; ++j) {
      uint32_t idx[kMaxRows], bit[D > 0 ? D : 1];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < rows) idx[r] = __shfl_sync(kFull, ridx[r], j);
#pragma unroll
      for (int p = 0; p < D; ++p) bit[p] = __shfl_sync(kFull, rbit[p], j);
      if (lane == 0) add_key<D>(counters, dk, idx, bit, rows, wpr, cap);
      __syncwarp();
    }
  }
}

using Launch = void (*)(uint32_t*, uint32_t*, const uint32_t*,
                        const uint32_t*, int, int, int, int, int,
                        cudaStream_t);

template <int D>
void launch(uint32_t* counters, uint32_t* dk, const uint32_t* lo,
            const uint32_t* hi, int b, int rows, int width, int cap,
            int dk_bits, cudaStream_t stream) {
  sketch_update_kernel<D><<<1, 32, 0, stream>>>(counters, dk, lo, hi,
                                                b, rows, width, cap,
                                                dk_bits);
}

constexpr Launch kLaunch[kMaxDkp + 1] = {
    launch<0>, launch<1>, launch<2>, launch<3>, launch<4>,
    launch<5>, launch<6>, launch<7>, launch<8>};

}  // namespace

extern "C" int sketch_update_launch(int* counters, int* dk, const int* lo,
                                    const int* hi, int b, int rows,
                                    int width, int cap, int dk_bits,
                                    int dk_probes, void* stream) {
  const int d = dk_bits ? dk_probes : 0;
  if (d < 0 || d > kMaxDkp || rows < 0 || rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  kLaunch[d](reinterpret_cast<uint32_t*>(counters),
             reinterpret_cast<uint32_t*>(dk),
             reinterpret_cast<const uint32_t*>(lo),
             reinterpret_cast<const uint32_t*>(hi), b, rows, width, cap,
             dk_bits, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
