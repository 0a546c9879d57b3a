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
// once and each doorkeeper word written once (1.25 MB at C = 65,536, all
// of it resident in the 50 MB L2 after the add before it).  At that size
// the work is well under a microsecond, so the launch and the grid's
// drain are most of its time.  The design:
//
// - one flat index space over both arrays, so no thread idles through a
//   second loop: 16-byte items (uint4) over each array's 16-byte-aligned
//   body first, then the scalar words before and after each body (a row
//   of width 8 or 16 is 1 or 2 words, dk_bits = 32 is one word);
// - each thread issues the loads of up to kUnroll items before any of
//   their stores;
// - a grid of at most one wave, from the SM count and the kernel's
//   occupancy, both queried once;
// - a programmatic dependent launch (sketch::launch_dependent): the grid
//   is scheduled while the add before it drains, and waits for that grid
//   (griddepcontrol.wait) before its first access to the sketch.
#include "sketch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // items a thread loads before it stores

// One array cut for 16-byte access: `head` words up to the first 16-byte
// boundary, `vecs` uint4 items, then `tail` words.
struct Span {
  uint32_t* base;
  int head, vecs, tail;
};

Span split(int* words, int n) {
  const auto addr = reinterpret_cast<uintptr_t>(words);
  int head = static_cast<int>(((16u - (addr & 15u)) & 15u) / 4u);
  head = head < n ? head : n;
  const int vecs = (n - head) / 4;
  return {reinterpret_cast<uint32_t*>(words), head, vecs,
          n - head - 4 * vecs};
}

// The k-th scalar word of a span: its head words, then its tail words.
__device__ __forceinline__ uint32_t* scalar_word(const Span& a, int k) {
  return a.base + (k < a.head ? k : 4 * a.vecs + k);
}

__device__ __forceinline__ uint32_t halve(uint32_t x) {
  return (x >> 1) & 0x77777777u;
}

// Items: [0, cv) counter vectors, [cv, cv + dv) doorkeeper vectors, then
// the counters' scalar words, then the doorkeeper's.
__global__ void __launch_bounds__(kThreads)
sketch_reset_kernel(Span c, Span d) {
  sketch::wait_for_prior_grid();
  const int cv = c.vecs, dv = d.vecs;
  const int v_end = cv + dv;
  const int cs_end = v_end + c.head + c.tail;
  const int n = cs_end + d.head + d.tail;
  auto* c4 = reinterpret_cast<uint4*>(c.base + c.head);
  auto* d4 = reinterpret_cast<uint4*>(d.base + d.head);
  const int stride = gridDim.x * kThreads;
  for (int base = blockIdx.x * kThreads + threadIdx.x; base < n;
       base += kUnroll * stride) {
    uint4 v[kUnroll];
    uint32_t w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * stride;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      w[u] = 0u;
      if (i < cv)
        v[u] = c4[i];
      else if (i >= v_end && i < cs_end)
        w[u] = *scalar_word(c, i - v_end);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * stride;
      if (i < cv)
        c4[i] = make_uint4(halve(v[u].x), halve(v[u].y), halve(v[u].z),
                           halve(v[u].w));
      else if (i < v_end)
        d4[i - cv] = make_uint4(0u, 0u, 0u, 0u);
      else if (i < cs_end)
        *scalar_word(c, i - v_end) = halve(w[u]);
      else if (i < n)
        *scalar_word(d, i - cs_end) = 0u;
    }
  }
}

}  // namespace

extern "C" int sketch_reset_launch(int* counters, int n_counter_words,
                                   int* dk, int n_dk_words, void* stream) {
  static const int per_sm = sketch::blocks_per_sm(sketch_reset_kernel,
                                                  kThreads);
  const Span c = split(counters, n_counter_words);
  const Span d = split(dk, n_dk_words);
  const long long items = static_cast<long long>(c.vecs) + d.vecs + c.head
                          + c.tail + d.head + d.tail;
  const long long wave = static_cast<long long>(per_sm) * sketch::sm_count();
  long long blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > wave ? wave : blocks);
  return static_cast<int>(sketch::launch_dependent(
      sketch_reset_kernel, static_cast<int>(blocks), kThreads,
      static_cast<cudaStream_t>(stream), c, d));
}
