// Key hashing and the TinyLFU estimate shared by the batched sketch kernels
// (sketch_update.cu, sketch_estimate.cu, admission.cu, sketch_reset.cu).
//
// The hash is the reference's 32-bit-lane family on uint32_t
// (src/repro/kernels/sketch_common.py mix32 / probe_index / dk_probe_index):
// h = mix32(lo + salt) ^ mix32(hi ^ 0x85EBCA6B ^ salt), with the probe salt
// PROBE_SALTS[p % 8] + 0x9E3779B9 * (p / 8), xor 0xDEADBEEF before the add
// for doorkeeper probes.  The sketch is the reference's layout: 4-bit
// counters packed eight to a word, (rows, width / 8) words, and a
// doorkeeper bitset of dk_bits / 32 words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sketch {

constexpr int kMaxRows = 8;     // DeviceSketchConfig: rows <= 8
constexpr int kMaxDkp = 8;      // the wrappers check dk_probes <= 8

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t salted_hash(uint32_t lo, uint32_t hi,
                                                uint32_t salt) {
  return mix32(lo + salt) ^ mix32(hi ^ 0x85EBCA6Bu ^ salt);
}

__device__ __forceinline__ uint32_t base_salt(int p) {
  switch (p & 7) {
    case 0: return 0x9E3779B9u;
    case 1: return 0x85EBCA6Bu;
    case 2: return 0xC2B2AE35u;
    case 3: return 0x27D4EB2Fu;
    case 4: return 0x165667B1u;
    case 5: return 0xD3A2646Cu;
    case 6: return 0xFD7046C5u;
    default: return 0xB55A4F09u;
  }
}

// Counter probe p of a key: its index into a row of `width` (pow2) counters.
__device__ __forceinline__ uint32_t probe_index(uint32_t lo, uint32_t hi,
                                                int p, uint32_t width) {
  const uint32_t salt = base_salt(p) + 0x9E3779B9u * static_cast<uint32_t>(p >> 3);
  return salted_hash(lo, hi, salt) & (width - 1u);
}

// Doorkeeper probe p of a key: its bit position in a `dk_bits` (pow2) set.
__device__ __forceinline__ uint32_t dk_probe_index(uint32_t lo, uint32_t hi,
                                                   int p, uint32_t dk_bits) {
  const uint32_t salt =
      (base_salt(p) ^ 0xDEADBEEFu) + 0x9E3779B9u * static_cast<uint32_t>(p >> 3);
  return salted_hash(lo, hi, salt) & (dk_bits - 1u);
}

struct Geometry {
  int rows, width, dk_bits, dk_probes;
};

// The paper's estimate of one key: min over rows of its counters (from 15),
// +1 iff every doorkeeper probe bit is set (only with a doorkeeper).  Every
// load of the key is issued before any is used, so a key costs one round
// trip to the L2, not rows + dk_probes of them.
__device__ __forceinline__ int estimate(const uint32_t* __restrict__ counters,
                                        const uint32_t* __restrict__ dk,
                                        uint32_t lo, uint32_t hi,
                                        const Geometry& g) {
  const int wpr = g.width >> 3;
  uint32_t cw[kMaxRows], sh[kMaxRows], dw[kMaxDkp], db[kMaxDkp];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < g.rows) {
      const uint32_t idx = probe_index(lo, hi, r, g.width);
      sh[r] = (idx & 7u) * 4u;
      cw[r] = __ldg(counters + r * wpr + (idx >> 3));
    }
  }
  if (g.dk_bits) {
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p) {
      if (p < g.dk_probes) {
        db[p] = dk_probe_index(lo, hi, p, g.dk_bits);
        dw[p] = __ldg(dk + (db[p] >> 5));
      }
    }
  }
  uint32_t est = 15u;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < g.rows) {
      const uint32_t v = (cw[r] >> sh[r]) & 0xFu;
      est = v < est ? v : est;
    }
  }
  if (g.dk_bits) {
    uint32_t ok = 1u;
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p)
      if (p < g.dk_probes) ok &= dw[p] >> (db[p] & 31u);
    est += ok & 1u;
  }
  return static_cast<int>(est);
}

// Launch shape of the one-thread-per-item kernels: 256 threads a block,
// enough blocks for every item, at most 8 per SM of an H100 (grid-stride).
inline int blocks_for(int n) {
  const int b = (n + 255) / 256;
  return b < 1 ? 1 : (b > 132 * 8 ? 132 * 8 : b);
}

}  // namespace sketch

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
