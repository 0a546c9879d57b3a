// Conservative-update batch adds for Hopper (sm_90a).
//
// Replaces the TPU kernel add_pallas / _update_kernel of
// src/repro/kernels/sketch_update.py.  One launch adds the b keys of a
// batch to the sketch in device memory, in place (the analogue of the
// reference's input_output_aliases), with the reference's sequential
// semantics.  Per key, in batch order: doorkeeper test-and-set, where each
// probe sees the bits set by earlier keys and by the key's own earlier
// probes; then, iff every probe was present (or there is no doorkeeper) and
// the minimum of the key's row nibbles is below cap, +1 on every row at that
// minimum.  The size register is the caller's: it lives on the host.
//
// What bounds it on this card: the bytes are tiny (rows + dk_probes words
// per key against 3.35 TB/s).  Walked key by key the batch is one dependent
// chain through the L2 (the first design: 446 ns per key on an NVIDIA H100
// 80GB HBM3 at 700 W).  But the chain that is truly sequential is much
// shorter, and the parallel batch update removes the rest:
//
// 1. Doorkeeper gates in parallel.  Within a batch the doorkeeper's bits
//    are only ever set, so a probe of key i finds its bit set iff it was
//    set before the launch, or a key j < i probes it (first[bit] < i), or
//    an earlier probe of key i has the same bit.  first[] is kept for the
//    bits that were not set (an insert into a table keyed by the bit, the
//    least key index kept); the first key to touch such a bit ORs it in.
// 2. Components.  Keys that pass their gate and share a counter nibble
//    (row, index) are joined by min-label propagation over a nibble table
//    (block barriers, until nothing changes; one pointer jump per round).
//    Two components never share a nibble, so they can run side by side.
// 3. One walk per component, in batch order, on nibble values held in
//    shared memory: one thread for a component whose keys all have the
//    same nibbles (a key and its repeats: g identical steps), one warp for
//    a component of several keys (lanes find its keys by ballot, lane r
//    walks row r, the minimum by __reduce_min_sync).
// 4. Each walk adds its nibbles' changes once, atomicAdd(word, delta <<
//    shift).  A delta takes a nibble to at most cap <= 15, so it never
//    carries into the next one, and nothing else writes the counters then.
//
// One CTA of up to 1,024 threads, one thread per key, runs the batch as
// tiles of up to kTile keys, one after another, each applied in full
// (block barrier) before the next reads the sketch; the sketch is read
// with __ldcg (L2, not a stale L1 line).  The tile is what shared memory
// holds: two open-addressing tables of 64-bit entries (key, least index
// or label: an insert and its atomicMin are one CAS), the doorkeeper's
// then the nibbles' in one union region, sized to twice the tile's
// probes, and the tile's nibble slots and labels: 101 KB at S's geometry
// (rows 4, 3 doorkeeper probes), 189 KB at rows = dk_probes = 8, under
// the 227 KB a block may use.  A workspace in global memory would allow
// larger tiles at the cost of L2 round trips in every phase.  A batch
// smaller than the tile gets a tile (tables, threads) of its own size,
// rounded up to a warp.  Every phase's global loads are issued before its
// shared-memory inserts; a barrier waits for them all the same.  What is
// left bounds it: one SM's random shared-memory accesses (the inserts)
// and scattered L2 loads, phase by phase (python -m
// repro_torch.kernels.phase_timing; PERF.md).
//
// The doorkeeper probe count is a template parameter (loops unroll
// exactly); rows stay a runtime count under unrolled predicates.  More
// than kMaxDkp = 8 probes (the reference has no limit) take one more
// instance, D = kLoop, with the count a runtime argument; the 0-8-probe
// instances' code is the same as before it.  It keeps no probe in
// registers across phases: in phase 1 a key's probes go into the
// doorkeeper table in groups of 8 (the group's loads first), each with
// its order i * dk_probes + p in place of the key index i, and in phase 2
// each probe is hashed again and looked up.  A bit's least order then
// says both what the key index does (an earlier key probed it) and what
// the comparison with the key's earlier probes does, so the gate and the
// first touch's OR are the reference's.  Its tile is the largest multiple
// of a warp whose Layout fits kSmemLimit (384 keys at 20 probes); past
// 256 probes not even a warp's table fits, and the launch is refused.
#include "sketch_common.cuh"

namespace {

using sketch::kMaxDkp;
using sketch::kMaxRows;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 1024;               // keys per tile = most threads
constexpr uint32_t kNone = 0xffffffffu;   // label of a key whose gate failed
constexpr int kSmemLimit = 232448;        // bytes a block may use on sm_90
constexpr int kLoop = -1;                 // D of the instance past kMaxDkp

__host__ __device__ constexpr int log2_ceil(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// log2 of a table's slots: twice `probes` entries (load at most one half),
// at least 64.
__host__ __device__ constexpr int table_log2(int probes) {
  const int l = log2_ceil(2 * probes);
  return l < 6 ? 6 : l;
}

// Shared memory of one tile of `tile` keys, in bytes and offsets.
struct Layout {
  int log2n, log2d;
  int region;                  // union: doorkeeper table | nibble table
  int lab, cnt, last, nslot, multi, bytes;

  __host__ __device__ constexpr Layout(int tile, int rows, int dkp)
      : log2n(table_log2(tile * rows)),
        log2d(dkp ? table_log2(tile * dkp) : 0), region(0), lab(0), cnt(0),
        last(0), nslot(0), multi(0), bytes(0) {
    const int nib = (1 << log2n) * 10;     // entry (u64); value, delta (u8)
    const int dkt = dkp ? (1 << log2d) * 8 : 0;    // entry (u64)
    region = nib > dkt ? nib : dkt;
    lab = region;
    cnt = lab + 4 * tile;
    last = cnt + 4 * tile;
    nslot = last + 4 * tile;                // u16 per (key, row)
    multi = nslot + 2 * tile * rows;
    bytes = multi + tile;
  }
};

static_assert(Layout(kTile, kMaxRows, kMaxDkp).bytes <= kSmemLimit,
              "a full tile at the most rows and doorkeeper probes must fit");

#ifdef SKETCH_UPDATE_CLOCKS
// The phase-timing build (python -m repro_torch.kernels.phase_timing):
// thread 0 adds each phase's cycles, barrier to barrier, over every tile
// of every launch, and the rounds of phase 5 into the last entry.
constexpr int kPhases = 8;
__device__ unsigned long long phase_cycles[kPhases + 1];
#define PHASE_END(k)                                                    \
  if (threadIdx.x == 0) {                                               \
    const long long now = clock64();                                    \
    phase_cycles[k] += static_cast<unsigned long long>(now - mark);     \
    mark = now;                                                         \
  }
#else
#define PHASE_END(k)
#endif

using u64 = unsigned long long;

__device__ __forceinline__ uint32_t slot_hash(uint32_t id, int log2cap) {
  return (id * 0x9E3779B1u) >> (32 - log2cap);
}

// A table entry: (id + 1) << 32 | the least key index (or label) seen with
// it; 0 = empty.  Returns the slot of `id` in the open-addressing table of
// 2^log2cap entries, inserted with `idx` if absent, its index lowered to
// `idx` if higher.  Linear probing; the table is at most half full.
__device__ __forceinline__ uint32_t insert_min(u64* tab, uint32_t id,
                                               uint32_t idx, int log2cap) {
  const uint32_t mask = (1u << log2cap) - 1u, k = id + 1u;
  const u64 want = (static_cast<u64>(k) << 32) | idx;
  uint32_t s = slot_hash(id, log2cap);
  while (true) {
    u64 seen = tab[s];
    if (seen == 0ull) {
      seen = atomicCAS(tab + s, 0ull, want);
      if (seen == 0ull) return s;
    }
    if (static_cast<uint32_t>(seen >> 32) == k) {
      if (static_cast<uint32_t>(seen) > idx) atomicMin(tab + s, want);
      return s;
    }
    s = (s + 1u) & mask;
  }
}

// The slot of `id` in the table, or kNone if it is absent.
__device__ __forceinline__ uint32_t find(const u64* tab, uint32_t id,
                                         int log2cap) {
  const uint32_t mask = (1u << log2cap) - 1u, k = id + 1u;
  for (uint32_t s = slot_hash(id, log2cap);; s = (s + 1u) & mask) {
    const u64 seen = tab[s];
    if (seen == 0ull) return kNone;
    if (static_cast<uint32_t>(seen >> 32) == k) return s;
  }
}

// Zero `bytes` (a multiple of 16) of shared memory at `p`, all threads.
__device__ __forceinline__ void zero_shared(void* p, int bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (int j = threadIdx.x; j < bytes / 16; j += blockDim.x)
    q[j] = make_uint4(0u, 0u, 0u, 0u);
}

// D: doorkeeper probes per key, 0 without a doorkeeper, or kLoop; the
// kLoop instance takes the probe count as its one argument in `more`
// (the other instances have none, so their signature is unchanged).
template <int D, typename... More>
__global__ void __launch_bounds__(kTile) sketch_update_kernel(
    uint32_t* counters, uint32_t* dk, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ hi, int b, int rows, int width, int cap,
    int dk_bits, int tile, More... more) {
  extern __shared__ __align__(16) unsigned char smem[];
  int dkp = D;
  if constexpr (D == kLoop) dkp = (more + ...);
  const Layout L(tile, rows, dkp);
  // the union region: the doorkeeper table in phases 0-2, the nibble table
  // and its values and deltas from phase 3 on
  u64* dtab = reinterpret_cast<u64*>(smem);
  u64* ntab = reinterpret_cast<u64*>(smem);
  const int ncap = 1 << L.log2n;
  uint8_t* nv = smem + 8 * ncap;
  uint8_t* nd = nv + ncap;
  uint32_t* lab = reinterpret_cast<uint32_t*>(smem + L.lab);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem + L.cnt);
  uint32_t* last = reinterpret_cast<uint32_t*>(smem + L.last);
  uint16_t* nslot = reinterpret_cast<uint16_t*>(smem + L.nslot);
  uint8_t* multi = smem + L.multi;

  const int t = threadIdx.x, i = t;       // this thread's key in the tile
  const int lane = t & 31;
  const uint32_t ui = static_cast<uint32_t>(i);
  const int wpr = width >> 3;
  const int log2w = __ffs(width) - 1;
  const uint32_t ucap = static_cast<uint32_t>(cap);
#ifdef SKETCH_UPDATE_CLOCKS
  long long mark = clock64();
#endif
  uint32_t klo = 0, khi = 0;
  if (i < b) {
    klo = lo[i];
    khi = hi[i];
  }

  for (int base = 0; base < b; base += tile) {
    const int n = b - base < tile ? b - base : tile;
    const bool live = i < n;

    // -- 0: reset the doorkeeper table and the per-key arrays ------------
    if (D) zero_shared(dtab, 8 << L.log2d);
    cnt[t] = 0u;
    last[t] = 0u;
    multi[t] = 0;
    __syncthreads();
    PHASE_END(0)

    // -- 1: the bits as they were before the tile; each bit that was not
    //       set gets its first key in the tile ----------------------------
    uint32_t dbit[D > 0 ? D : 1], dslot[D > 0 ? D : 1];
    bool pre[D > 0 ? D : 1];
    if constexpr (D == kLoop) {
      const uint32_t order = ui * static_cast<uint32_t>(dkp);
      for (int p0 = 0; live && p0 < dkp; p0 += kMaxDkp) {
        uint32_t bit[kMaxDkp], word[kMaxDkp];
#pragma unroll
        for (int q = 0; q < kMaxDkp; ++q) {
          if (p0 + q < dkp) {
            bit[q] = sketch::dk_probe_index(klo, khi, p0 + q, dk_bits);
            word[q] = __ldcg(dk + (bit[q] >> 5));
          }
        }
#pragma unroll
        for (int q = 0; q < kMaxDkp; ++q)
          if (p0 + q < dkp && !((word[q] >> (bit[q] & 31u)) & 1u))
            insert_min(dtab, bit[q], order + p0 + q, L.log2d);
      }
    } else if (live) {
      uint32_t dword[D > 0 ? D : 1];
#pragma unroll
      for (int p = 0; p < D; ++p) {
        dbit[p] = sketch::dk_probe_index(klo, khi, p, dk_bits);
        dword[p] = __ldcg(dk + (dbit[p] >> 5));
      }
#pragma unroll
      for (int p = 0; p < D; ++p) {
        pre[p] = (dword[p] >> (dbit[p] & 31u)) & 1u;
        if (!pre[p]) dslot[p] = insert_min(dtab, dbit[p], ui, L.log2d);
      }
    }
    if (D) __syncthreads();
    PHASE_END(1)

    // -- 2: the gate; the first key to probe a bit sets it ----------------
    bool gated = live;
    if constexpr (D == kLoop) {
      const uint32_t order = ui * static_cast<uint32_t>(dkp);
      for (int p = 0; live && p < dkp; ++p) {
        const uint32_t bit = sketch::dk_probe_index(klo, khi, p, dk_bits);
        const uint32_t s = find(dtab, bit, L.log2d);
        if (s == kNone) continue;                 // set before the tile
        const uint32_t first = static_cast<uint32_t>(dtab[s]);
        gated = gated && first < order + p;
        if (first == order + p)
          atomicOr(dk + (bit >> 5), 1u << (bit & 31u));
      }
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
      if (live && !pre[p]) {
        const uint32_t first = static_cast<uint32_t>(dtab[dslot[p]]);
        bool earlier = false;
#pragma unroll
        for (int q = 0; q < p; ++q) earlier = earlier || dbit[q] == dbit[p];
        gated = gated && (first < ui || earlier);
        if (first == ui && !earlier)
          atomicOr(dk + (dbit[p] >> 5), 1u << (dbit[p] & 31u));
      }
    }
    if (live) lab[i] = gated ? ui : kNone;
    __syncthreads();
    PHASE_END(2)

    // -- 3: reset the nibble table and deltas (the doorkeeper's is done) --
    zero_shared(ntab, 8 * ncap);
    zero_shared(nd, ncap);
    __syncthreads();
    PHASE_END(3)

    // -- 4: the gated keys' nibbles into the table, labelled by key index;
    //       their words loaded for phase 6 ---------------------------------
    uint32_t cw[kMaxRows], shifts = 0;
    if (gated) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const uint32_t idx = sketch::probe_index(klo, khi, r, width);
          cw[r] = __ldcg(counters + r * wpr + (idx >> 3));
          shifts |= (idx & 7u) << (3 * r);
          nslot[i * rows + r] = insert_min(
              ntab, (static_cast<uint32_t>(r) << log2w) | idx, ui, L.log2n);
        }
      }
    }
    __syncthreads();
    PHASE_END(4)

    // -- 5: components: min-label propagation over shared nibbles, one
    //       pointer jump a round.  A key takes the least label on its
    //       nibbles and lowers those still above it; the rounds end when
    //       none was lowered, so every nibble holds its keys' label --------
    while (true) {
      bool lowered = false;
      if (gated) {
        uint32_t m = lab[i];
        for (int r = 0; r < rows; ++r) {
          const uint32_t v = static_cast<uint32_t>(ntab[nslot[i * rows + r]]);
          m = v < m ? v : m;
        }
        const uint32_t jump = lab[m];     // a label is a key of its component
        m = jump < m ? jump : m;
        if (m < lab[i]) lab[i] = m;
        for (int r = 0; r < rows; ++r) {
          u64* e = ntab + nslot[i * rows + r];
          const u64 seen = *e;
          if (static_cast<uint32_t>(seen) > m) {
            atomicMin(e, (seen & 0xffffffff00000000ull) | m);
            lowered = true;
          }
        }
      }
#ifdef SKETCH_UPDATE_CLOCKS
      if (t == 0) ++phase_cycles[kPhases];
#endif
      if (!__syncthreads_or(lowered)) break;
    }
    PHASE_END(5)

    // -- 6: per component: keys (warp-aggregated), last key, several
    //       nibble tuples or one; every nibble's value before the tile ----
    const uint32_t root = gated ? lab[i] : kNone;
    const unsigned peers = __match_any_sync(kFull, root);
    if (gated) {
      if (lane == __ffs(peers) - 1) {
        atomicAdd(cnt + root, static_cast<uint32_t>(__popc(peers)));
        atomicMax(last + root, static_cast<uint32_t>((t & ~31) + 31 -
                                                     __clz(peers)));
      }
      bool same = true;
      for (int r = 0; r < rows; ++r)
        same = same && nslot[i * rows + r] == nslot[root * rows + r];
      if (!same) multi[root] = 1;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < rows)
          nv[nslot[i * rows + r]] = static_cast<uint8_t>(
              (cw[r] >> (((shifts >> (3 * r)) & 7u) * 4u)) & 0xFu);
    }
    __syncthreads();
    PHASE_END(6)

    // -- 7: walks, each applying its nibbles' changes.  A one-key
    //       component walks in its root's thread (g identical steps) ------
    if (gated && root == ui && !multi[i]) {
      uint32_t v[kMaxRows], v0[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < rows) v[r] = v0[r] = nv[nslot[i * rows + r]];
      const uint32_t g = cnt[i];
      for (uint32_t k = 0; k < g; ++k) {
        uint32_t m = 15u;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < rows) m = v[r] < m ? v[r] : m;
        if (m >= ucap) break;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < rows && v[r] == m) ++v[r];
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows && v[r] != v0[r]) {
          const uint32_t sh = (shifts >> (3 * r)) & 7u;
          const uint32_t id =
              static_cast<uint32_t>(ntab[nslot[i * rows + r]] >> 32) - 1u;
          atomicAdd(counters + r * wpr + ((id & (width - 1)) >> 3),
                    (v[r] - v0[r]) << (sh * 4u));
        }
      }
    }
    // a component of several keys walks in its root's warp, in batch
    // order: lanes find its keys by ballot, lane r walks row r
    unsigned roots = __ballot_sync(kFull, gated && root == ui && multi[i]);
    while (roots) {
      const uint32_t c = (t & ~31) + __ffs(roots) - 1, end = last[c];
      roots &= roots - 1u;
      for (int pass = 0; pass < 2; ++pass) {   // walk, then apply
        for (uint32_t j0 = c; j0 <= end; j0 += 32) {
          const uint32_t j = j0 + lane;
          unsigned mask = __ballot_sync(kFull, j <= end && lab[j] == c);
          while (mask) {
            const uint32_t occ = j0 + __ffs(mask) - 1;
            mask &= mask - 1u;
            const uint32_t s = lane < rows ? nslot[occ * rows + lane] : 0u;
            if (pass == 0) {
              const uint32_t v = lane < rows ? nv[s] : 15u;
              const uint32_t m = __reduce_min_sync(kFull, v);
              if (lane < rows && m < ucap && v == m) {
                nv[s] = static_cast<uint8_t>(v + 1u);
                nd[s] = static_cast<uint8_t>(nd[s] + 1u);
              }
            } else if (lane < rows && nd[s]) {   // each nibble once
              const uint32_t id = static_cast<uint32_t>(ntab[s] >> 32) - 1u;
              const uint32_t idx = id & (width - 1);
              atomicAdd(counters + lane * wpr + (idx >> 3),
                        static_cast<uint32_t>(nd[s]) << ((idx & 7u) * 4u));
              nd[s] = 0;
            }
            __syncwarp();
          }
        }
      }
    }
    // the next tile's keys, loaded while this one finishes
    if (base + tile + i < b) {
      klo = lo[base + tile + i];
      khi = hi[base + tile + i];
    }
    __syncthreads();
    PHASE_END(7)
  }
}

using Launch = int (*)(uint32_t*, uint32_t*, const uint32_t*,
                       const uint32_t*, int, int, int, int, int,
                       cudaStream_t);

template <int D>
int launch(uint32_t* counters, uint32_t* dk, const uint32_t* lo,
           const uint32_t* hi, int b, int rows, int width, int cap,
           int dk_bits, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      sketch_update_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int tile = b < kTile ? (b + 31) / 32 * 32 : kTile;
  const Layout L(tile, rows, D);
  sketch_update_kernel<D><<<1, tile, L.bytes, stream>>>(
      counters, dk, lo, hi, b, rows, width, cap, dk_bits, tile);
  return static_cast<int>(cudaGetLastError());
}

constexpr Launch kLaunch[kMaxDkp + 1] = {
    launch<0>, launch<1>, launch<2>, launch<3>, launch<4>,
    launch<5>, launch<6>, launch<7>, launch<8>};

// The kLoop instance's tile: the largest multiple of a warp, at most kTile
// and at most b rounded up to a warp, whose shared memory fits; 0 if not
// even a warp's does.
int loop_tile(int b, int rows, int dkp) {
  int tile = b < kTile ? (b + 31) / 32 * 32 : kTile;
  while (tile > 0 && Layout(tile, rows, dkp).bytes > kSmemLimit) tile -= 32;
  return tile;
}

int launch_loop(uint32_t* counters, uint32_t* dk, const uint32_t* lo,
                const uint32_t* hi, int b, int rows, int width, int cap,
                int dk_bits, int dkp, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      sketch_update_kernel<kLoop, int>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int tile = loop_tile(b, rows, dkp);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(tile, rows, dkp);
  sketch_update_kernel<kLoop, int><<<1, tile, L.bytes, stream>>>(
      counters, dk, lo, hi, b, rows, width, cap, dk_bits, tile, dkp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef SKETCH_UPDATE_CLOCKS
// Copy the phase-timing build's cycle counts to `out` (kPhases + 1 entries)
// and zero them.
extern "C" int sketch_update_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles,
                                         sizeof(phase_cycles));
  if (err == cudaSuccess) {
    const unsigned long long zero[kPhases + 1] = {};
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif

extern "C" int sketch_update_launch(int* counters, int* dk, const int* lo,
                                    const int* hi, int b, int rows,
                                    int width, int cap, int dk_bits,
                                    int dk_probes, void* stream) {
  const int d = dk_bits ? dk_probes : 0;
  if (d < 0 || rows < 1 || rows > kMaxRows || cap > 15 ||
      static_cast<uint64_t>(rows) * static_cast<uint64_t>(width) >=
          (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d > kMaxDkp)
    return launch_loop(reinterpret_cast<uint32_t*>(counters),
                       reinterpret_cast<uint32_t*>(dk),
                       reinterpret_cast<const uint32_t*>(lo),
                       reinterpret_cast<const uint32_t*>(hi), b, rows, width,
                       cap, dk_bits, d, static_cast<cudaStream_t>(stream));
  return kLaunch[d](reinterpret_cast<uint32_t*>(counters),
                    reinterpret_cast<uint32_t*>(dk),
                    reinterpret_cast<const uint32_t*>(lo),
                    reinterpret_cast<const uint32_t*>(hi), b, rows, width,
                    cap, dk_bits, static_cast<cudaStream_t>(stream));
}
