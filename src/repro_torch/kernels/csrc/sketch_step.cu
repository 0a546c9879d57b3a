// Fused cache chunk step for Hopper (sm_90a): W-TinyLFU and the policy panel.
//
// Replaces the TPU kernel step_pallas / _step_kernel of
// src/repro/kernels/sketch_step.py: one launch advances one chunk of
// n_valid accesses of one stream (or of each of B tenant lanes, one CTA per
// lane: the lane grid below) through the doorkeeper test-and-insert,
// the conservative count-min add with the section 3.3 reset, the window /
// main lookup, the candidate-vs-victim estimate, the admission verdict and
// the table writes, with one hit flag per access.  The state lives in device
// memory and is updated in place (the analogue of the reference's
// input_output_aliases): the kernel allocates and copies nothing.
//
// What bounds it on this card: each access depends on the state the previous
// access left, so the chunk is one dependent chain.  Per access it touches a
// few dozen words (probe words of the sketch, one window set and up to four
// main sets), so the bytes it must move are tiny against 3.35 TB/s; the time
// goes to the latency of the dependent L2 round trips and of the one warp's
// instruction chain.
//
// What the design does about it: one block per stream; warp 0 runs the
// per-access chain, and every thread of the block tracks the sketch size
// register itself (it advances by one per access and halves at a reset,
// independent of the data), so the whole block meets at __syncthreads only
// on the accesses where the reset fires and then halves the sketch together.
// In the set-associative layout an access waits on at most three dependent
// round trips to L2 (one on a hit):
//
//  0. The inputs (key lanes, set indices, probes) come an access ahead.  The
//     access's window set, the lo/hi/meta columns of its two main sets and
//     its sketch add's words are loaded together.  (Loading the next
//     access's sets ahead too, before this access's writes, and reloading
//     what it wrote, measured slower: the extra loads delay the warp's
//     reductions more than the round trip they hide.)
//  1. The records sit in registers: lane l holds way l (+ 32 r) of the
//     window set, and lanes 0-15 / 16-31 hold way (l & 15) (+ 16 r) of the
//     first / second main set, so a first-match lookup is one __ballot_sync
//     and __ffs, and a first-index argmin is __reduce_min_sync, a ballot of
//     equality and __ffs (ties go to the lowest way, the first set before
//     the second).  An entry's probes sit one per lane (row r in lane r,
//     doorkeeper probe p in lane 8 + p), so its sketch words are one load
//     and its estimate one __reduce_min_sync and one ballot; the add's
//     doorkeeper bits go in with atomicOr (probes sharing a word merge).
//  2. On a miss that pushes the window's LRU record out, the candidate's two
//     main sets (meta and probe columns) and its sketch words are loaded
//     together.  The main sets cannot have changed in this access (only a
//     hit changes them), so they are read straight from the table.
//  3. If the weakest of those 2A records is occupied, its sketch words.
//
// Only what changes is written: on a hit the meta word of the hit way (and
// of the demoted way); on a miss the window row written and the inserted
// victim record.  No two of these writes share a word, so the reference's
// write order (km1, km2, c1, c2, window) holds trivially.  The sketch stays
// in global memory (L2-resident at the main path's 512 KB).  The flat layout
// (exact global tables, the golden runs' G1/G2) keeps warp-shuffle
// reductions over slots in global memory.
//
// The lane grid (streams=B, the reference's pallas grid dimension over
// lanes): B independent chains, so CTA l takes lane l.  It offsets every
// state pointer, its key and probe lanes and its hit row by the lane's
// stride (64-bit arithmetic), reads params with a lane stride of 0 (shared)
// or NPARAMS (per lane) and its own n_valid, and writes its own regs from
// its thread 0.  Nothing is shared between CTAs.  A single-stream launch
// (lanes == 0) runs the kernel instance without the offsets, one CTA.
//
// The sharded sketch (shards > 1, the reference's [global || delta] halves
// in one buffer: halves == 2) is the kShard instance.  Each row and
// doorkeeper lane loads its global and its delta word, two independent
// loads in one round trip; a counter is the sum of the two fields and a
// doorkeeper bit their OR; the bump writes delta + 1 into the delta word and
// atomicOr sets the bit in the delta half.  The per-access reset is compiled
// out (the epoch fold, kernels/sketch_merge.py, ages the sketch), and with
// lanes every lane's sketch is two halves long.  The probes arrive confined
// to the key's shard, so nothing else changes.  The sharded sketch has its
// own overloads of the word functions, so kShard = false compiles the code
// of the unsharded kernel.
//
// The adaptive window (adaptive = 1, the reference's runtime window quota)
// is the kAdapt instance, compiled in a second build of this file with
// -DSKETCH_STEP_ADAPTIVE (built in parallel with the first; each library
// holds one of the two sets of instances, so the static instances compile
// exactly as without it).  The quota and the flat tables' resident counts
// and the epoch's hits stay in registers for the chunk beside size and t;
// stamps are 2t in the window and 2t + 1 in main.  Flat tables: the
// protected budget follows main's runtime capacity (total - quota), the
// drain waits for a main hit, and at quota the argmins read EMPTY slots as
// padding.  Set tables: a set's ways at or past its usable count read as
// padding in registers only (the window set's count is one wuw load issued
// with its records; main's is arithmetic on the quota), so every decision
// skips them; the kernel writes only chosen records, so a masked way is
// never written and stays EMPTY in storage.  Lane 0 adds each access to its
// window set's wsl count with a fire-and-forget atomic.  The epoch's
// rebalance (kernels/sketch_step.py) moves the quota between launches.
//
// The policy panel (policy = S3-FIFO, ARC or LFU, the reference's
// _one_access_set_s3fifo / _arc / _lfu) is the kPol template parameter of
// the set path, compiled in a third build with -DSKETCH_STEP_PANEL (24
// instances: three policies x RM x kLanes, unsharded and static; no flat
// one).  S3-FIFO reuses the window set's records as the small FIFO, marks
// main hits, and admits the pushed candidate on est >= 2 alone.  ARC has no
// sketch (the add and reset compile out), keeps p, |T1| and the ghost
// counts in registers for the chunk and loads the key's B1/B2 words with
// its main sets; on an eviction it loads the victim's stored probes, then
// their ghost words, and (rarely) clears a saturated half with the warp.
// LFU loads no window set; on a miss each lane estimates its own records of
// the key's two sets and the warp takes the minimum (estimate, stamp).
//
// The stale mesh step (mesh = 1, the reference's _sketch_add_mesh and
// _estimate_pair_stale; kernel mode 1e) is the kMesh instance of the static
// and adaptive builds: counters/dk hold only the global halves, so every
// estimate is the unsharded one on them, and the add (add_mesh) composes
// the global words with this rank's delta blocks and writes the deltas,
// only where the rank owns the key's shard; no per-access reset.  The wide
// instances (RM = kWideSet, kWideFlat; more than 8 doorkeeper probes or 128
// ways) keep no record in registers: the add runs on one thread, the flat
// path's lookups as before with the probes read from the tables, and the
// set path's accesses on one thread (access_exact*), which also takes a
// fault's out-of-range table addresses.
//
// Timing probes (python -m repro_torch.kernels.phase_timing) build this file
// with -DSKETCH_STEP_SKIP_ADD or -DSKETCH_STEP_SKIP_ACCESS to compile one
// phase out of the loop; the engine's build defines neither.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kI32Max = 0x7fffffff;
constexpr int kProt = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 8;
constexpr int kMaxDkp = 8;       // past it: the wide instances
constexpr int kMaxWays = 128;    // past it: the wide instances
constexpr int kWideSet = -1;     // RM of the wide set-associative instances
constexpr int kWideFlat = -2;    // RM of the wide flat instances
constexpr int kNRegs = 8;        // NREGS

enum { P_WINDOW_CAP, P_MAIN_CAP, P_PROT_CAP, P_SAMPLE, P_CAP, P_WARMUP };
enum { R_SIZE, R_PCOUNT, R_T, R_HITS, R_WQUOTA, R_WCOUNT, R_MCOUNT,
       R_EHITS };
#ifdef SKETCH_STEP_ADAPTIVE
constexpr bool kAdaptBuild = true;
#else
constexpr bool kAdaptBuild = false;
#endif
// the policy of a set-path instance (StepArgs.policy: the index in
// sketch_common.POLICIES)
enum { kWtinylfu, kS3fifo, kArc, kLfu };
enum { WT_LO, WT_HI, WT_META, WT_MSET, WT_MSET2 };
enum { MT_LO, MT_HI, MT_META };

}  // namespace

// Mirrored field for field by _Args in sketch_step.py (the fields the
// panel added last, so the others keep their offsets).
struct StepArgs {
  const int* lo;
  const int* hi;
  const int* kidx;      // (b, rows) probe positions
  const int* kdkb;      // (b, dkp) doorkeeper bit positions
  const int* kwset;     // (b,) window set
  const int* kmset;     // (b, 2) main set choices
  const int* params;    // (NPARAMS,)
  int* counters;
  int* dk;
  int* wlo; int* whi; int* wmeta; int* widx; int* wdkb;   // flat layout
  int* mlo; int* mhi; int* mmeta; int* midx; int* mdkb;
  int* wtab; int* mtab;                                    // set layout
  int* regs;
  int* hits;            // (b,)
  const int* nvalid;    // lane grid: (lanes,) per-lane n_valid, or NULL
  int* wsl;             // adaptive set layout: (window sets,) traffic
  const int* wuw;       // adaptive set layout: (window sets,) usable ways
  int n_valid, b, rows, dkp, dk_bits, counter_bits, words_per_row,
      counter_words, dk_words, window_slots, main_slots, assoc, wcols, mcols;
  int lanes;            // 0: one stream; B >= 1: the lane grid of B CTAs
  int params_stride;    // lane grid: 0 (shared params) or NPARAMS
  int halves;           // 1: one sketch; 2: [global || delta] (sharded)
  int adaptive;         // 1: the runtime window quota (the kAdapt build)
  int policy;           // kWtinylfu, or a competitor (the panel build)
  int* ghost;           // ARC: (2 dk_words,) B1 || B2 ghost Blooms
  // the stale mesh step (mode 1e; after every older field, so their
  // offsets stay): counters/dk hold the global halves, these this rank's
  // delta blocks of its local_shards shards, the first of them mesh_base
  int* dcounters;       // (local_shards, rows, wps_shard)
  int* ddk;             // (local_shards, dkw_shard)
  int mesh;             // 1: the stale mesh step
  int mesh_base, local_shards, width_shard, dk_bits_shard, wps_shard,
      dkw_shard;
  // 1: the tables may hold addresses out of range (a fault's: stored main
  // sets, ARC ghost positions), so the chunk runs on the exact path
  int exact;
};

namespace {

struct Sketch {
  int shift;            // probe -> word: >> 3 (4-bit) or >> 2 (8-bit)
  int cpw_mask;         // counters per word - 1
  uint32_t capmax;      // field mask
};

// What each lane of warp 0 holds of an entry's probes: lane r < rows the
// counter probe of row r, lane 8 + p (p < dkp) the doorkeeper probe p (the
// stored column; it is tested only with a doorkeeper).
struct Lanes {
  int lane;
  bool row, dk, dk_on;
};

// One entry's lanes, set indices and this lane's probe: an access's inputs
// (loaded an access ahead of their use), a candidate or a victim.
struct Entry {
  int lo, hi, w, m1, m2, pr;
};

// The adaptive window's registers for a chunk: the quota, the flat tables'
// resident counts, main's runtime capacity and protected budget, and its
// usable ways per set (mbase, one more below set mrem).
struct Adapt {
  int wquota, wcount, mcount, mcap_rt, prot_rt, mbase, mrem;
};

// ARC's registers for a chunk: the target p, |T1|, and the inserts into the
// B1 and B2 ghost halves since each was last cleared.
struct Arc {
  int p, t1, gb1, gb2;
};

// Floor division and modulo by d > 0 (jnp.int32 // and %).
__device__ __forceinline__ int floordiv(int x, int d) {
  const int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int x, int d) {
  return x - floordiv(x, d) * d;
}

// An int32 product or sum that wraps, as jnp's int32 arithmetic does.
__device__ __forceinline__ int wrap_mul(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) * static_cast<unsigned>(y));
}

// The window and main stamps of access t: t and t (static), 2t and 2t + 1
// (adaptive: unique across the tables, so a record the rebalance moves from
// the window into main never ties a main stamp).
template <bool kAdapt>
__device__ __forceinline__ int wstamp(int t) {
  return kAdapt ? wrap_mul(t, 2) : t;
}

template <bool kAdapt>
__device__ __forceinline__ int mstamp(int t) {
  return kAdapt ? static_cast<int>(static_cast<unsigned>(wrap_mul(t, 2)) + 1u)
                : t;
}

__device__ __forceinline__ void load_key(const StepArgs& a, const Lanes& ln,
                                         int i, Entry& k) {
  k.lo = __ldg(a.lo + i);
  k.hi = __ldg(a.hi + i);
  k.w = __ldg(a.kwset + i);
  k.m1 = __ldg(a.kmset + 2 * i);
  k.m2 = __ldg(a.kmset + 2 * i + 1);
  const int* src = ln.row ? a.kidx + i * a.rows + ln.lane
                          : a.kdkb + i * a.dkp + ln.lane - 8;
  k.pr = ln.row || ln.dk ? __ldg(src) : 0;
}

// A word index as the reference's gathers take it: a negative one counts
// from the end once, then it clamps into [0, n).  Only a stored probe (a
// candidate's or a victim's, kept in the tables) goes through it: table
// state, which a fault may corrupt (core/faults.py).  Branch-free: an
// early return for in-range indices cost F 0.036 ms more a chunk (PERF.md).
__device__ __forceinline__ int clip_index(int i, int n) {
  const int j = i < 0 ? i + n : i;
  return min(max(j, 0), n - 1);
}

// The sketch word this lane's probe addresses (loads only).
__device__ __forceinline__ uint32_t load_word(const StepArgs& a,
                                              const Sketch& s, const Lanes& ln,
                                              int pr) {
  const int* p = ln.row ? a.counters + ln.lane * a.words_per_row
                              + (pr >> s.shift)
                        : a.dk + (pr >> 5);
  return ln.row || ln.dk_on ? static_cast<uint32_t>(*p) : 0u;
}

// This lane's counter (row lanes; the maximum in the others).
__device__ __forceinline__ uint32_t counter_of(const StepArgs& a,
                                               const Sketch& s,
                                               const Lanes& ln, uint32_t w,
                                               int pr) {
  return ln.row ? (w >> ((pr & s.cpw_mask) * a.counter_bits)) & s.capmax
                : 0xffffffffu;
}

// TinyLFU estimate of an entry from its loaded words: the minimum over the
// row lanes, +1 when every doorkeeper lane's bit is set.
__device__ __forceinline__ int estimate_of(const StepArgs& a, const Sketch& s,
                                           const Lanes& ln, uint32_t w,
                                           int pr) {
  int est = static_cast<int>(
      __reduce_min_sync(kFull, counter_of(a, s, ln, w, pr)));
  if (a.dk_bits)
    est += __ballot_sync(kFull, ln.dk_on && !((w >> (pr & 31)) & 1u)) == 0;
  return est;
}

// Doorkeeper gate -> conservative increment, from the key's loaded words.
// A doorkeeper probe passes if its bit was set or an earlier probe has the
// same bit (the reference tests and sets them in turn).  The doorkeeper
// lanes OR their bits in (probes sharing a word merge); the row lanes at the
// minimum bump their counter.  Every lane's load was consumed by the
// reductions before any store.
__device__ __forceinline__ void add_words(const StepArgs& a, const Sketch& s,
                                          const Lanes& ln, int cap,
                                          const Entry& k, uint32_t w) {
  bool gate = true;
  if (a.dk_bits) {
    const unsigned same = __match_any_sync(kFull, ln.dk_on ? k.pr
                                                           : -1 - ln.lane);
    const bool eff = ((w >> (k.pr & 31)) & 1u)
                     || (same & ((1u << ln.lane) - 1u));
    gate = __ballot_sync(kFull, ln.dk_on && !eff) == 0;
  }
  const uint32_t v = counter_of(a, s, ln, w, k.pr);
  const uint32_t m = __reduce_min_sync(kFull, v);
  if (ln.dk_on)
    atomicOr(reinterpret_cast<unsigned*>(a.dk) + (k.pr >> 5),
             1u << (k.pr & 31));
  if (gate && static_cast<int>(m) < cap && ln.row && v == m)
    a.counters[ln.lane * a.words_per_row + (k.pr >> s.shift)] = static_cast<
        int>(w + (1u << ((k.pr & s.cpw_mask) * a.counter_bits)));
}

// The sharded sketch's words of this lane's probe: g in the global half, d
// in the delta half.
struct Words {
  uint32_t g, d;
};

// Both halves' words of this lane's probe: two independent loads.
__device__ __forceinline__ Words load_words(const StepArgs& a,
                                            const Sketch& s, const Lanes& ln,
                                            int pr) {
  const int* p = ln.row ? a.counters + ln.lane * a.words_per_row
                              + (pr >> s.shift)
                        : a.dk + (pr >> 5);
  if (!ln.row && !ln.dk_on) return Words{0u, 0u};
  return Words{static_cast<uint32_t>(*p), static_cast<uint32_t>(
                   p[ln.row ? a.counter_words : a.dk_words])};
}

// The word(s) an instance loads for a probe: one word, or both halves'.
template <bool kShard>
__device__ __forceinline__ auto load_probe(const StepArgs& a, const Sketch& s,
                                           const Lanes& ln, int pr) {
  if constexpr (kShard) return load_words(a, s, ln, pr);
  else return load_word(a, s, ln, pr);
}

// load_probe for a stored probe: each word index clamps (clip_index) into
// the whole sketch array, global and delta indices each on its own, as the
// reference's gathers do.  The key's own probes are hashed, always in
// range, and keep load_probe's code.
template <bool kShard>
__device__ __forceinline__ auto load_stored(const StepArgs& a,
                                            const Sketch& s, const Lanes& ln,
                                            int pr) {
  const int* base = ln.row ? a.counters : a.dk;
  const int n = ln.row ? a.counter_words : a.dk_words;
  const int i = ln.row ? ln.lane * a.words_per_row + (pr >> s.shift)
                       : pr >> 5;
  if constexpr (kShard) {
    if (!ln.row && !ln.dk_on) return Words{0u, 0u};
    return Words{static_cast<uint32_t>(base[clip_index(i, 2 * n)]),
                 static_cast<uint32_t>(base[clip_index(n + i, 2 * n)])};
  } else {
    return ln.row || ln.dk_on ? static_cast<uint32_t>(base[clip_index(i, n)])
                              : 0u;
  }
}

// This lane's counter, global + delta (row lanes; the maximum in the
// others).
__device__ __forceinline__ uint32_t counter_of(const StepArgs& a,
                                               const Sketch& s,
                                               const Lanes& ln, Words w,
                                               int pr) {
  return ln.row ? counter_of(a, s, ln, w.g, pr) + counter_of(a, s, ln, w.d, pr)
                : 0xffffffffu;
}

// The sharded estimate: counters global + delta, doorkeeper bits
// global | delta.
__device__ __forceinline__ int estimate_of(const StepArgs& a, const Sketch& s,
                                           const Lanes& ln, Words w, int pr) {
  int est = static_cast<int>(
      __reduce_min_sync(kFull, counter_of(a, s, ln, w, pr)));
  if (a.dk_bits)
    est += __ballot_sync(kFull, ln.dk_on
                                    && !(((w.g | w.d) >> (pr & 31)) & 1u))
           == 0;
  return est;
}

// The sharded add: the gate tests global | delta bits and the minimum is
// over global + delta counters; the bits and the bump go to the delta half.
__device__ __forceinline__ void add_words(const StepArgs& a, const Sketch& s,
                                          const Lanes& ln, int cap,
                                          const Entry& k, Words w) {
  bool gate = true;
  if (a.dk_bits) {
    const unsigned same = __match_any_sync(kFull, ln.dk_on ? k.pr
                                                           : -1 - ln.lane);
    const bool eff = (((w.g | w.d) >> (k.pr & 31)) & 1u)
                     || (same & ((1u << ln.lane) - 1u));
    gate = __ballot_sync(kFull, ln.dk_on && !eff) == 0;
  }
  const uint32_t v = counter_of(a, s, ln, w, k.pr);
  const uint32_t m = __reduce_min_sync(kFull, v);
  if (ln.dk_on)
    atomicOr(reinterpret_cast<unsigned*>(a.dk) + a.dk_words + (k.pr >> 5),
             1u << (k.pr & 31));
  if (gate && static_cast<int>(m) < cap && ln.row && v == m)
    a.counters[a.counter_words + ln.lane * a.words_per_row
               + (k.pr >> s.shift)] = static_cast<int>(
        w.d + (1u << ((k.pr & s.cpw_mask) * a.counter_bits)));
}

// The stale mesh step's add (mode 1e): the rank that owns the key's shard
// (row 0's probe over width_shard; every probe of a key lies in one shard)
// composes its delta words with the global ones as the sharded add does and
// writes its delta blocks, shard-major (local shard, row, word in shard) and
// (local shard, doorkeeper word in shard); another rank writes nothing.
__device__ __forceinline__ void add_mesh(const StepArgs& a, const Sketch& s,
                                         const Lanes& ln, int cap,
                                         const Entry& k) {
  // each probe lane finds the shard from its own probe (the shard widths
  // are powers of two), so the loads issue as soon as the probe is in
  const int sw = ln.row ? a.width_shard : max(a.dk_bits_shard, 1);
  const int lk = (k.pr >> (__ffs(sw) - 1)) - a.mesh_base;
  const bool local = lk >= 0 && lk < a.local_shards;
  const bool own = ln.row || ln.dk_on;
  const int* gp = ln.row ? a.counters + ln.lane * a.words_per_row
                               + (k.pr >> s.shift)
                         : a.dk + (k.pr >> 5);
  int* dp = ln.row ? a.dcounters + (lk * a.rows + ln.lane) * a.wps_shard
                         + ((k.pr & (sw - 1)) >> s.shift)
                   : a.ddk + lk * a.dkw_shard + ((k.pr & (sw - 1)) >> 5);
  const Words w{own ? static_cast<uint32_t>(*gp) : 0u,
                own && local ? static_cast<uint32_t>(*dp) : 0u};
  if (!__shfl_sync(kFull, local, 0)) return;   // another rank's shard
  bool gate = true;
  if (a.dk_bits) {
    const unsigned same = __match_any_sync(kFull, ln.dk_on ? k.pr
                                                           : -1 - ln.lane);
    const bool eff = (((w.g | w.d) >> (k.pr & 31)) & 1u)
                     || (same & ((1u << ln.lane) - 1u));
    gate = __ballot_sync(kFull, ln.dk_on && !eff) == 0;
  }
  const uint32_t v = counter_of(a, s, ln, w, k.pr);
  const uint32_t m = __reduce_min_sync(kFull, v);
  if (ln.dk_on) atomicOr(reinterpret_cast<unsigned*>(dp), 1u << (k.pr & 31));
  if (gate && static_cast<int>(m) < cap && ln.row && v == m)
    *dp = static_cast<int>(
        w.d + (1u << ((k.pr & s.cpw_mask) * a.counter_bits)));
}

// Warp-wide minimum of (value, index) pairs: ties go to the smaller index,
// and every lane ends with the same pair.
__device__ __forceinline__ void warp_argmin(int& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// First index of the minimum of key(j) over [0, n) (jnp.argmin), lanes
// striding over j; vmin receives the minimum.
template <class Key>
__device__ __forceinline__ int argmin_over(int n, Key key, int& vmin) {
  int bv = kI32Max, bi = kI32Max;
  for (int j = threadIdx.x & 31; j < n; j += 32) {
    const int v = key(j);
    if (v < bv || (v == bv && j < bi)) { bv = v; bi = j; }
  }
  warp_argmin(bv, bi);
  vmin = bv;
  return bi;
}

// First index where pred(j) holds, else 0 (jnp.argmax of a bool mask).
template <class Pred>
__device__ __forceinline__ int first_true(int n, Pred pred, bool& found) {
  int v;
  const int j = argmin_over(n, [&](int k) { return pred(k) ? 0 : 1; }, v);
  found = (v == 0);
  return j;
}

// TinyLFU estimate of one entry from its stored probes (the flat path:
// every lane loads every word).
__device__ __forceinline__ int estimate(const StepArgs& a, const Sketch& s,
                                        const int (&idx)[kMaxRows],
                                        const int (&dkb)[kMaxDkp]) {
  uint32_t est = 0xffffffffu;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < a.rows) {
      const uint32_t w = static_cast<uint32_t>(a.counters[clip_index(
          r * a.words_per_row + (idx[r] >> s.shift), a.counter_words)]);
      const uint32_t v =
          (w >> ((idx[r] & s.cpw_mask) * a.counter_bits)) & s.capmax;
      est = v < est ? v : est;
    }
  }
  if (a.dk_bits) {
    bool ok = true;
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p)
      if (p < a.dkp)
        ok &= (static_cast<uint32_t>(a.dk[clip_index(dkb[p] >> 5, a.dk_words)])
               >> (dkb[p] & 31)) & 1u;
    est += ok ? 1u : 0u;
  }
  return static_cast<int>(est);
}

// The flat path's sharded estimate: counters global + delta, doorkeeper
// bits global | delta.
__device__ __forceinline__ int estimate_sharded(const StepArgs& a,
                                                const Sketch& s,
                                                const int (&idx)[kMaxRows],
                                                const int (&dkb)[kMaxDkp]) {
  uint32_t est = 0xffffffffu;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < a.rows) {
      const int i = r * a.words_per_row + (idx[r] >> s.shift);
      const int n = 2 * a.counter_words;
      const int sh = (idx[r] & s.cpw_mask) * a.counter_bits;
      const uint32_t v =
          ((static_cast<uint32_t>(a.counters[clip_index(i, n)]) >> sh)
           & s.capmax)
          + ((static_cast<uint32_t>(
                  a.counters[clip_index(a.counter_words + i, n)]) >> sh)
             & s.capmax);
      est = v < est ? v : est;
    }
  }
  if (a.dk_bits) {
    bool ok = true;
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p) {
      if (p < a.dkp) {
        const int b = dkb[p] >> 5, n = 2 * a.dk_words;
        ok &= ((static_cast<uint32_t>(a.dk[clip_index(b, n)]
                                      | a.dk[clip_index(a.dk_words + b, n)]))
               >> (dkb[p] & 31)) & 1u;
      }
    }
    est += ok ? 1u : 0u;
  }
  return static_cast<int>(est);
}

// One access against the exact flat tables; returns the hit flag.
template <bool kShard, bool kAdapt>
__device__ int access_flat(const StepArgs& a, const Sketch& s, const int* P,
                           int i, int t, int& pcount, int lane, Adapt& ad) {
  const int wst = wstamp<kAdapt>(t), mst = mstamp<kAdapt>(t);
  const int klo = __ldg(a.lo + i), khi = __ldg(a.hi + i);
  const int* kidx = a.kidx + i * a.rows;
  const int* kdkb = a.kdkb + i * a.dkp;
  bool f;
  const int jw = first_true(a.window_slots, [&](int j) {
    return a.wlo[j] == klo && a.whi[j] == khi; }, f);
  const int jm = first_true(a.main_slots, [&](int j) {
    return a.mlo[j] == klo && a.mhi[j] == khi; }, f);
  // the hit test reads slot argmax (slot 0 when nothing matched)
  const bool hit_w = a.wlo[jw] == klo && a.whi[jw] == khi && a.wmeta[jw] >= 0;
  const int mjm = a.mmeta[jm];
  const bool hit_m = a.mlo[jm] == klo && a.mhi[jm] == khi && mjm >= 0;
  const bool hit = hit_w || hit_m;
  __syncwarp();
  if (lane == 0) {
    if (hit_w) a.wmeta[jw] = wst;             // window hit: refresh
    if (hit_m) a.mmeta[jm] = kProt | mst;     // main hit: -> protected MRU
  }
  __syncwarp();
  pcount += (hit_m && mjm < kProt) ? 1 : 0;
  int v;
  // adaptive: the budget follows main's runtime capacity, and the drain
  // waits for a main hit (a rebalance may leave the count above it)
  const int prot_cap = kAdapt ? ad.prot_rt : P[P_PROT_CAP];
  if ((!kAdapt || hit_m) && pcount > prot_cap) {  // demote the protected LRU
    const int kd = argmin_over(a.main_slots, [&](int j) {
      const int mm = a.mmeta[j]; return mm >= kProt ? mm : kI32Max; }, v);
    __syncwarp();
    if (lane == 0) a.mmeta[kd] = mst;
    __syncwarp();
    pcount -= 1;
  }
  if (hit) return 1;

  // miss: insert into the window (argmin after the refresh); its LRU entry,
  // read before the insert, is the admission candidate.  Adaptive: at quota
  // the empty slots read as padding
  int wsmeta;
  const bool at_wcap = kAdapt && ad.wcount >= ad.wquota;
  const int ws = argmin_over(a.window_slots, [&](int j) {
    const int wm = a.wmeta[j];
    return at_wcap && wm == -1 ? kI32Max : wm; }, wsmeta);
  if constexpr (kAdapt) {
    wsmeta = a.wmeta[ws];
    ad.wcount += wsmeta == -1 ? 1 : 0;
  }
  const int cand_lo = a.wlo[ws], cand_hi = a.whi[ws];
  int cidx[kMaxRows], cdkb[kMaxDkp];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
    if (r < a.rows) cidx[r] = a.widx[ws * a.rows + r];
#pragma unroll
  for (int p = 0; p < kMaxDkp; ++p)
    if (p < a.dkp) cdkb[p] = a.wdkb[ws * a.dkp + p];
  __syncwarp();
  if (lane == 0) {
    a.wlo[ws] = klo;
    a.whi[ws] = khi;
    a.wmeta[ws] = wst;
    for (int r = 0; r < a.rows; ++r) a.widx[ws * a.rows + r] = __ldg(kidx + r);
    for (int p = 0; p < a.dkp; ++p) a.wdkb[ws * a.dkp + p] = __ldg(kdkb + p);
  }
  __syncwarp();
  if (wsmeta < 0) return 0;                   // window had room: no push

  // free slot < probation LRU < protected LRU, after promote/demote
  int vmeta;
  const bool at_mcap = kAdapt && ad.mcount >= ad.mcap_rt;
  const int tslot = argmin_over(a.main_slots, [&](int j) {
    const int mm = a.mmeta[j];
    return at_mcap && mm == -1 ? kI32Max : mm; }, vmeta);
  if constexpr (kAdapt) vmeta = a.mmeta[tslot];
  bool do_ins = vmeta < 0;
  if (!do_ins) {
    int vidx[kMaxRows], vdkb[kMaxDkp];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < a.rows) vidx[r] = a.midx[tslot * a.rows + r];
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p)
      if (p < a.dkp) vdkb[p] = a.mdkb[tslot * a.dkp + p];
    if constexpr (kShard)
      do_ins = estimate_sharded(a, s, cidx, cdkb)
               > estimate_sharded(a, s, vidx, vdkb);
    else
      do_ins = estimate(a, s, cidx, cdkb) > estimate(a, s, vidx, vdkb);
  }
  if (do_ins) {
    __syncwarp();
    if (lane == 0) {
      a.mlo[tslot] = cand_lo;
      a.mhi[tslot] = cand_hi;
      a.mmeta[tslot] = mst;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < a.rows) a.midx[tslot * a.rows + r] = cidx[r];
#pragma unroll
      for (int p = 0; p < kMaxDkp; ++p)
        if (p < a.dkp) a.mdkb[tslot * a.dkp + p] = cdkb[p];
    }
    __syncwarp();
    if (vmeta >= kProt) pcount -= 1;
    if (kAdapt && vmeta < 0) ad.mcount += 1;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// The exact path: one thread, the records in memory, any ways and probes
// ---------------------------------------------------------------------------
// The wide instances (more than kMaxDkp doorkeeper probes or kMaxWays ways,
// past what the register-held records of the other instances take) run
// every access here, and the launch takes them for any geometry when the
// tables may hold addresses out of range (StepArgs.exact: a fault's stored
// main sets or ARC ghost positions, core/faults.py; the kernel writes
// none), where the reference's block slices clamp and its block writes
// overwrite one another; the other instances are unchanged.  One thread runs
// it (lane 0 of warp 0), reading the records from memory, and follows the
// reference's per-access program: the decisions read the pre-access blocks
// (a candidate set block at the clamped start of its stored set, fixed up by
// the hit updates where the stored set equals one of the key's), and the
// blocks are written in the order km1, km2, c1, c2, window, a later block's
// write winning where blocks overlap.  Instead of copying blocks, each main
// row is written once, from the last block whose write covers it, from its
// pre-access content, the hit updates and the insert; only the words that
// change are stored.  kSk: 0 one sketch, 1 the [global || delta] halves,
// 2 the stale mesh step (global estimates; the add writes the delta blocks).

// The row where the block of set c starts, as the reference's dynamic
// slices take it: the int32 product c * A (it wraps), clamped into
// [0, n - A].
__device__ __forceinline__ int block_start(int c, int A, int n) {
  return min(max(wrap_mul(c, A), 0), n - A);
}

// TinyLFU estimate of an entry from its stored probes in memory (rows
// counter probes at idx, dkp doorkeeper probes at dkb); word indices clamp.
// kH: global + delta counters, global | delta bits.
template <bool kH>
__device__ int estimate_mem(const StepArgs& a, const Sketch& s, const int* idx,
                            const int* dkb) {
  uint32_t est = 0xffffffffu;
  for (int r = 0; r < a.rows; ++r) {
    const int i = r * a.words_per_row + (idx[r] >> s.shift);
    const int sh = (idx[r] & s.cpw_mask) * a.counter_bits;
    uint32_t v;
    if constexpr (kH) {
      const int n = 2 * a.counter_words;
      v = ((static_cast<uint32_t>(a.counters[clip_index(i, n)]) >> sh)
           & s.capmax)
          + ((static_cast<uint32_t>(
                  a.counters[clip_index(a.counter_words + i, n)]) >> sh)
             & s.capmax);
    } else {
      v = (static_cast<uint32_t>(a.counters[clip_index(i, a.counter_words)])
           >> sh) & s.capmax;
    }
    est = v < est ? v : est;
  }
  if (a.dk_bits) {
    bool ok = true;
    for (int p = 0; p < a.dkp && ok; ++p) {
      const int b = dkb[p] >> 5;
      uint32_t w;
      if constexpr (kH) {
        const int n = 2 * a.dk_words;
        w = static_cast<uint32_t>(a.dk[clip_index(b, n)]
                                  | a.dk[clip_index(a.dk_words + b, n)]);
      } else {
        w = static_cast<uint32_t>(a.dk[clip_index(b, a.dk_words)]);
      }
      ok = (w >> (dkb[p] & 31)) & 1u;
    }
    est += ok ? 1u : 0u;
  }
  return static_cast<int>(est);
}

// Access i's sketch add, any probe count, by one thread: the doorkeeper gate
// reads every probe's word before any bit is set, then the conservative
// increment.  kSk = 2: only the rank that owns the key's shard adds, into
// its delta blocks.
template <int kSk>
__device__ void add_generic(const StepArgs& a, const Sketch& s, int cap,
                            int i) {
  const int* kidx = a.kidx + i * a.rows;
  const int* kdkb = a.kdkb + i * a.dkp;
  int ks = 0, lks = 0;
  if constexpr (kSk == 2) {
    ks = kidx[0] / a.width_shard;
    lks = ks - a.mesh_base;
    if (lks < 0 || lks >= a.local_shards) return;
  }
  // where probe b's doorkeeper bit goes, and its word as the gate reads it
  auto dk_slot = [&](int b) -> int* {
    if constexpr (kSk == 0) return a.dk + (b >> 5);
    else if constexpr (kSk == 1) return a.dk + a.dk_words + (b >> 5);
    else return a.ddk + lks * a.dkw_shard + ((b - ks * a.dk_bits_shard) >> 5);
  };
  auto dk_read = [&](int b) -> uint32_t {
    const uint32_t own = static_cast<uint32_t>(*dk_slot(b));
    return kSk == 0 ? own : own | static_cast<uint32_t>(a.dk[b >> 5]);
  };
  bool gate = true;
  if (a.dk_bits) {
    for (int p = 0; p < a.dkp; ++p) {
      const int b = kdkb[p];
      bool eff = (dk_read(b) >> (b & 31)) & 1u;
      for (int q = 0; q < p && !eff; ++q) eff = kdkb[q] == b;
      gate = gate && eff;
    }
    for (int p = 0; p < a.dkp; ++p)
      *dk_slot(kdkb[p]) |= static_cast<int>(1u << (kdkb[p] & 31));
  }
  // row r's counter word that the bump goes into, and its counter value
  auto c_slot = [&](int r) -> int* {
    const int pr = kidx[r];
    if constexpr (kSk == 0)
      return a.counters + r * a.words_per_row + (pr >> s.shift);
    else if constexpr (kSk == 1)
      return a.counters + a.counter_words + r * a.words_per_row
             + (pr >> s.shift);
    else
      return a.dcounters + (lks * a.rows + r) * a.wps_shard
             + ((pr - ks * a.width_shard) >> s.shift);
  };
  auto c_val = [&](int r) -> uint32_t {
    const int sh = (kidx[r] & s.cpw_mask) * a.counter_bits;
    uint32_t v = (static_cast<uint32_t>(*c_slot(r)) >> sh) & s.capmax;
    if constexpr (kSk != 0)
      v += (static_cast<uint32_t>(
                a.counters[r * a.words_per_row + (kidx[r] >> s.shift)]) >> sh)
           & s.capmax;
    return v;
  };
  uint32_t m = 0xffffffffu;
  for (int r = 0; r < a.rows; ++r) m = min(m, c_val(r));
  if (!gate || static_cast<int>(m) >= cap) return;
  for (int r = 0; r < a.rows; ++r) {        // rows are distinct words
    if (c_val(r) != m) continue;
    int* w = c_slot(r);
    *w = static_cast<int>(static_cast<uint32_t>(*w)
                          + (1u << ((kidx[r] & s.cpw_mask) * a.counter_bits)));
  }
}

// Write an entry into a main record: lo, hi, meta, then its probes.
__device__ __forceinline__ void put_main(const StepArgs& a, int* r, int lo,
                                         int hi, int meta, const int* idx,
                                         const int* dkb) {
  r[MT_LO] = lo;
  r[MT_HI] = hi;
  r[MT_META] = meta;
  for (int q = 0; q < a.rows; ++q) r[3 + q] = idx[q];
  for (int q = 0; q < a.dkp; ++q) r[3 + a.rows + q] = dkb[q];
}

// W-TinyLFU (kPol = kWtinylfu, static or adaptive) or S3-FIFO on the set
// tables, one access, by one thread; returns the hit flag.
template <int kSk, bool kAdapt, int kPol>
__device__ __noinline__ int access_exact(const StepArgs& a, const Sketch& s,
                                         const int* P, int i, int t,
                                         const Adapt& ad) {
  constexpr bool kW = kPol == kWtinylfu;
  const int A = a.assoc, wc = a.wcols, mc = a.mcols, rows = a.rows;
  const int klo = a.lo[i], khi = a.hi[i], kw = a.kwset[i];
  const int km1 = a.kmset[2 * i], km2 = a.kmset[2 * i + 1];
  const int* kidx = a.kidx + i * rows;
  const int* kdkb = a.kdkb + i * a.dkp;
  const bool same_km = km1 == km2;
  const int wst = kW ? wstamp<kAdapt>(t) : t;
  const int mst = kW ? mstamp<kAdapt>(t) : t;
  int* W = a.wtab + kw * A * wc;
  int* mt = a.mtab;
  const int wu = kAdapt ? a.wuw[kw] : A;
  // usable ways of main set c (any int c, as the reference computes them)
  auto mu = [&](int c) { return kAdapt ? ad.mbase + (c < ad.mrem ? 1 : 0)
                                       : A; };
  // a way at or past its set's usable count reads as padding
  auto rd = [&](int m, int j, int u) { return kAdapt && j >= u ? kI32Max
                                                                : m; };
  auto meta = [&](int row) { return mt[row * mc + MT_META]; };
  auto match = [&](int row, int j, int u) {
    const int* r = mt + row * mc;
    return r[MT_LO] == klo && r[MT_HI] == khi && rd(r[MT_META], j, u) >= 0;
  };

  bool hit_w = false;
  int jw = 0;
  for (int j = 0; j < A && !hit_w; ++j) {
    const int* r = W + j * wc;
    if (r[WT_LO] == klo && r[WT_HI] == khi && rd(r[WT_META], j, wu) >= 0) {
      hit_w = true;
      jw = j;
    }
  }
  const int s1 = km1 * A, s2 = km2 * A, u1 = mu(km1), u2 = mu(km2);
  bool hit1 = false, hit2 = false;
  int j1 = 0, j2 = 0;
  for (int j = 0; j < A; ++j) {
    if (!hit1 && match(s1 + j, j, u1)) { hit1 = true; j1 = j; }
    if (!hit2 && match(s2 + j, j, u2)) { hit2 = true; j2 = j; }
  }
  hit2 = hit2 && !same_km;
  const bool hit = hit_w || hit1 || hit2;

  // the window's LRU record (W-TinyLFU: after the hit's refresh) is the
  // candidate; a zero-way window set is bypassed and the key is it
  int ws = 0, wsm = kI32Max;
  for (int j = 0; j < A; ++j) {
    int m = rd(W[j * wc + WT_META], j, wu);
    if (kW && hit_w && j == jw) m = wst;
    if (m < wsm) { wsm = m; ws = j; }
  }
  const bool w_ok = wsm != kI32Max;
  const bool push = !hit && (wsm >= 0 || !w_ok);
  const int* cw = W + ws * wc;
  const int clo = w_ok ? cw[WT_LO] : klo, chi = w_ok ? cw[WT_HI] : khi;
  const int c1 = w_ok ? cw[WT_MSET] : km1, c2 = w_ok ? cw[WT_MSET2] : km2;
  const int* cidx = w_ok ? cw + 5 : kidx;
  const int* cdkb = w_ok ? cw + 5 + rows : kdkb;

  // W-TinyLFU's hit update of a key set: the way hit moves to protected,
  // then the set's protected LRU is demoted if the set is over its budget;
  // returns the demoted way, or -1
  auto demoted = [&](int st, int u, bool h, int jh) {
    if (!kW || !h) return -1;
    int usable = 0, nprot = 0, kd = 0, kv = kI32Max;
    for (int j = 0; j < A; ++j) {
      const int m = j == jh ? (kProt | mst) : rd(meta(st + j), j, u);
      usable += m != kI32Max ? 1 : 0;
      nprot += m >= kProt && m != kI32Max ? 1 : 0;
      const int key = m >= kProt ? m : kI32Max;
      if (key < kv) { kv = key; kd = j; }
    }
    const int mcap = P[P_MAIN_CAP] > 1 ? P[P_MAIN_CAP] : 1;
    long long cap = static_cast<long long>(usable) * P[P_PROT_CAP] / mcap;
    return nprot > (cap < 1 ? 1 : cap) ? kd : -1;
  };
  const int kd1 = demoted(s1, u1, hit1, j1);
  const int kd2 = demoted(s2, u2, hit2, j2);
  // way j of the key's first / second set after the hit updates (masked);
  // S3-FIFO marks every matching way
  auto post1 = [&](int j) {
    int m = rd(meta(s1 + j), j, u1);
    if (kW) {
      if (hit1 && j == j1) m = kProt | mst;
      if (j == kd1) m = mst;
    } else if (match(s1 + j, j, u1)) {
      m |= kProt;
    }
    return m;
  };
  auto post2 = [&](int j) {
    if (same_km) return post1(j);
    int m = rd(meta(s2 + j), j, u2);
    if (kW) {
      if (hit2 && j == j2) m = kProt | mst;
      if (j == kd2) m = mst;
    } else if (match(s2 + j, j, u2)) {
      m |= kProt;
    }
    return m;
  };
  // way j of candidate set block h (the reference's fixup compares the
  // stored set itself, unclamped, with the key's sets)
  const int cs1 = block_start(c1, A, a.main_slots);
  const int cs2 = block_start(c2, A, a.main_slots);
  const int cu1 = mu(c1), cu2 = mu(c2);
  auto cb = [&](int h, int j) {
    const int c = h ? c2 : c1;
    if (c == km2) return post2(j);
    if (c == km1) return post1(j);
    return rd(meta((h ? cs2 : cs1) + j), j, h ? cu2 : cu1);
  };
  int vh = 0, vj = 0, vm = cb(0, 0);
  for (int h = 0; h < 2; ++h)
    for (int j = 0; j < A; ++j) {
      const int m = cb(h, j);
      if (m < vm) { vm = m; vh = h; vj = j; }
    }
  bool do_ins = false;
  if (push && vm != kI32Max) {
    constexpr bool kH = kSk == 1;
    if constexpr (kW) {
      do_ins = vm < 0;
      if (!do_ins) {
        const int* v = mt + ((vh ? cs2 : cs1) + vj) * mc;
        do_ins = estimate_mem<kH>(a, s, cidx, cdkb)
                 > estimate_mem<kH>(a, s, v + 3, v + 3 + rows);
      }
    } else {
      do_ins = estimate_mem<kH>(a, s, cidx, cdkb) >= 2;
    }
  }

  // main rows, each from the last block written over it
  const int st[4] = {s1, s2, cs1, cs2};
  const bool same_c = c1 == c2;
  for (int x = 3; x >= 0; --x) {
    for (int j = 0; j < A; ++j) {
      const int row = st[x] + j;
      bool later = false;
      for (int y = x + 1; y < 4; ++y)
        later = later || (row >= st[y] && row < st[y] + A);
      if (later) continue;
      int m, u;
      bool ins = false;
      if (x == 0) {
        m = post1(j);
        u = u1;
      } else if (x == 1) {
        m = post2(j);
        u = u2;
      } else {
        const int h = x == 3 && !same_c ? 1 : 0;
        m = cb(h, j);
        u = h ? cu2 : cu1;
        ins = do_ins && vh == h && vj == j;
      }
      int* r = mt + row * mc;
      if (ins) {
        put_main(a, r, clo, chi, mst, cidx, cdkb);
      } else {
        if (kAdapt && j >= u) m = -1;     // masked ways are written EMPTY
        if (r[MT_META] != m) r[MT_META] = m;
      }
    }
  }
  // the window block (its own table): refresh, the key's row, masked EMPTY
  for (int j = 0; j < A; ++j) {
    int* r = W + j * wc;
    if (!hit && w_ok && j == ws) {
      r[WT_LO] = klo;
      r[WT_HI] = khi;
      r[WT_META] = wst;
      r[WT_MSET] = km1;
      r[WT_MSET2] = km2;
      for (int q = 0; q < rows; ++q) r[5 + q] = kidx[q];
      for (int q = 0; q < a.dkp; ++q) r[5 + rows + q] = kdkb[q];
    } else {
      int m = r[WT_META];
      if (kW && hit_w && j == jw) m = wst;
      if (kAdapt && j >= wu) m = -1;
      if (r[WT_META] != m) r[WT_META] = m;
    }
  }
  return hit ? 1 : 0;
}

// ARC or LFU (the wide instances of the panel), one access, by one thread,
// in the order of the reference's program; returns the hit flag.  ARC's
// ghost words of a victim's stored probes clamp into the leaf, and where
// two clamp together the later probe's write wins.
template <int kPol>
__device__ __noinline__ int access_exact_panel(const StepArgs& a,
                                               const Sketch& s, const int* P,
                                               int i, int t, Arc& arc) {
  const int A = a.assoc, mc = a.mcols, rows = a.rows, dkw = a.dk_words;
  const int klo = a.lo[i], khi = a.hi[i];
  const int km1 = a.kmset[2 * i], km2 = a.kmset[2 * i + 1];
  const int* kidx = a.kidx + i * rows;
  const int* kdkb = a.kdkb + i * a.dkp;
  const bool same_km = km1 == km2;
  int* mt = a.mtab;
  const int s1 = km1 * A, s2 = km2 * A;
  auto meta = [&](int row) { return mt[row * mc + MT_META]; };
  auto match = [&](int row) {
    const int* r = mt + row * mc;
    return r[MT_LO] == klo && r[MT_HI] == khi && r[MT_META] >= 0;
  };
  bool hit = false, hit_t1 = false;
  for (int j = 0; j < A; ++j) {
    const bool m1 = match(s1 + j), m2 = !same_km && match(s2 + j);
    hit = hit || m1 || m2;
    hit_t1 = hit_t1 || (m1 && meta(s1 + j) < kProt)
             || (m2 && meta(s2 + j) < kProt);
  }
  const int hmeta = kPol == kArc ? (kProt | t) : t;   // a hit's new meta
  // way j of block h after the hit updates (block 1 is the first when the
  // key's sets alias)
  auto post = [&](int h, int j) {
    const int row = (h && !same_km ? s2 : s1) + j;
    return match(row) ? hmeta : meta(row);
  };
  const int* vrow = nullptr;
  int vh = 0, vj = 0, mins = kI32Max;
  bool do_ins = false, t2 = false;
  if constexpr (kPol == kArc) {
    bool gb1 = true, gb2 = true;
    for (int p = 0; p < a.dkp; ++p) {
      const int b = kdkb[p];
      gb1 = gb1 && ((static_cast<uint32_t>(a.ghost[b >> 5]) >> (b & 31)) & 1u);
      gb2 = gb2 && ((static_cast<uint32_t>(a.ghost[dkw + (b >> 5)])
                     >> (b & 31)) & 1u);
    }
    const bool in_b1 = !hit && gb1, in_b2 = !hit && gb2 && !gb1;
    const int p = in_b1 ? min(P[P_MAIN_CAP], arc.p + 1)
                        : (in_b2 ? max(0, arc.p - 1) : arc.p);
    const int flip = arc.t1 > p || (in_b2 && arc.t1 == p) ? 0 : kProt;
    auto okey = [&](int m) { return m == kI32Max ? kI32Max
                                                 : (m < 0 ? -1 : m ^ flip); };
    for (int h = 0; h < 2; ++h)
      for (int j = 0; j < A; ++j) {
        const int k = okey(post(h, j));
        if ((h == 0 && j == 0) || k < mins) { mins = k; vh = h; vj = j; }
      }
    do_ins = !hit && mins != kI32Max;
    const int vmeta = post(vh, vj);
    vrow = mt + ((vh && !same_km ? s2 : s1) + vj) * mc;
    const bool evict = do_ins && vmeta >= 0;
    const bool was_t1 = evict && vmeta < kProt;
    if (evict) {
      const int goff = was_t1 ? 0 : dkw;
      const bool clr = (was_t1 ? arc.gb1 : arc.gb2) >= P[P_MAIN_CAP];
      const int* vd = vrow + 3 + rows;
      auto cpos = [&](int q) { return min(max(goff + (vd[q] >> 5), 0),
                                          2 * dkw - 1); };
      if (clr)
        for (int w = 0; w < dkw; ++w) a.ghost[goff + w] = 0;
      for (int q = a.dkp - 1; q >= 0; --q) {   // the last writer of a word
        bool later = false;
        for (int o = q + 1; o < a.dkp && !later; ++o) later = cpos(o) == cpos(q);
        if (later) continue;
        const int vpos = goff + (vd[q] >> 5);
        uint32_t merged = clr ? 0u : static_cast<uint32_t>(a.ghost[cpos(q)]);
        for (int o = 0; o < a.dkp; ++o)
          if (goff + (vd[o] >> 5) == vpos) merged |= 1u << (vd[o] & 31);
        a.ghost[cpos(q)] = static_cast<int>(merged);
      }
      if (was_t1) arc.gb1 = (clr ? 0 : arc.gb1) + 1;
      else arc.gb2 = (clr ? 0 : arc.gb2) + 1;
    }
    t2 = gb1 || gb2;
    arc.t1 += (do_ins && !t2 ? 1 : 0) - (was_t1 ? 1 : 0) - (hit_t1 ? 1 : 0);
    arc.p = p;
  } else {
    // LFU: the smallest estimate (empty as -1, padding and an aliased
    // second set never), then the oldest stamp among those
    auto okey1 = [&](int h, int j) {
      const int m = post(h, j);
      if (m == kI32Max || (same_km && h == 1)) return kI32Max;
      if (m < 0) return -1;
      const int* r = mt + ((h ? s2 : s1) + j) * mc;
      return estimate_mem<false>(a, s, r + 3, r + 3 + rows);
    };
    int emin = kI32Max;
    for (int h = 0; h < 2; ++h)
      for (int j = 0; j < A; ++j) emin = min(emin, okey1(h, j));
    int k1 = kI32Max;
    for (int h = 0; h < 2; ++h)
      for (int j = 0; j < A; ++j) {
        const int k0 = okey1(h, j);
        const int k = k0 == emin ? post(h, j) : kI32Max;
        if ((h == 0 && j == 0) || k < mins) { mins = k; vh = h; vj = j;
                                              k1 = k0; }
      }
    do_ins = !hit && k1 != kI32Max;
  }
  // the key's blocks: km1 then km2 (aliased: one block, written twice)
  const int head = kPol == kArc && t2 ? (kProt | t) : t;
  for (int h = 1; h >= 0; --h) {
    if (h == 0 && same_km) break;
    for (int j = 0; j < A; ++j) {
      int* r = mt + ((h ? s2 : s1) + j) * mc;
      if (do_ins && j == vj && (vh == h || same_km)) {
        put_main(a, r, klo, khi, head, kidx, kdkb);
      } else {
        const int m = post(h, j);
        if (r[MT_META] != m) r[MT_META] = m;
      }
    }
  }
  return hit ? 1 : 0;
}

// One access against the exact flat tables with any probe count (the wide
// flat instances): access_flat's program, the probes read from the tables;
// the window row is written after the main insert has copied the
// candidate's probes out of it.
template <bool kH, bool kAdapt>
__device__ int access_flat_wide(const StepArgs& a, const Sketch& s,
                                const int* P, int i, int t, int& pcount,
                                int lane, Adapt& ad) {
  const int wst = wstamp<kAdapt>(t), mst = mstamp<kAdapt>(t);
  const int klo = __ldg(a.lo + i), khi = __ldg(a.hi + i);
  const int* kidx = a.kidx + i * a.rows;
  const int* kdkb = a.kdkb + i * a.dkp;
  bool f;
  const int jw = first_true(a.window_slots, [&](int j) {
    return a.wlo[j] == klo && a.whi[j] == khi; }, f);
  const int jm = first_true(a.main_slots, [&](int j) {
    return a.mlo[j] == klo && a.mhi[j] == khi; }, f);
  const bool hit_w = a.wlo[jw] == klo && a.whi[jw] == khi && a.wmeta[jw] >= 0;
  const int mjm = a.mmeta[jm];
  const bool hit_m = a.mlo[jm] == klo && a.mhi[jm] == khi && mjm >= 0;
  const bool hit = hit_w || hit_m;
  __syncwarp();
  if (lane == 0) {
    if (hit_w) a.wmeta[jw] = wst;
    if (hit_m) a.mmeta[jm] = kProt | mst;
  }
  __syncwarp();
  pcount += (hit_m && mjm < kProt) ? 1 : 0;
  int v;
  const int prot_cap = kAdapt ? ad.prot_rt : P[P_PROT_CAP];
  if ((!kAdapt || hit_m) && pcount > prot_cap) {
    const int kd = argmin_over(a.main_slots, [&](int j) {
      const int mm = a.mmeta[j]; return mm >= kProt ? mm : kI32Max; }, v);
    __syncwarp();
    if (lane == 0) a.mmeta[kd] = mst;
    __syncwarp();
    pcount -= 1;
  }
  if (hit) return 1;

  int wsmeta;
  const bool at_wcap = kAdapt && ad.wcount >= ad.wquota;
  const int ws = argmin_over(a.window_slots, [&](int j) {
    const int wm = a.wmeta[j];
    return at_wcap && wm == -1 ? kI32Max : wm; }, wsmeta);
  if constexpr (kAdapt) {
    wsmeta = a.wmeta[ws];
    ad.wcount += wsmeta == -1 ? 1 : 0;
  }
  const int* cidx = a.widx + ws * a.rows;
  const int* cdkb = a.wdkb + ws * a.dkp;
  bool do_ins = false;
  int tslot = 0, vmeta = 0;
  if (wsmeta >= 0) {                          // the window pushes a record
    const bool at_mcap = kAdapt && ad.mcount >= ad.mcap_rt;
    tslot = argmin_over(a.main_slots, [&](int j) {
      const int mm = a.mmeta[j];
      return at_mcap && mm == -1 ? kI32Max : mm; }, vmeta);
    if constexpr (kAdapt) vmeta = a.mmeta[tslot];
    do_ins = vmeta < 0
             || estimate_mem<kH>(a, s, cidx, cdkb)
                > estimate_mem<kH>(a, s, a.midx + tslot * a.rows,
                                   a.mdkb + tslot * a.dkp);
  }
  __syncwarp();
  if (lane == 0) {
    if (do_ins) {
      a.mlo[tslot] = a.wlo[ws];
      a.mhi[tslot] = a.whi[ws];
      a.mmeta[tslot] = mst;
      for (int r = 0; r < a.rows; ++r) a.midx[tslot * a.rows + r] = cidx[r];
      for (int p = 0; p < a.dkp; ++p) a.mdkb[tslot * a.dkp + p] = cdkb[p];
    }
    a.wlo[ws] = klo;
    a.whi[ws] = khi;
    a.wmeta[ws] = wst;
    for (int r = 0; r < a.rows; ++r) a.widx[ws * a.rows + r] = kidx[r];
    for (int p = 0; p < a.dkp; ++p) a.wdkb[ws * a.dkp + p] = kdkb[p];
  }
  __syncwarp();
  if (do_ins) {
    if (vmeta >= kProt) pcount -= 1;
    if (kAdapt && vmeta < 0) ad.mcount += 1;
  }
  return 0;
}

// v[r] for a runtime r < N, by selects (register arrays are indexed by
// unrolled constants only, so they stay in registers).
template <int N>
__device__ __forceinline__ int pick(const int (&v)[N], int r) {
  int x = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (r == k) x = v[k];
  return x;
}

// First index of the minimum over one set whose way j sits in lane j & 31,
// record j >> 5 (absent ways hold kI32Max); m receives the minimum.
template <int N>
__device__ __forceinline__ int first_min32(const int (&v)[N], int& m) {
  int loc = v[0];
#pragma unroll
  for (int r = 1; r < N; ++r) loc = min(loc, v[r]);
  m = __reduce_min_sync(kFull, loc);
  int j = 0;
  bool found = false;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const unsigned b = __ballot_sync(kFull, v[r] == m);
    if (!found && b) { found = true; j = 32 * r + __ffs(b) - 1; }
  }
  return j;
}

// First index of the minimum over set h of a pair whose way j sits in lane
// 16 h + (j & 15), record j >> 4; m receives the minimum.
template <int N>
__device__ __forceinline__ int first_min16(const int (&v)[N], int h, int lane,
                                           int& m) {
  int loc = v[0];
#pragma unroll
  for (int r = 1; r < N; ++r) loc = min(loc, v[r]);
  m = __reduce_min_sync(kFull, (lane >> 4) == h ? loc : kI32Max);
  int j = 0;
  bool found = false;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const unsigned b = (__ballot_sync(kFull, v[r] == m) >> (16 * h)) & 0xffffu;
    if (!found && b) { found = true; j = 16 * r + __ffs(b) - 1; }
  }
  return j;
}

// The probes of way (src lane, record rr) of records held a way per lane,
// handed to the probe lanes: lane r gets idx[r], lane 8 + p gets dkb[p].
template <int N>
__device__ __forceinline__ int probes_from(const StepArgs& a, const Lanes& ln,
                                           const int (&idx)[N][kMaxRows],
                                           const int (&dkb)[N][kMaxDkp],
                                           int src, int rr) {
  int pr = 0;
#pragma unroll
  for (int q = 0; q < kMaxRows; ++q) {
    if (q < a.rows) {
      int col[N];
#pragma unroll
      for (int r = 0; r < N; ++r) col[r] = idx[r][q];
      const int x = __shfl_sync(kFull, pick(col, rr), src);
      if (ln.lane == q) pr = x;
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxDkp; ++q) {
    if (q < a.dkp) {
      int col[N];
#pragma unroll
      for (int r = 0; r < N; ++r) col[r] = dkb[r][q];
      const int x = __shfl_sync(kFull, pick(col, rr), src);
      if (ln.lane == 8 + q) pr = x;
    }
  }
  return pr;
}

// Write an entry into a table row: the header fields (n_head of them) from
// lanes 16.., the probes from the probe lanes (after the header columns).
__device__ __forceinline__ void write_row(const StepArgs& a, const Lanes& ln,
                                          int* row, int n_head,
                                          const int (&head)[5], int pr) {
  const int l = ln.lane;
  int col = -1, v = pr;
  if (ln.row) col = n_head + l;
  else if (ln.dk) col = n_head + a.rows + l - 8;
  else if (l >= 16 && l < 16 + n_head) { col = l - 16; v = pick(head, col); }
  if (col >= 0) row[col] = v;
}

// The records of one access's sets, in registers.  RM = ceil(ways / 16)
// records per lane of a pair of main sets, RW = ceil(ways / 32) of the
// window set.
template <int RM>
struct SetRegs {
  static constexpr int RW = (RM + 1) / 2;
  int wlo[RW], whi[RW], wmeta[RW], wms1[RW], wms2[RW];    // window set
  int widx[RW][kMaxRows], wdkb[RW][kMaxDkp];
  int mlo[RM], mhi[RM], mmeta[RM];        // the key's two main sets
};

// Main set s's usable ways under the adaptive window (all ways, static).
template <bool kAdapt>
__device__ __forceinline__ int main_usable(const StepArgs& a, const Adapt& ad,
                                           int s) {
  return kAdapt ? ad.mbase + (s < ad.mrem ? 1 : 0) : a.assoc;
}

// Load the key's window set (every column; not with kWindow = false) and
// the lo/hi/meta columns of its two main sets.  Loads only: nothing waits
// for them here.  Adaptive: the ways past each set's usable count read as
// padding (kI32Max).
template <int RM, bool kAdapt, bool kWindow = true>
__device__ __forceinline__ void load_sets(const StepArgs& a, const Entry& k,
                                          SetRegs<RM>& g, int lane,
                                          const Adapt& ad) {
  const int A = a.assoc;
  int wu = A;
  if constexpr (kAdapt) wu = a.wuw[k.w];
#pragma unroll
  for (int r = 0; r < (kWindow ? SetRegs<RM>::RW : 0); ++r) {
    const int j = lane + 32 * r;
    g.wmeta[r] = kI32Max;
    if (j < A) {
      const int* p = a.wtab + (k.w * A + j) * a.wcols;
      g.wlo[r] = p[WT_LO];
      g.whi[r] = p[WT_HI];
      const int m = p[WT_META];
      g.wmeta[r] = !kAdapt || j < wu ? m : kI32Max;
      g.wms1[r] = p[WT_MSET];
      g.wms2[r] = p[WT_MSET2];
#pragma unroll
      for (int q = 0; q < kMaxRows; ++q)
        if (q < a.rows) g.widx[r][q] = p[5 + q];
#pragma unroll
      for (int q = 0; q < kMaxDkp; ++q)
        if (q < a.dkp) g.wdkb[r][q] = p[5 + a.rows + q];
    }
  }
  const int set = lane < 16 ? k.m1 : k.m2;
  const int mu = main_usable<kAdapt>(a, ad, set);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int j = (lane & 15) + 16 * r;
    g.mmeta[r] = kI32Max;
    if (j < A) {
      const int* p = a.mtab + (set * A + j) * a.mcols;
      g.mlo[r] = p[MT_LO];
      g.mhi[r] = p[MT_HI];
      const int m = p[MT_META];
      g.mmeta[r] = !kAdapt || j < mu ? m : kI32Max;
    }
  }
}

// SLRU promote-or-refresh of way j of main set h (in lanes 16 h ..), then
// the set's protected budget check (prot_cap[usable], the reference's
// max(1, usable * prot_cap // max(main_cap, 1)), usable counting the ways
// that do not read as padding); writes the changed meta words with main's
// stamp t.
template <int RM>
__device__ void hit_update(const StepArgs& a, const int* prot_cap,
                           SetRegs<RM>& g, int h, int j, int set, int t,
                           int lane) {
  const bool mine = (lane >> 4) == h;
  int usable = 0, nprot = 0;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int mm = mine && (lane & 15) + 16 * r == j ? (kProt | t)
                                                     : g.mmeta[r];
    g.mmeta[r] = mm;
    usable += __popc(__ballot_sync(kFull, mine && mm != kI32Max));
    nprot += __popc(__ballot_sync(kFull, mine && mm >= kProt
                                  && mm != kI32Max));
  }
  int* meta = a.mtab + set * a.assoc * a.mcols + MT_META;
  if (lane == 0) meta[j * a.mcols] = kProt | t;
  if (nprot > prot_cap[usable]) {     // demote the set's protected LRU
    int pv[RM], v;
#pragma unroll
    for (int r = 0; r < RM; ++r) pv[r] = g.mmeta[r] >= kProt ? g.mmeta[r]
                                                             : kI32Max;
    const int kd = first_min16(pv, h, lane, v);
    if (lane == 0) meta[kd * a.mcols] = t;
  }
}

// One access against the set-associative tables, from the registers
// load_sets filled (the pre-access records); returns the hit flag.
template <int RM, bool kShard, bool kAdapt>
__device__ int access_set(const StepArgs& a, const Sketch& s, const Lanes& ln,
                          const int* prot_cap, int t, const Entry& k,
                          SetRegs<RM>& g, const Adapt& ad) {
  constexpr int RW = SetRegs<RM>::RW;
  const int A = a.assoc, lane = ln.lane;
  const int wst = wstamp<kAdapt>(t), mst = mstamp<kAdapt>(t);
  const bool same_km = k.m1 == k.m2;
  bool hit_w = false, hit1 = false, hit2 = false;
  int jw = 0, j1 = 0, j2 = 0;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const unsigned b = __ballot_sync(
        kFull, lane + 32 * r < A && g.wlo[r] == k.lo && g.whi[r] == k.hi
                   && g.wmeta[r] >= 0);
    if (!hit_w && b) { hit_w = true; jw = 32 * r + __ffs(b) - 1; }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const unsigned b = __ballot_sync(
        kFull, (lane & 15) + 16 * r < A && g.mlo[r] == k.lo
                   && g.mhi[r] == k.hi && g.mmeta[r] >= 0);
    const unsigned b1 = b & 0xffffu, b2 = b >> 16;
    if (!hit1 && b1) { hit1 = true; j1 = 16 * r + __ffs(b1) - 1; }
    if (!hit2 && b2) { hit2 = true; j2 = 16 * r + __ffs(b2) - 1; }
  }
  hit2 = hit2 && !same_km;        // aliased choices: count set 1 only
  if (hit_w || hit1 || hit2) {
    if (hit_w && lane == 0)       // window hit: refresh
      a.wtab[(k.w * A + jw) * a.wcols + WT_META] = wst;
    if (hit1) hit_update(a, prot_cap, g, 0, j1, k.m1, mst, lane);
    if (hit2) hit_update(a, prot_cap, g, 1, j2, k.m2, mst, lane);
    return 1;
  }

  // miss: the window's LRU record is the admission candidate; a zero-way
  // window set (argmin on padding) is bypassed and the key itself is it
  int wsm;
  const int ws = first_min32(g.wmeta, wsm);
  const bool w_ok = wsm != kI32Max;
  const bool push = wsm >= 0 || !w_ok;
  Entry c = k;
  if (w_ok) {
    const int src = ws & 31, rr = ws >> 5;
    c.lo = __shfl_sync(kFull, pick(g.wlo, rr), src);
    c.hi = __shfl_sync(kFull, pick(g.whi, rr), src);
    c.m1 = __shfl_sync(kFull, pick(g.wms1, rr), src);
    c.m2 = __shfl_sync(kFull, pick(g.wms2, rr), src);
    c.pr = probes_from(a, ln, g.widx, g.wdkb, src, rr);
    // the key takes the candidate's window row
    const int head[5] = {k.lo, k.hi, wst, k.m1, k.m2};
    write_row(a, ln, a.wtab + (k.w * A + ws) * a.wcols, 5, head, k.pr);
  }
  if (!push) return 0;            // the window had room

  // the candidate's two main sets (meta and probe columns: on a miss no
  // main set changed, so the table holds the pre-access records) and its
  // sketch words, loaded together
  const int cset = lane < 16 ? c.m1 : c.m2;
  const int cu = main_usable<kAdapt>(a, ad, cset);
  int cmeta[RM], cidx[RM][kMaxRows], cdkb[RM][kMaxDkp];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int j = (lane & 15) + 16 * r;
    cmeta[r] = kI32Max;
    if (j < A) {
      const int* p = a.mtab + (cset * A + j) * a.mcols;
      const int m = p[MT_META];
      cmeta[r] = !kAdapt || j < cu ? m : kI32Max;
#pragma unroll
      for (int q = 0; q < kMaxRows; ++q)
        if (q < a.rows) cidx[r][q] = p[3 + q];
#pragma unroll
      for (int q = 0; q < kMaxDkp; ++q)
        if (q < a.dkp) cdkb[r][q] = p[3 + a.rows + q];
    }
  }
  const auto cw = load_stored<kShard>(a, s, ln, c.pr);

  // weakest of the 2A records; ties pick the first set, then the lower way
  int loc = cmeta[0];
#pragma unroll
  for (int r = 1; r < RM; ++r) loc = min(loc, cmeta[r]);
  const int vm = __reduce_min_sync(kFull, loc);
  unsigned eq[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) eq[r] = __ballot_sync(kFull, cmeta[r] == vm);
  int vh = 1, vj = 0;
  bool found = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const unsigned b = (eq[r] >> (16 * h)) & 0xffffu;
      if (!found && b) { found = true; vh = h; vj = 16 * r + __ffs(b) - 1; }
    }
  }
  if (vm == kI32Max) return 0;    // padding victims never accept an insert
  bool do_ins = vm < 0;
  if (!do_ins) {
    const int vpr = probes_from(a, ln, cidx, cdkb, 16 * vh + (vj & 15),
                                vj >> 4);
    const auto vw = load_stored<kShard>(a, s, ln, vpr);
    do_ins = estimate_of(a, s, ln, cw, c.pr) > estimate_of(a, s, ln, vw, vpr);
  }
  if (do_ins) {                   // the candidate takes the victim's way
    const int head[5] = {c.lo, c.hi, mst, 0, 0};
    write_row(a, ln, a.mtab + ((vh ? c.m2 : c.m1) * A + vj) * a.mcols, 3,
              head, c.pr);
  }
  return 0;
}

// First index of the minimum of key over a pair of sets whose way j sits in
// lane 16 h + (j & 15), record j >> 4: ties go to the first set, then the
// lower way.  Returns the minimum; vh and vj receive the set and the way.
// (access_set keeps its own inline copy of this scan, so the static and
// adaptive builds compile exactly as before the panel.)
template <int RM>
__device__ __forceinline__ int pair_argmin(const int (&key)[RM], int& vh,
                                           int& vj) {
  int loc = key[0];
#pragma unroll
  for (int r = 1; r < RM; ++r) loc = min(loc, key[r]);
  const int vm = __reduce_min_sync(kFull, loc);
  unsigned eq[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) eq[r] = __ballot_sync(kFull, key[r] == vm);
  vh = 1;
  vj = 0;
  bool found = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const unsigned b = (eq[r] >> (16 * h)) & 0xffffu;
      if (!found && b) { found = true; vh = h; vj = 16 * r + __ffs(b) - 1; }
    }
  }
  return vm;
}

// One access of a competitor policy (kPol: S3-FIFO, ARC or LFU) against the
// set-associative tables, from the registers load_sets filled (the main
// sets; S3-FIFO's window set); returns the hit flag.  A main hit writes the
// meta word of each matching way: S3-FIFO ORs in its CLOCK mark, ARC moves
// it to T2 (kProt | t), LFU refreshes the stamp; a window hit (S3-FIFO)
// writes nothing.
template <int RM, int kPol>
__device__ int access_panel(const StepArgs& a, const Sketch& s,
                            const Lanes& ln, const int* P, int t,
                            const Entry& k, SetRegs<RM>& g, Arc& arc) {
  constexpr int RW = SetRegs<RM>::RW;
  const int A = a.assoc, lane = ln.lane;
  const bool same_km = k.m1 == k.m2;
  const int mset = lane < 16 ? k.m1 : k.m2;
  uint32_t w1 = 0, w2 = 0;          // ARC: the key's words of B1 and B2
  if (kPol == kArc && ln.dk) {
    w1 = static_cast<uint32_t>(a.ghost[k.pr >> 5]);
    w2 = static_cast<uint32_t>(a.ghost[a.dk_words + (k.pr >> 5)]);
  }
  bool match[RM], mine = false, mine_t1 = false;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    match[r] = (lane & 15) + 16 * r < A && g.mlo[r] == k.lo
               && g.mhi[r] == k.hi && g.mmeta[r] >= 0
               && !(same_km && lane >= 16);   // aliased: count set 1 only
    mine |= match[r];
    mine_t1 |= match[r] && g.mmeta[r] < kProt;
  }
  bool hit = __any_sync(kFull, mine);
  if constexpr (kPol == kS3fifo) {
#pragma unroll
    for (int r = 0; r < RW; ++r)
      hit |= __any_sync(kFull, lane + 32 * r < A && g.wlo[r] == k.lo
                                   && g.whi[r] == k.hi && g.wmeta[r] >= 0);
  }
  if (hit) {
    int* meta = a.mtab + mset * A * a.mcols + MT_META;
#pragma unroll
    for (int r = 0; r < RM; ++r)
      if (match[r])
        meta[((lane & 15) + 16 * r) * a.mcols] =
            kPol == kS3fifo ? (g.mmeta[r] | kProt)
                            : (kPol == kArc ? (kProt | t) : t);
    if constexpr (kPol == kArc)
      arc.t1 -= __any_sync(kFull, mine_t1) ? 1 : 0;
    return 1;
  }

  if constexpr (kPol == kS3fifo) {
    // miss: the small FIFO's oldest record is the candidate (the key itself
    // when its window set has no way) and the key takes its row
    int wsm;
    const int ws = first_min32(g.wmeta, wsm);
    const bool w_ok = wsm != kI32Max;
    Entry c = k;
    if (w_ok) {
      const int src = ws & 31, rr = ws >> 5;
      c.lo = __shfl_sync(kFull, pick(g.wlo, rr), src);
      c.hi = __shfl_sync(kFull, pick(g.whi, rr), src);
      c.m1 = __shfl_sync(kFull, pick(g.wms1, rr), src);
      c.m2 = __shfl_sync(kFull, pick(g.wms2, rr), src);
      c.pr = probes_from(a, ln, g.widx, g.wdkb, src, rr);
      const int head[5] = {k.lo, k.hi, t, k.m1, k.m2};
      write_row(a, ln, a.wtab + (k.w * A + ws) * a.wcols, 5, head, k.pr);
    }
    if (wsm < 0) return 0;          // the window had room
    // the candidate's two main sets (unchanged on a miss) and its sketch
    // words, loaded together; it takes the first free or oldest unmarked
    // (else oldest marked) way if its estimate is at least 2
    const int cset = lane < 16 ? c.m1 : c.m2;
    int cmeta[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int j = (lane & 15) + 16 * r;
      cmeta[r] = j < A ? a.mtab[(cset * A + j) * a.mcols + MT_META] : kI32Max;
    }
    const uint32_t cw = load_stored<false>(a, s, ln, c.pr);
    int vh, vj;
    const int vm = pair_argmin(cmeta, vh, vj);
    if (estimate_of(a, s, ln, cw, c.pr) >= 2 && vm != kI32Max) {
      const int head[5] = {c.lo, c.hi, t, 0, 0};
      write_row(a, ln, a.mtab + ((vh ? c.m2 : c.m1) * A + vj) * a.mcols, 3,
                head, c.pr);
    }
    return 0;
  } else if constexpr (kPol == kArc) {
    // miss: a ghost hit moves p (B1 up, capped at main_cap; B2 down, at
    // 0); the victim is the T1 LRU while |T1| exceeds p (at |T1| == p on
    // a B2 hit), else the T2 LRU: flipping kProt in the order key swaps
    // which list the argmin prefers
    const bool gb1 = __ballot_sync(kFull, ln.dk && !((w1 >> (k.pr & 31)) & 1u))
                     == 0;
    const bool gb2 = __ballot_sync(kFull, ln.dk && !((w2 >> (k.pr & 31)) & 1u))
                     == 0;
    const bool in_b2 = gb2 && !gb1;
    const int p = gb1 ? min(P[P_MAIN_CAP], arc.p + 1)
                      : (in_b2 ? max(0, arc.p - 1) : arc.p);
    arc.p = p;
    const int flip = arc.t1 > p || (in_b2 && arc.t1 == p) ? 0 : kProt;
    int okey[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = g.mmeta[r];
      okey[r] = m == kI32Max ? kI32Max : (m < 0 ? -1 : m ^ flip);
    }
    int vh, vj;
    if (pair_argmin(okey, vh, vj) == kI32Max) return 0;   // padding only
    const int vmeta = __shfl_sync(kFull, pick(g.mmeta, vj >> 4),
                                  16 * vh + (vj & 15));
    int* vrow = a.mtab + ((vh ? k.m2 : k.m1) * A + vj) * a.mcols;
    const bool was_t1 = vmeta >= 0 && vmeta < kProt;
    if (vmeta >= 0) {
      // the victim's stored probes enter B1 (from T1) or B2; a half whose
      // count reached main_cap is cleared first (by this warp alone, a
      // loop over its dk_words words); probes sharing a word merge onto
      // the word as read before the clear, or onto zero
      const int goff = was_t1 ? 0 : a.dk_words;
      const bool clr = (was_t1 ? arc.gb1 : arc.gb2) >= P[P_MAIN_CAP];
      int vpos = -1;
      uint32_t vbit = 0, merged = 0;
      if (ln.dk) {
        const int vp = vrow[3 + a.rows + lane - 8];
        vpos = goff + (vp >> 5);
        vbit = 1u << (vp & 31);
        merged = clr ? 0u : static_cast<uint32_t>(a.ghost[vpos]);
      }
#pragma unroll
      for (int q = 0; q < kMaxDkp; ++q) {
        if (q < a.dkp) {
          const int op = __shfl_sync(kFull, vpos, 8 + q);
          const uint32_t ob = __shfl_sync(kFull, vbit, 8 + q);
          if (ln.dk && op == vpos) merged |= ob;
        }
      }
      if (clr) {
        __syncwarp();
        for (int w = lane; w < a.dk_words; w += 32) a.ghost[goff + w] = 0;
        __syncwarp();
      }
      if (ln.dk) a.ghost[vpos] = static_cast<int>(merged);
      if (was_t1) arc.gb1 = (clr ? 0 : arc.gb1) + 1;
      else arc.gb2 = (clr ? 0 : arc.gb2) + 1;
    }
    // a key either ghost remembers enters T2, a fresh key T1
    const bool t2 = gb1 || gb2;
    const int head[5] = {k.lo, k.hi, t2 ? (kProt | t) : t, 0, 0};
    write_row(a, ln, vrow, 3, head, k.pr);
    arc.t1 += (t2 ? 0 : 1) - (was_t1 ? 1 : 0);
    return 0;
  } else {
    // LFU miss: the key takes the way of the record with the smallest
    // estimate (after this access's add; empty as -1), the oldest stamp
    // among ties, the first set before the second (masked when aliased).
    // Each lane estimates its own records: their probe columns, then their
    // sketch words
    int cidx[RM][kMaxRows], cdkb[RM][kMaxDkp], okey[RM];
    bool occ[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = g.mmeta[r];
      const bool pad = m == kI32Max || (same_km && lane >= 16);
      occ[r] = !pad && m >= 0;
      okey[r] = pad ? kI32Max : -1;
      if (occ[r]) {
        const int* p = a.mtab + (mset * A + (lane & 15) + 16 * r) * a.mcols;
#pragma unroll
        for (int q = 0; q < kMaxRows; ++q)
          if (q < a.rows) cidx[r][q] = p[3 + q];
#pragma unroll
        for (int q = 0; q < kMaxDkp; ++q)
          if (q < a.dkp) cdkb[r][q] = p[3 + a.rows + q];
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
      if (occ[r]) okey[r] = estimate(a, s, cidx[r], cdkb[r]);
    int loc = okey[0];
#pragma unroll
    for (int r = 1; r < RM; ++r) loc = min(loc, okey[r]);
    const int emin = __reduce_min_sync(kFull, loc);
    if (emin == kI32Max) return 0;  // padding only
    int bv = kI32Max, bi = kI32Max;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int j = (lane >> 4) * A + (lane & 15) + 16 * r;
      if (okey[r] == emin && (g.mmeta[r] < bv
                              || (g.mmeta[r] == bv && j < bi))) {
        bv = g.mmeta[r];
        bi = j;
      }
    }
    warp_argmin(bv, bi);
    const int vh = bi >= A ? 1 : 0, vj = bi - vh * A;
    const int head[5] = {k.lo, k.hi, t, 0, 0};
    write_row(a, ln, a.mtab + ((vh ? k.m2 : k.m1) * A + vj) * a.mcols, 3,
              head, k.pr);
    return 0;
  }
}

// Point a at lane l of the lane-axis operands (every leaf is (lanes, ...)
// with the single-stream shape behind the lane axis; a sharded lane's
// sketch is two halves long).
template <bool kShard, bool kAdapt, int kPol>
__device__ __forceinline__ void to_lane(StepArgs& a, long long l) {
  const long long b = a.b;
  a.lo += l * b;
  a.hi += l * b;
  a.kidx += l * b * a.rows;
  a.kdkb += l * b * a.dkp;
  a.kwset += l * b;
  a.kmset += l * 2 * b;
  a.hits += l * b;
  a.params += l * a.params_stride;
  a.counters += l * a.counter_words;
  a.dk += l * a.dk_words;
  if constexpr (kShard) {
    a.counters += l * a.counter_words;
    a.dk += l * a.dk_words;
  }
  a.regs += l * kNRegs;
  if (a.assoc == 0) {
    const long long w = a.window_slots, m = a.main_slots;
    a.wlo += l * w; a.whi += l * w; a.wmeta += l * w;
    a.widx += l * w * a.rows; a.wdkb += l * w * a.dkp;
    a.mlo += l * m; a.mhi += l * m; a.mmeta += l * m;
    a.midx += l * m * a.rows; a.mdkb += l * m * a.dkp;
  } else {
    a.wtab += l * a.window_slots * static_cast<long long>(a.wcols);
    a.mtab += l * a.main_slots * static_cast<long long>(a.mcols);
    if constexpr (kAdapt) {
      const long long nws = a.window_slots / a.assoc;
      a.wsl += l * nws;
      a.wuw += l * nws;
    }
  }
  if constexpr (kPol == kArc) a.ghost += l * 2 * a.dk_words;
  if (a.nvalid) a.n_valid = a.nvalid[l];
}

// The chunk loop.  RM = 0: the flat tables; RM > 0: the set-associative
// path with RM records per lane of a pair of main sets; kWideSet /
// kWideFlat: the wide instances (the add by one thread, the set path's
// accesses by access_exact* and the flat path's by access_flat_wide).
// kLanes: CTA l runs lane l of the lane grid.  kShard: the sharded sketch.
// kAdapt: the adaptive window.  kPol: W-TinyLFU, or a competitor of the
// panel (set path only; ARC compiles out the sketch add and reset, and keeps
// its p, |T1| and ghost counts in registers for the chunk).  kMesh: the
// stale mesh step (mode 1e: the add writes this rank's delta blocks, the
// estimates read the global halves, no per-access reset).
template <int RM, bool kLanes, bool kShard, bool kAdapt, int kPol = kWtinylfu,
          bool kMesh = false>
__global__ void __launch_bounds__(256) sketch_step_kernel(StepArgs a) {
  constexpr bool kWide = RM < 0;
  constexpr int kSk = kMesh ? 2 : (kShard ? 1 : 0);
  if constexpr (kLanes) to_lane<kShard, kAdapt, kPol>(a, blockIdx.x);
  __shared__ int prot_cap[kMaxWays + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = a.n_valid + tid; j < a.b; j += blockDim.x) a.hits[j] = 0;

  int P[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) P[k] = a.params[k];
  // the set path's protected budget per count of usable ways
  const int main_cap = P[P_MAIN_CAP] > 1 ? P[P_MAIN_CAP] : 1;
  for (int u = tid; u <= a.assoc && u <= kMaxWays; u += blockDim.x) {
    const long long c = static_cast<long long>(u) * P[P_PROT_CAP] / main_cap;
    prot_cap[u] = c < 1 ? 1 : static_cast<int>(c);
  }
  __syncthreads();
  int size = a.regs[R_SIZE];
  int pcount = a.regs[R_PCOUNT];
  int t = a.regs[R_T];
  int nhits = a.regs[R_HITS];
  Adapt ad{};
  Arc arc{};
  if constexpr (kPol == kArc)
    arc = Arc{a.regs[R_WQUOTA], a.regs[R_WCOUNT], a.regs[R_MCOUNT],
              a.regs[R_EHITS]};
  int ehits = 0;
  if constexpr (kAdapt) {
    ad.wquota = a.regs[R_WQUOTA];
    ad.wcount = a.regs[R_WCOUNT];
    ad.mcount = a.regs[R_MCOUNT];
    ehits = a.regs[R_EHITS];
    ad.mcap_rt = P[P_WINDOW_CAP] + P[P_MAIN_CAP] - ad.wquota;
    const int pr = floordiv(wrap_mul(ad.mcap_rt, P[P_PROT_CAP]), main_cap);
    ad.prot_rt = pr < 1 ? 1 : pr;
    if (RM != 0 && RM != kWideFlat) {
      const int nms = a.main_slots / a.assoc;
      ad.mbase = floordiv(ad.mcap_rt, nms);
      ad.mrem = floormod(ad.mcap_rt, nms);
    }
  }
  Sketch s;
  s.shift = a.counter_bits == 4 ? 3 : 2;
  s.cpw_mask = 32 / a.counter_bits - 1;
  s.capmax = (1u << a.counter_bits) - 1u;
  const uint32_t halve_mask = a.counter_bits == 4 ? 0x77777777u : 0x7F7F7F7Fu;
  Lanes ln;
  ln.lane = lane;
  ln.row = lane < a.rows;
  ln.dk = lane >= 8 && lane < 8 + a.dkp;
  ln.dk_on = ln.dk && a.dk_bits != 0;

  Entry k, next;
  if (!kWide && warp == 0 && a.n_valid > 0) load_key(a, ln, 0, k);
  for (int i = 0; i < a.n_valid; ++i) {
    SetRegs<RM <= 0 ? 1 : RM> g;
    if (warp == 0) {
      if (!kWide && i + 1 < a.n_valid) load_key(a, ln, i + 1, next);
#ifndef SKETCH_STEP_SKIP_ACCESS
      if constexpr (RM > 0)         // ARC and LFU never read the window
        load_sets<RM, kAdapt, kPol == kWtinylfu || kPol == kS3fifo>(
            a, k, g, lane, ad);
      if constexpr (kAdapt && RM != 0 && RM != kWideFlat)   // window set
        if (lane == 0) atomicAdd(a.wsl + (kWide ? a.kwset[i] : k.w), 1);
#endif
#ifndef SKETCH_STEP_SKIP_ADD
      if constexpr (kPol != kArc) {
        if constexpr (kWide) {
          if (lane == 0) add_generic<kSk>(a, s, P[P_CAP], i);
        } else if constexpr (kMesh) {
          add_mesh(a, s, ln, P[P_CAP], k);
        } else {
          add_words(a, s, ln, P[P_CAP], k,
                    load_probe<kShard>(a, s, ln, k.pr));
        }
        __syncwarp();
      }
#endif
    }
    // size is data-independent, so every thread agrees on when to reset
    // (never, sharded or meshed: the epoch fold ages the sketch; ARC has
    // no sketch)
    if constexpr (kPol != kArc) {
      size += 1;
      if (kSk == 0 && P[P_SAMPLE] > 0 && size >= P[P_SAMPLE]) {
        __syncthreads();
        for (int w = tid; w < a.counter_words; w += blockDim.x)
          a.counters[w] = static_cast<int>(
              (static_cast<uint32_t>(a.counters[w]) >> 1) & halve_mask);
        for (int w = tid; w < a.dk_words; w += blockDim.x) a.dk[w] = 0;
        __syncthreads();
        size /= 2;
      }
    }
    if (warp == 0) {
#ifdef SKETCH_STEP_SKIP_ACCESS
      const int hit = 0;
#else
      int hit;
      if constexpr (RM == 0) {
        hit = access_flat<kShard, kAdapt>(a, s, P, i, t, pcount, lane, ad);
      } else if constexpr (RM == kWideFlat) {
        hit = access_flat_wide<kShard, kAdapt>(a, s, P, i, t, pcount, lane,
                                               ad);
      } else if constexpr (RM == kWideSet) {
        int h = 0;
        if (lane == 0) {
          if constexpr (kPol == kArc || kPol == kLfu)
            h = access_exact_panel<kPol>(a, s, P, i, t, arc);
          else
            h = access_exact<kSk == 1 ? 1 : 0, kAdapt, kPol>(a, s, P, i, t,
                                                             ad);
        }
        __syncwarp();
        hit = __shfl_sync(kFull, h, 0);
      } else if constexpr (kPol == kWtinylfu) {
        hit = access_set<RM, kShard, kAdapt>(a, s, ln, prot_cap, t, k, g,
                                             ad);
      } else {
        hit = access_panel<RM, kPol>(a, s, ln, P, t, k, g, arc);
      }
#endif
      if (lane == 0) a.hits[i] = hit;
      nhits += (hit && t >= P[P_WARMUP]) ? 1 : 0;
      if constexpr (kAdapt) ehits += hit;
      t += 1;
      if constexpr (!kWide) k = next;
      __syncwarp();
    }
  }
  __syncthreads();      // every thread has read regs before they change
  if (tid == 0) {       // (thread 0 is lane 0 of warp 0: it holds them all)
    a.regs[R_SIZE] = size;
    a.regs[R_PCOUNT] = pcount;
    a.regs[R_T] = t;
    a.regs[R_HITS] = nhits;
    if constexpr (kAdapt) {
      a.regs[R_WCOUNT] = ad.wcount;
      a.regs[R_MCOUNT] = ad.mcount;
      a.regs[R_EHITS] = ehits;
    }
    if constexpr (kPol == kArc) {
      a.regs[R_WQUOTA] = arc.p;
      a.regs[R_WCOUNT] = arc.t1;
      a.regs[R_MCOUNT] = arc.gb1;
      a.regs[R_EHITS] = arc.gb2;
    }
  }
}

// The instance for the geometry: the wide ones past kMaxDkp probes or
// kMaxWays ways.
template <bool kLanes, bool kShard, bool kAdapt, int kPol = kWtinylfu,
          bool kMesh = false>
int launch_rm(const StepArgs& a, int threads, cudaStream_t st) {
  const dim3 grid(kLanes ? a.lanes : 1);
  const int rm = (a.assoc + 15) / 16;
  const bool wide = a.dkp > kMaxDkp || a.assoc > kMaxWays || a.exact;
  if (a.assoc == 0) {
    if constexpr (kPol == kWtinylfu) {
      if (wide)
        sketch_step_kernel<kWideFlat, kLanes, kShard, kAdapt, kPol, kMesh>
            <<<grid, threads, 0, st>>>(a);
      else
        sketch_step_kernel<0, kLanes, kShard, kAdapt, kPol, kMesh>
            <<<grid, threads, 0, st>>>(a);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);   // no flat panel
    }
  } else if (wide) {
    sketch_step_kernel<kWideSet, kLanes, kShard, kAdapt, kPol, kMesh>
        <<<grid, threads, 0, st>>>(a);
  } else if (rm <= 1) {
    sketch_step_kernel<1, kLanes, kShard, kAdapt, kPol, kMesh>
        <<<grid, threads, 0, st>>>(a);
  } else if (rm <= 2) {
    sketch_step_kernel<2, kLanes, kShard, kAdapt, kPol, kMesh>
        <<<grid, threads, 0, st>>>(a);
  } else if (rm <= 4) {
    sketch_step_kernel<4, kLanes, kShard, kAdapt, kPol, kMesh>
        <<<grid, threads, 0, st>>>(a);
  } else {
    sketch_step_kernel<8, kLanes, kShard, kAdapt, kPol, kMesh>
        <<<grid, threads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef SKETCH_STEP_PANEL
template <int kPol>
int launch_policy(const StepArgs& a, int threads, cudaStream_t st) {
  return a.lanes ? launch_rm<true, false, false, kPol>(a, threads, st)
                 : launch_rm<false, false, false, kPol>(a, threads, st);
}
#else
template <bool kShard>
int launch_lanes(const StepArgs& a, int threads, cudaStream_t st) {
  return a.lanes ? launch_rm<true, kShard, kAdaptBuild>(a, threads, st)
                 : launch_rm<false, kShard, kAdaptBuild>(a, threads, st);
}
#endif

}  // namespace

// The static and adaptive builds run W-TinyLFU and take adaptive ==
// kAdaptBuild only; the panel build (-DSKETCH_STEP_PANEL) runs the
// competitors only, unsharded and static, on the set-associative tables.
extern "C" int sketch_step_launch(const StepArgs* args, int threads,
                                  void* stream) {
  const StepArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.lanes < 0 || a.halves < 1 || a.halves > 2
      || (a.adaptive != 0) != kAdaptBuild)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.mesh && (a.lanes || a.halves != 1 || !a.dcounters || !a.ddk
                 || a.local_shards < 1 || a.width_shard < 1))
    return static_cast<int>(cudaErrorInvalidValue);
#ifdef SKETCH_STEP_PANEL
  if (a.halves != 1 || a.assoc == 0 || (a.policy == kArc && !a.ghost)
      || a.mesh)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.policy) {
    case kS3fifo: return launch_policy<kS3fifo>(a, threads, st);
    case kArc: return launch_policy<kArc>(a, threads, st);
    case kLfu: return launch_policy<kLfu>(a, threads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#else
  if (a.policy != kWtinylfu) return static_cast<int>(cudaErrorInvalidValue);
  if (a.mesh)
    return launch_rm<false, false, kAdaptBuild, kWtinylfu, true>(a, threads,
                                                                 st);
  return a.halves == 2 ? launch_lanes<true>(a, threads, st)
                       : launch_lanes<false>(a, threads, st);
#endif
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
