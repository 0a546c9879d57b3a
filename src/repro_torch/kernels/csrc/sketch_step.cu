// Fused W-TinyLFU chunk step for Hopper (sm_90a).
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
constexpr int kMaxDkp = 8;
constexpr int kMaxWays = 128;    // the wrapper's _MAX_WAYS
constexpr int kNRegs = 8;        // NREGS

enum { P_WINDOW_CAP, P_MAIN_CAP, P_PROT_CAP, P_SAMPLE, P_CAP, P_WARMUP };
enum { R_SIZE, R_PCOUNT, R_T, R_HITS };
enum { WT_LO, WT_HI, WT_META, WT_MSET, WT_MSET2 };
enum { MT_LO, MT_HI, MT_META };

}  // namespace

// Mirrored field for field by _Args in sketch_step.py (pointers first).
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
  int n_valid, b, rows, dkp, dk_bits, counter_bits, words_per_row,
      counter_words, dk_words, window_slots, main_slots, assoc, wcols, mcols;
  int lanes;            // 0: one stream; B >= 1: the lane grid of B CTAs
  int params_stride;    // lane grid: 0 (shared params) or NPARAMS
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
      const uint32_t w = static_cast<uint32_t>(
          a.counters[r * a.words_per_row + (idx[r] >> s.shift)]);
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
        ok &= (static_cast<uint32_t>(a.dk[dkb[p] >> 5]) >> (dkb[p] & 31)) & 1u;
    est += ok ? 1u : 0u;
  }
  return static_cast<int>(est);
}

// One access against the exact flat tables; returns the hit flag.
__device__ int access_flat(const StepArgs& a, const Sketch& s, const int* P,
                           int i, int t, int& pcount, int lane) {
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
    if (hit_w) a.wmeta[jw] = t;               // window hit: refresh
    if (hit_m) a.mmeta[jm] = kProt | t;       // main hit: -> protected MRU
  }
  __syncwarp();
  pcount += (hit_m && mjm < kProt) ? 1 : 0;
  int v;
  if (pcount > P[P_PROT_CAP]) {               // demote the protected LRU
    const int kd = argmin_over(a.main_slots, [&](int j) {
      const int mm = a.mmeta[j]; return mm >= kProt ? mm : kI32Max; }, v);
    __syncwarp();
    if (lane == 0) a.mmeta[kd] = t;
    __syncwarp();
    pcount -= 1;
  }
  if (hit) return 1;

  // miss: insert into the window (argmin after the refresh); its LRU entry,
  // read before the insert, is the admission candidate
  int wsmeta;
  const int ws = argmin_over(a.window_slots, [&](int j) {
    return a.wmeta[j]; }, wsmeta);
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
    a.wmeta[ws] = t;
    for (int r = 0; r < a.rows; ++r) a.widx[ws * a.rows + r] = __ldg(kidx + r);
    for (int p = 0; p < a.dkp; ++p) a.wdkb[ws * a.dkp + p] = __ldg(kdkb + p);
  }
  __syncwarp();
  if (wsmeta < 0) return 0;                   // window had room: no push

  // free slot < probation LRU < protected LRU, after promote/demote
  int vmeta;
  const int tslot = argmin_over(a.main_slots, [&](int j) {
    return a.mmeta[j]; }, vmeta);
  bool do_ins = vmeta < 0;
  if (!do_ins) {
    int vidx[kMaxRows], vdkb[kMaxDkp];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < a.rows) vidx[r] = a.midx[tslot * a.rows + r];
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p)
      if (p < a.dkp) vdkb[p] = a.mdkb[tslot * a.dkp + p];
    do_ins = estimate(a, s, cidx, cdkb) > estimate(a, s, vidx, vdkb);
  }
  if (do_ins) {
    __syncwarp();
    if (lane == 0) {
      a.mlo[tslot] = cand_lo;
      a.mhi[tslot] = cand_hi;
      a.mmeta[tslot] = t;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < a.rows) a.midx[tslot * a.rows + r] = cidx[r];
#pragma unroll
      for (int p = 0; p < kMaxDkp; ++p)
        if (p < a.dkp) a.mdkb[tslot * a.dkp + p] = cdkb[p];
    }
    __syncwarp();
    if (vmeta >= kProt) pcount -= 1;
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

// Load the key's window set (every column) and the lo/hi/meta columns of
// its two main sets.  Loads only: nothing waits for them here.
template <int RM>
__device__ __forceinline__ void load_sets(const StepArgs& a, const Entry& k,
                                          SetRegs<RM>& g, int lane) {
  const int A = a.assoc;
#pragma unroll
  for (int r = 0; r < SetRegs<RM>::RW; ++r) {
    const int j = lane + 32 * r;
    g.wmeta[r] = kI32Max;
    if (j < A) {
      const int* p = a.wtab + (k.w * A + j) * a.wcols;
      g.wlo[r] = p[WT_LO];
      g.whi[r] = p[WT_HI];
      g.wmeta[r] = p[WT_META];
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
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int j = (lane & 15) + 16 * r;
    g.mmeta[r] = kI32Max;
    if (j < A) {
      const int* p = a.mtab + (set * A + j) * a.mcols;
      g.mlo[r] = p[MT_LO];
      g.mhi[r] = p[MT_HI];
      g.mmeta[r] = p[MT_META];
    }
  }
}

// SLRU promote-or-refresh of way j of main set h (in lanes 16 h ..), then
// the set's protected budget check (prot_cap[usable], the reference's
// max(1, usable * prot_cap // max(main_cap, 1))); writes the changed meta
// words.
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
template <int RM>
__device__ int access_set(const StepArgs& a, const Sketch& s, const Lanes& ln,
                          const int* prot_cap, int t, const Entry& k,
                          SetRegs<RM>& g) {
  constexpr int RW = SetRegs<RM>::RW;
  const int A = a.assoc, lane = ln.lane;
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
      a.wtab[(k.w * A + jw) * a.wcols + WT_META] = t;
    if (hit1) hit_update(a, prot_cap, g, 0, j1, k.m1, t, lane);
    if (hit2) hit_update(a, prot_cap, g, 1, j2, k.m2, t, lane);
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
    const int head[5] = {k.lo, k.hi, t, k.m1, k.m2};
    write_row(a, ln, a.wtab + (k.w * A + ws) * a.wcols, 5, head, k.pr);
  }
  if (!push) return 0;            // the window had room

  // the candidate's two main sets (meta and probe columns: on a miss no
  // main set changed, so the table holds the pre-access records) and its
  // sketch words, loaded together
  const int cset = lane < 16 ? c.m1 : c.m2;
  int cmeta[RM], cidx[RM][kMaxRows], cdkb[RM][kMaxDkp];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int j = (lane & 15) + 16 * r;
    cmeta[r] = kI32Max;
    if (j < A) {
      const int* p = a.mtab + (cset * A + j) * a.mcols;
      cmeta[r] = p[MT_META];
#pragma unroll
      for (int q = 0; q < kMaxRows; ++q)
        if (q < a.rows) cidx[r][q] = p[3 + q];
#pragma unroll
      for (int q = 0; q < kMaxDkp; ++q)
        if (q < a.dkp) cdkb[r][q] = p[3 + a.rows + q];
    }
  }
  const uint32_t cw = load_word(a, s, ln, c.pr);

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
    const uint32_t vw = load_word(a, s, ln, vpr);
    do_ins = estimate_of(a, s, ln, cw, c.pr) > estimate_of(a, s, ln, vw, vpr);
  }
  if (do_ins) {                   // the candidate takes the victim's way
    const int head[5] = {c.lo, c.hi, t, 0, 0};
    write_row(a, ln, a.mtab + ((vh ? c.m2 : c.m1) * A + vj) * a.mcols, 3,
              head, c.pr);
  }
  return 0;
}

// Point a at lane l of the lane-axis operands (every leaf is (lanes, ...)
// with the single-stream shape behind the lane axis).
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
  }
  if (a.nvalid) a.n_valid = a.nvalid[l];
}

// The chunk loop.  RM = 0: the flat tables; else the set-associative path
// with RM records per lane of a pair of main sets.  kLanes: CTA l runs
// lane l of the lane grid.
template <int RM, bool kLanes>
__global__ void __launch_bounds__(256) sketch_step_kernel(StepArgs a) {
  if constexpr (kLanes) to_lane(a, blockIdx.x);
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
  if (warp == 0 && a.n_valid > 0) load_key(a, ln, 0, k);
  for (int i = 0; i < a.n_valid; ++i) {
    SetRegs<RM == 0 ? 1 : RM> g;
    if (warp == 0) {
      if (i + 1 < a.n_valid) load_key(a, ln, i + 1, next);   // one ahead
#ifndef SKETCH_STEP_SKIP_ACCESS
      if constexpr (RM != 0) load_sets(a, k, g, lane);
#endif
#ifndef SKETCH_STEP_SKIP_ADD
      add_words(a, s, ln, P[P_CAP], k, load_word(a, s, ln, k.pr));
      __syncwarp();
#endif
    }
    // size is data-independent, so every thread agrees on when to reset
    size += 1;
    if (P[P_SAMPLE] > 0 && size >= P[P_SAMPLE]) {
      __syncthreads();
      for (int w = tid; w < a.counter_words; w += blockDim.x)
        a.counters[w] = static_cast<int>(
            (static_cast<uint32_t>(a.counters[w]) >> 1) & halve_mask);
      for (int w = tid; w < a.dk_words; w += blockDim.x) a.dk[w] = 0;
      __syncthreads();
      size /= 2;
    }
    if (warp == 0) {
#ifdef SKETCH_STEP_SKIP_ACCESS
      const int hit = 0;
#else
      int hit;
      if constexpr (RM == 0)
        hit = access_flat(a, s, P, i, t, pcount, lane);
      else
        hit = access_set(a, s, ln, prot_cap, t, k, g);
#endif
      if (lane == 0) a.hits[i] = hit;
      nhits += (hit && t >= P[P_WARMUP]) ? 1 : 0;
      t += 1;
      k = next;
      __syncwarp();
    }
  }
  __syncthreads();      // every thread has read regs before they change
  if (tid == 0) {
    a.regs[R_SIZE] = size;
    a.regs[R_PCOUNT] = pcount;
    a.regs[R_T] = t;
    a.regs[R_HITS] = nhits;
  }
}

template <bool kLanes>
int launch_rm(const StepArgs& a, int threads, cudaStream_t st) {
  const dim3 grid(kLanes ? a.lanes : 1);
  const int rm = (a.assoc + 15) / 16;
  if (a.assoc == 0)
    sketch_step_kernel<0, kLanes><<<grid, threads, 0, st>>>(a);
  else if (rm <= 1)
    sketch_step_kernel<1, kLanes><<<grid, threads, 0, st>>>(a);
  else if (rm <= 2)
    sketch_step_kernel<2, kLanes><<<grid, threads, 0, st>>>(a);
  else if (rm <= 4)
    sketch_step_kernel<4, kLanes><<<grid, threads, 0, st>>>(a);
  else if (rm <= 8)
    sketch_step_kernel<8, kLanes><<<grid, threads, 0, st>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sketch_step_launch(const StepArgs* args, int threads,
                                  void* stream) {
  const StepArgs& a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
  return a.lanes ? launch_rm<true>(a, threads, st)
                 : launch_rm<false>(a, threads, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
