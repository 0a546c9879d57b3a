// Fused W-TinyLFU chunk step for Hopper (sm_90a).
//
// Replaces the TPU kernel step_pallas / _step_kernel of
// src/repro/kernels/sketch_step.py: one launch advances one chunk of
// n_valid accesses of one stream through the doorkeeper test-and-insert,
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
// goes to the latency of the dependent L2 round trips and warp reductions.
//
// What the design does about it: one block per stream (streams > 1 later
// becomes one block per lane).  Warp 0 runs the per-access chain; its
// reductions (first-index argmin / argmax over the flat tables or over the
// A-record window set and the 2A-record candidate sets) are warp shuffles,
// so no block barrier sits on the per-access path.  The set-associative
// blocks are staged in shared memory, so every decision of an access reads
// on-chip copies of the pre-access records, and the block writes go last
// (km1, km2, c1, c2, window; later writes win, and a given word is always
// written by the same lane, so program order is write order).  The sketch
// stays in global memory (L2-resident at the main path's 512 KB).  Every
// thread of the block tracks the sketch size register itself (it advances
// by one per access and halves at a reset, independent of the data), so the
// whole block meets at __syncthreads only on the accesses where the reset
// fires and then halves the sketch together.
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
  int n_valid, b, rows, dkp, dk_bits, counter_bits, words_per_row,
      counter_words, dk_words, window_slots, main_slots, assoc, wcols, mcols;
};

namespace {

struct Sketch {
  int shift;            // probe -> word: >> 3 (4-bit) or >> 2 (8-bit)
  int cpw_mask;         // counters per word - 1
  uint32_t capmax;      // field mask
};

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

// Doorkeeper gate -> conservative increment.  Every lane of warp 0 issues
// all the reads (doorkeeper and counter words together: the two arrays are
// disjoint, so no read waits on the other's writes) and decides; lane 0
// writes after all lanes have read.
__device__ __forceinline__ void sketch_add(const StepArgs& a, const Sketch& s,
                                           int cap, const int* kidx,
                                           const int* kdkb, int lane) {
  int kb[kMaxDkp], w_idx[kMaxDkp];
  uint32_t words[kMaxDkp];
  int flat[kMaxRows], sub[kMaxRows];
  uint32_t cw[kMaxRows], vals[kMaxRows];
  if (a.dk_bits) {
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p) {
      if (p < a.dkp) {
        kb[p] = __ldg(kdkb + p);
        w_idx[p] = kb[p] >> 5;
        words[p] = static_cast<uint32_t>(a.dk[w_idx[p]]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < a.rows) {
      const int k = __ldg(kidx + r);
      flat[r] = r * a.words_per_row + (k >> s.shift);
      sub[r] = (k & s.cpw_mask) * a.counter_bits;
      cw[r] = static_cast<uint32_t>(a.counters[flat[r]]);
    }
  }
  bool gate = true;
  if (a.dk_bits) {
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p) {
      if (p < a.dkp) {
        bool eff = (words[p] >> (kb[p] & 31)) & 1u;
#pragma unroll
        for (int q = 0; q < p; ++q) eff |= (kb[q] == kb[p]);  // earlier probe
        gate &= eff;
      }
    }
  }
  uint32_t m = 0xffffffffu;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < a.rows) {
      vals[r] = (cw[r] >> sub[r]) & s.capmax;
      m = vals[r] < m ? vals[r] : m;
    }
  }
  const bool bump = gate && static_cast<int>(m) < cap;
  __syncwarp();
  if (lane == 0) {
    if (a.dk_bits) {
#pragma unroll
      for (int p = 0; p < kMaxDkp; ++p) {
        if (p < a.dkp) {
          uint32_t merged = words[p] | (1u << (kb[p] & 31));
#pragma unroll
          for (int q = 0; q < kMaxDkp; ++q)   // probes sharing a word merge
            if (q < a.dkp && q != p && w_idx[q] == w_idx[p])
              merged |= 1u << (kb[q] & 31);
          a.dk[w_idx[p]] = static_cast<int>(merged);
        }
      }
    }
    if (bump) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)   // every row at the minimum
        if (r < a.rows && vals[r] == m)
          a.counters[flat[r]] = static_cast<int>(cw[r] + (1u << sub[r]));
    }
  }
  __syncwarp();
}

// TinyLFU estimate of one entry from its stored probes.
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

__device__ __forceinline__ void copy_block(int* dst, const int* src, int n,
                                           int lane) {
  for (int e = lane; e < n; e += 32) dst[e] = src[e];
}

// Up to three block copies (n_k = 0 skips one) with each lane's loads all
// issued before its stores, so the round trips to L2 overlap instead of
// queueing one behind the other.  Same lane-to-element map as copy_block.
__device__ __forceinline__ void copy_blocks(int* d0, const int* s0, int n0,
                                            int* d1, const int* s1, int n1,
                                            int* d2, const int* s2, int n2,
                                            int lane) {
  constexpr int K = 8;
  const int n = max(n0, max(n1, n2));
  for (int base = lane; base < n; base += 32 * K) {
    int v0[K], v1[K], v2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = base + 32 * k;
      if (e < n0) v0[k] = s0[e];
      if (e < n1) v1[k] = s1[e];
      if (e < n2) v2[k] = s2[e];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = base + 32 * k;
      if (e < n0) d0[e] = v0[k];
      if (e < n1) d1[e] = v1[k];
      if (e < n2) d2[e] = v2[k];
    }
  }
}

// SLRU promote-or-refresh of way j of a main set block in shared memory,
// then the per-set protected budget check (integer floor division).
__device__ void hit_update(const StepArgs& a, const int* P, int* blk, int j,
                           int t, int lane) {
  const int A = a.assoc, MC = a.mcols;
  __syncwarp();
  if (lane == 0) blk[j * MC + MT_META] = kProt | t;
  __syncwarp();
  int usable = 0, nprot = 0;
  for (int w = lane; w < A; w += 32) {
    const int mm = blk[w * MC + MT_META];
    usable += mm != kI32Max;
    nprot += mm >= kProt && mm != kI32Max;
  }
  usable = __reduce_add_sync(kFull, usable);
  nprot = __reduce_add_sync(kFull, nprot);
  const int main_cap = P[P_MAIN_CAP] > 1 ? P[P_MAIN_CAP] : 1;
  long long cap = static_cast<long long>(usable) * P[P_PROT_CAP] / main_cap;
  if (cap < 1) cap = 1;
  if (nprot > cap) {
    int v;
    const int kd = argmin_over(A, [&](int w) {
      const int mm = blk[w * MC + MT_META]; return mm >= kProt ? mm : kI32Max;
    }, v);
    __syncwarp();
    if (lane == 0) blk[kd * MC + MT_META] = t;
    __syncwarp();
  }
}

// One access against the set-associative tables; returns the hit flag.
__device__ int access_set(const StepArgs& a, const Sketch& s, const int* P,
                          int i, int t, int* smem, int lane) {
  const int A = a.assoc, WC = a.wcols, MC = a.mcols;
  int* wb = smem;                 // key's window set
  int* mb1 = wb + A * WC;         // key's main choice sets
  int* mb2 = mb1 + A * MC;
  int* cb1 = mb2 + A * MC;        // candidate's main choice sets
  int* cb2 = cb1 + A * MC;
  const int klo = __ldg(a.lo + i), khi = __ldg(a.hi + i);
  const int kw = __ldg(a.kwset + i);
  const int km1 = __ldg(a.kmset + 2 * i), km2 = __ldg(a.kmset + 2 * i + 1);
  const bool same_km = km1 == km2;
  copy_blocks(wb, a.wtab + kw * A * WC, A * WC, mb1, a.mtab + km1 * A * MC,
              A * MC, mb2, a.mtab + km2 * A * MC, A * MC, lane);
  __syncwarp();

  bool hit_w, hit1, hit2;
  const int jw = first_true(A, [&](int j) {
    return wb[j * WC + WT_LO] == klo && wb[j * WC + WT_HI] == khi &&
           wb[j * WC + WT_META] >= 0; }, hit_w);
  const int j1 = first_true(A, [&](int j) {
    return mb1[j * MC + MT_LO] == klo && mb1[j * MC + MT_HI] == khi &&
           mb1[j * MC + MT_META] >= 0; }, hit1);
  const int j2 = first_true(A, [&](int j) {
    return mb2[j * MC + MT_LO] == klo && mb2[j * MC + MT_HI] == khi &&
           mb2[j * MC + MT_META] >= 0; }, hit2);
  hit2 = hit2 && !same_km;        // aliased choices: count set 1 only
  const bool hit = hit_w || hit1 || hit2;
  __syncwarp();
  if (lane == 0 && hit_w) wb[jw * WC + WT_META] = t;
  if (hit1) hit_update(a, P, mb1, j1, t, lane);
  if (hit2) hit_update(a, P, mb2, j2, t, lane);
  int* m2 = same_km ? mb1 : mb2;  // aliased sets follow set 1

  int c1 = 0, c2 = 0;
  if (!hit) {
    int wsm;
    const int ws = argmin_over(A, [&](int j) {
      return wb[j * WC + WT_META]; }, wsm);
    // a zero-way window set (argmin on padding) bypasses the window: the
    // incoming key itself becomes the candidate
    const bool w_ok = wsm != kI32Max;
    const bool push = wsm >= 0 || !w_ok;
    // candidate record: the window's LRU entry, or the key itself when the
    // window is bypassed.  Register arrays are indexed by unrolled constants
    // only, so they stay in registers.
    const int* kidx = a.kidx + i * a.rows;
    const int* kdkb = a.kdkb + i * a.dkp;
    const int* wrow = wb + ws * WC;
    int cidx[kMaxRows], cdkb[kMaxDkp];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < a.rows) cidx[r] = w_ok ? wrow[5 + r] : __ldg(kidx + r);
#pragma unroll
    for (int p = 0; p < kMaxDkp; ++p)
      if (p < a.dkp) cdkb[p] = w_ok ? wrow[5 + a.rows + p] : __ldg(kdkb + p);
    const int cand_lo = w_ok ? wrow[WT_LO] : klo;
    const int cand_hi = w_ok ? wrow[WT_HI] : khi;
    c1 = w_ok ? wrow[WT_MSET] : km1;
    c2 = w_ok ? wrow[WT_MSET2] : km2;
    __syncwarp();
    if (lane == 0 && w_ok) {          // insert the key into the window
      int* row = wb + ws * WC;
      row[WT_LO] = klo; row[WT_HI] = khi; row[WT_META] = t;
      row[WT_MSET] = km1; row[WT_MSET2] = km2;
      for (int r = 0; r < a.rows; ++r) row[5 + r] = __ldg(kidx + r);
      for (int p = 0; p < a.dkp; ++p) row[5 + a.rows + p] = __ldg(kdkb + p);
    }
    // the candidate's sets come from the pre-access table, with the hit
    // updates replayed where they alias the key's sets
    copy_blocks(cb1, c1 == km2 ? m2 : c1 == km1 ? mb1 : a.mtab + c1 * A * MC,
                A * MC,
                cb2, c2 == km2 ? m2 : c2 == km1 ? mb1 : a.mtab + c2 * A * MC,
                A * MC, nullptr, nullptr, 0, lane);
    __syncwarp();
    // weakest of the 2A records; ties pick the first half
    int vm;
    const int ts = argmin_over(2 * A, [&](int k) {
      return k < A ? cb1[k * MC + MT_META] : cb2[(k - A) * MC + MT_META];
    }, vm);
    int* vic = ts < A ? cb1 + ts * MC : cb2 + (ts - A) * MC;
    bool do_ins = false;
    if (push && vm != kI32Max) {  // padding victims never accept an insert
      do_ins = vm < 0;
      if (!do_ins) {
        int vidx[kMaxRows], vdkb[kMaxDkp];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < a.rows) vidx[r] = vic[3 + r];
#pragma unroll
        for (int p = 0; p < kMaxDkp; ++p)
          if (p < a.dkp) vdkb[p] = vic[3 + a.rows + p];
        do_ins = estimate(a, s, cidx, cdkb) > estimate(a, s, vidx, vdkb);
      }
    }
    __syncwarp();
    if (do_ins && lane == 0) {
      vic[MT_LO] = cand_lo;
      vic[MT_HI] = cand_hi;
      vic[MT_META] = t;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < a.rows) vic[3 + r] = cidx[r];
#pragma unroll
      for (int p = 0; p < kMaxDkp; ++p)
        if (p < a.dkp) vic[3 + a.rows + p] = cdkb[p];
    }
    __syncwarp();
    if (c1 == c2) copy_block(cb2, cb1, A * MC, lane);
    __syncwarp();
  }

  // writes last, in the reference's order; with a hit the candidate's sets
  // hold exactly what the km writes leave, so only a miss writes them
  copy_block(a.mtab + km1 * A * MC, mb1, A * MC, lane);
  copy_block(a.mtab + km2 * A * MC, m2, A * MC, lane);
  if (!hit) {
    copy_block(a.mtab + c1 * A * MC, cb1, A * MC, lane);
    copy_block(a.mtab + c2 * A * MC, cb2, A * MC, lane);
  }
  copy_block(a.wtab + kw * A * WC, wb, A * WC, lane);
  return hit ? 1 : 0;
}

__global__ void __launch_bounds__(256) sketch_step_kernel(StepArgs a) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = a.n_valid + tid; j < a.b; j += blockDim.x) a.hits[j] = 0;

  int P[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) P[k] = a.params[k];
  int size = a.regs[R_SIZE];
  int pcount = a.regs[R_PCOUNT];
  int t = a.regs[R_T];
  int nhits = a.regs[R_HITS];
  Sketch s;
  s.shift = a.counter_bits == 4 ? 3 : 2;
  s.cpw_mask = 32 / a.counter_bits - 1;
  s.capmax = (1u << a.counter_bits) - 1u;
  const uint32_t halve_mask = a.counter_bits == 4 ? 0x77777777u : 0x7F7F7F7Fu;

  for (int i = 0; i < a.n_valid; ++i) {
#ifndef SKETCH_STEP_SKIP_ADD
    if (warp == 0)
      sketch_add(a, s, P[P_CAP], a.kidx + i * a.rows, a.kdkb + i * a.dkp,
                 lane);
#endif
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
      const int hit = a.assoc == 0
          ? access_flat(a, s, P, i, t, pcount, lane)
          : access_set(a, s, P, i, t, smem, lane);
#endif
      if (lane == 0) a.hits[i] = hit;
      nhits += (hit && t >= P[P_WARMUP]) ? 1 : 0;
      t += 1;
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

}  // namespace

extern "C" int sketch_step_launch(const StepArgs* args, int threads,
                                  int smem_bytes, void* stream) {
  sketch_step_kernel<<<1, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
