// Blocked online-softmax attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel flash_attention_tpu / _flash_kernel of
// src/repro/kernels/flash_attention.py and the jnp flash_attention of
// src/repro/models/layers.py, with the latter's contract: causal or full,
// q_offset (position of q's first row), kv_len (keys at or past it masked,
// per batch row or one value) and a tanh softcap.  q and out are
// (B, Sq, Hq, D) contiguous; k and v are (B, Skv, Hkv, D) read through
// their strides (a slice of the KV cache, no copy), and query head h reads
// KV head h / (Hq / Hkv).  Scores are fp32 dots times 1/sqrt(D), then the
// softcap; masked scores are -1e30; the running max, denominator and
// accumulator are fp32; P is rounded to bf16 before P.V while the
// denominator sums the fp32 P; the output is acc / max(l, 1e-30) rounded
// to bf16.
//
// What bounds it on this card: a prefill of S tokens does 4*D*Hq flops
// per visible (query, key) pair, about S^2/2 pairs when causal, against
// one read of q, k, v and one write of out.  At the serving path's shapes
// (S = 1280, D = 128, 32 query and 8 KV heads) that is ~13 GFLOP against
// ~26 MB, so the bf16 tensor cores bound it, not the memory.
//
// The design: a work item is 128 rows of one batch row, namely gp query
// heads that share one KV head times 128 / gp query positions (gp = the
// largest power of two that divides Hq / Hkv, at most 16), so a K/V tile is
// fetched once for the gp heads.  Items are numbered heaviest first (later
// positions, when causal), and one persistent CTA per SM (224 KB of shared
// memory at D = 128) takes them in a zigzag over the CTAs, so a CTA's next
// item loads while it finishes the last and the causal tail balances.  A
// CTA is three warpgroups:
//
// * Warpgroup 2 is the producer: one thread loads each item's Q and streams
//   its 128-key K and V tiles into a three-stage ring in shared memory with
//   TMA (cp.async.bulk.tensor over 4-D maps of (D, H, S, B) built on the
//   host for every call, with the caller's strides), with full and empty
//   mbarriers per stage and one for Q.  Tiles are D / 64 sub-tiles of 64
//   columns in the 128-byte swizzle (64- and 32-byte swizzles at D = 32 and
//   16).  It keeps 40 registers (setmaxnreg) and gives the rest to the
//   consumers.
// * Warpgroups 0 and 1 are the consumers, 64 rows each, 232 registers.
//   S = Q K^T is wgmma m64n128k16 from shared memory (Q and K K-major),
//   fp32 accumulators; then scale, softcap and mask, and the online
//   softmax in registers (a row's four threads reduce by shuffles).  P is
//   the S accumulator rounded to bf16 in place, which is the A fragment
//   layout of wgmma with A in registers, so O += P V is wgmma m64nDk16
//   with V from shared memory as an MN-major B operand.  Tile t's S GEMM
//   is issued with tile t-1's P V, so a warpgroup's softmax runs while the
//   tensor cores do its P V, and the two warpgroups take turns to issue
//   (named barriers), so one's softmax also overlaps the other's GEMMs.
// * Keys past kv_len: the map's bounds zero-fill rows past Skv, but cache
//   slots between kv_len and Skv hold whatever the cache held, and a
//   masked P of 0 times a NaN there is NaN.  So the consumers zero the V
//   rows from kv_len to the end of the last tile in shared memory before
//   its P V (scores of such keys are masked by a select, so K needs none).
//
// The training instances (flash_attention_train_launch: causal, q_offset 0,
// the whole of k and v) also write each row's log-sum-exp of its scores,
// m + log l in fp32 at (B, Hq, Sq), which the backward kernel
// (flash_attention_bwd.cu) reads to recompute P.  Their parameters are a
// TrainParams, so the serving instances keep their Params and their code.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;           // rows per CTA: two consumer warpgroups
constexpr int BN = 128;           // keys per tile
constexpr int STAGES = 3;         // K/V ring depth
constexpr int THREADS = 384;      // consumers: warps 0-7; producer: 8-11
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap q_map, k_map, v_map;
  __nv_bfloat16* out;
  const int* kv_len;              // (B,) or null: then kv_len_default
  int b, sq, skv, hq, hkv, gp;    // gp: query heads per work item
  int causal, q_offset, kv_len_default;
  float softcap, scale;
};

struct TrainParams : Params {
  float* lse;                     // (B, Hq, Sq): m + log l of each row
};

// Shared-memory layout (bytes from a 1024-aligned base) for head dim D.
template <int D>
struct Layout {
  static constexpr int DS = D < 64 ? D : 64;      // columns per sub-tile
  static constexpr int ROWB = DS * 2;             // bytes per sub-tile row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V tile
  static constexpr int K_OFF = Q_BYTES;           // + stage * KV_BYTES
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 128 + 1024;  // + alignment slack
  // wgmma layout type of the sub-tiles' swizzle: 128B / 64B / 32B
  static constexpr uint32_t SWIZZLE = DS == 64 ? 1 : DS == 32 ? 2 : 3;
};

// O += P V over one tile: BN / 16 k-steps of wgmma with P (bf16 A
// fragments) in registers and V (MN-major) at vt in shared memory.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&pa)[BN / 16][4],
                                   uint32_t vt, uint32_t sbo) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(o, pa[kk], desc(vt + kk * 16 * L::ROWB, BN * L::ROWB, sbo,
                                L::SWIZZLE));
}

// Scores of one tile in place: softcapped (then scaled first) and masked:
// of this thread's columns c, c + 1 of each group of 8, the ones at or past
// lim0 (row r0) / lim1 (row r0 + 8), counted from the tile's first key
// plus c, are masked.  Without a softcap the scale is left to the exponent
// (see softmax), which takes it in its one FFMA.
template <bool MASK, bool SOFTCAP, int N>
__device__ __forceinline__ void scores(float (&s)[N], const Params& p,
                                       int lim0, int lim1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if constexpr (SOFTCAP) x = tanhf(x * p.scale / p.softcap) * p.softcap;
      if constexpr (MASK)
        x = 8 * j + (e & 1) < (e < 2 ? lim0 : lim1) ? x : NEG_INF;
      s[4 * j + e] = x;
    }
  }
}

// One level of a pairwise tree over r[0 .. 2W), then the levels below.
template <bool SUM, int W, int M>
__device__ __forceinline__ void tree(float (&r)[M]) {
  if constexpr (W > 0) {
#pragma unroll
    for (int j = 0; j < W; ++j)
      r[j] = SUM ? r[j] + r[j + W] : fmaxf(r[j], r[j + W]);
    tree<SUM, W / 2>(r);
  }
}

// Max (or sum) over the thread's columns of its row h (0: elements 0, 1 of
// each group of four; 1: elements 2, 3), as a tree.
template <bool SUM, int N>
__device__ __forceinline__ float row_reduce(const float (&s)[N], int h) {
  float r[N / 4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    r[j] = SUM ? s[4 * j + 2 * h] + s[4 * j + 2 * h + 1]
               : fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
  tree<SUM, N / 8>(r);
  return r[0];
}

// One work item: 128 rows (gp query heads x BM / gp positions) of one
// batch row, and the key tiles they see.  Items are numbered heaviest
// first (later positions, when causal).
struct Item {
  int h0, hk, bi, q0, kv_lim, ntiles;
};

__device__ __forceinline__ Item item_of(const Params& p, int u) {
  const int ngroups = p.hq / p.gp, npos = BM / p.gp;
  const int per_tile = ngroups * p.b;
  Item it;
  it.q0 = ((p.sq + npos - 1) / npos - 1 - u / per_tile) * npos;
  it.h0 = (u % ngroups) * p.gp;
  it.bi = (u % per_tile) / ngroups;
  it.hk = it.h0 / (p.hq / p.hkv);
  int kv_lim = p.kv_len ? p.kv_len[it.bi] : p.kv_len_default;
  it.kv_lim = min(kv_lim, p.skv);
  int hi = it.kv_lim;
  if (p.causal) hi = min(hi, p.q_offset + min(it.q0 + npos, p.sq));
  it.ntiles = hi > 0 ? (hi + BN - 1) / BN : 0;
  return it;
}

// The CTA's items: a zigzag over the CTAs (c, 2G - 1 - c, 2G + c, ...), so
// each takes a heavy and a light one in turn.
__device__ __forceinline__ int next_item(int u) {
  const int g = gridDim.x, c = blockIdx.x, r = u / g + 1;
  return r * g + (r & 1 ? g - 1 - c : c);
}

template <int D, bool SOFTCAP, class P>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ P p) {
  using L = Layout<D>;
  constexpr bool LSE = std::is_same<P, TrainParams>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR_OFF;     // Q loaded
  const uint32_t bar_q_empty = bar_q + 8;       // Q no longer read
  const uint32_t bar_full = bar_q + 16;         // + 8 * stage: tile loaded
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // tile released
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_items = ((p.sq + BM / p.gp - 1) / (BM / p.gp)) * (p.hq / p.gp)
                      * p.b;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, 2);                  // one arrive per consumer
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread issues every TMA load --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      int n = 0, done = 0;            // K/V tiles and items so far
      for (int u = blockIdx.x; u < n_items; u = next_item(u), ++done) {
        const Item it = item_of(p, u);
        if (done > 0) mbar_wait(bar_q_empty, (done - 1) & 1);
        mbar_expect_tx(bar_q, L::Q_BYTES);
        for (int s = 0; s < D / L::DS; ++s)
          tma_load(base + s * BM * L::ROWB, &p.q_map, bar_q, s * L::DS, it.h0,
                   it.q0, it.bi);
        for (int t = 0; t < it.ntiles; ++t, ++n) {
          const int st = n % STAGES;
          if (n >= STAGES) mbar_wait(bar_empty + 8 * st, (n / STAGES - 1) & 1);
          const uint32_t full = bar_full + 8 * st;
          mbar_expect_tx(full, 2 * L::KV_BYTES);
          for (int s = 0; s < D / L::DS; ++s) {
            const uint32_t off = st * L::KV_BYTES + s * BN * L::ROWB;
            tma_load(base + L::K_OFF + off, &p.k_map, full, s * L::DS, it.hk,
                     t * BN, it.bi);
            tma_load(base + L::V_OFF + off, &p.v_map, full, s * L::DS, it.hk,
                     t * BN, it.bi);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows per warpgroup ------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int wg = warp >> 2;
    const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);   // rows r0,
    const int c = 2 * (lane & 3);                               // r0 + 8
    const uint32_t sbo = 8 * L::ROWB;
    float o[D / 2], s[BN / 2];
    uint32_t pa[BN / 16][4];          // P of the tile before, bf16
    float m0, m1, l0, l1;
    int n = 0;                        // K/V tiles consumed so far
    Item it{};
    int vis0 = 0, vis1 = 0;           // the rows' last visible keys (causal)

    // Wait for tile t of the item, zero its V rows past kv_len (see the
    // top), then issue its S = Q K^T (64 x 128 per warpgroup) in this
    // warpgroup's turn.  Named barriers of the consumers: 1 orders the
    // tail zeroing; 2 + w is warpgroup w's turn to issue its S GEMM.
    auto issue_s = [&](int t) {
      const int st = (n + t) % STAGES, k0 = t * BN;
      mbar_wait(bar_full + 8 * st, ((n + t) / STAGES) & 1);
      if (k0 + BN > it.kv_lim && it.kv_lim < p.skv) {
        const int z0 = it.kv_lim - k0, nz = min(BN, p.skv - k0) - z0;
        constexpr int CH = L::ROWB / 16;
        uint8_t* vt = smem + L::V_OFF + st * L::KV_BYTES;
        for (int i = tid; i < (D / L::DS) * nz * CH; i += 256) {
          const int sub = i / (nz * CH), rem = i % (nz * CH);
          *reinterpret_cast<uint4*>(vt + sub * BN * L::ROWB
                                    + (z0 + rem / CH) * L::ROWB
                                    + (rem % CH) * 16) = make_uint4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1);
      }
      const uint32_t kt = base + L::K_OFF + st * L::KV_BYTES;
      named_sync(2 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int sub = kk * 16 / L::DS, col = (kk * 16 % L::DS) * 2;
        wgmma_ss_n128(
            s,
            desc(base + sub * BM * L::ROWB + wg * 64 * L::ROWB + col, 16, sbo,
                 L::SWIZZLE),
            desc(kt + sub * BN * L::ROWB + col, 16, sbo, L::SWIZZLE),
            kk > 0);
      }
      wgmma_commit();
    };
    // After the item's last S GEMM: this warpgroup reads Q no more.
    auto q_done = [&](int t) {
      if (t == it.ntiles - 1 && (tid & 127) == 0) mbar_arrive(bar_q_empty);
    };
    // Softcap, mask; the online softmax of the thread's two rows: s
    // becomes p = exp(scale * (x - max)) (as 2^(x c - max c), c = scale *
    // log2e; with a softcap x is already scaled and c = log2e); corr0 and
    // corr1 get the rescale factors of the two rows.
    auto softmax = [&](int t, float& corr0, float& corr1) {
      const int k0 = t * BN;
      if (k0 + BN > it.kv_lim
          || (p.causal && k0 + BN - 1 > p.q_offset + it.q0)) {
        // a key is visible below kv_lim and, when causal, at or before the
        // row's position
        const int lim0 = p.causal ? min(it.kv_lim, vis0 + 1) : it.kv_lim;
        const int lim1 = p.causal ? min(it.kv_lim, vis1 + 1) : it.kv_lim;
        scores<true, SOFTCAP>(s, p, lim0 - k0 - c, lim1 - k0 - c);
      } else {
        scores<false, SOFTCAP>(s, p, 0, 0);
      }
      float mx0 = fmaxf(m0, row_reduce<false>(s, 0));
      float mx1 = fmaxf(m1, row_reduce<false>(s, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float cl = SOFTCAP ? LOG2E : p.scale * LOG2E;
      const float ml0 = mx0 * cl, ml1 = mx1 * cl;
      corr0 = ex2(m0 * cl - ml0);
      corr1 = ex2(m1 * cl - ml1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], cl, -ml0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], cl, -ml0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], cl, -ml1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], cl, -ml1));
      }
      l0 = l0 * corr0 + row_reduce<true>(s, 0);   // this thread's columns
      l1 = l1 * corr1 + row_reduce<true>(s, 1);
      m0 = mx0;
      m1 = mx1;
    };
    // P to the A fragments: chunk j holds keys 8j..8j+7, k-step j / 2.
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        pa[j / 2][2 * (j & 1)] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j / 2][2 * (j & 1) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };

    if (wg == 1) named_arrive(2);     // warpgroup 0 issues first
    int done = 0;
    for (int u = blockIdx.x; u < n_items; u = next_item(u), ++done) {
      it = item_of(p, u);
      const int pos0 = it.q0 + r0 / p.gp, pos1 = it.q0 + (r0 + 8) / p.gp;
      vis0 = p.q_offset + pos0;
      vis1 = p.q_offset + pos1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;
      mbar_wait(bar_q, done & 1);
      if (it.ntiles == 0 && (tid & 127) == 0) mbar_arrive(bar_q_empty);

      // Tile t's S GEMM is issued together with tile t-1's P V, so this
      // warpgroup's softmax of tile t runs while the tensor cores do its
      // P V (and the other warpgroup's GEMMs: the two take turns to
      // issue).  The first tile is peeled off, so every wgmma wait is
      // unconditional (ptxas serializes all of a kernel's wgmma otherwise).
      float corr0, corr1;
      if (it.ntiles > 0) {
        issue_s(0);
        named_arrive(3 - wg);
        wgmma_wait<0>();
        fence_regs(s);
        q_done(0);
        softmax(0, corr0, corr1);     // o is zero: nothing to rescale
        pack_p();
      }
      for (int t = 1; t < it.ntiles; ++t) {
        const int prev = (n + t - 1) % STAGES;
        issue_s(t);
        pv<D>(o, pa, base + L::V_OFF + prev * L::KV_BYTES, sbo);
        wgmma_commit();
        named_arrive(3 - wg);
        wgmma_wait<1>();              // S(t) done, P V of t - 1 may run on
        fence_regs(s);
        q_done(t);
        softmax(t, corr0, corr1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if ((tid & 127) == 0) mbar_arrive(bar_empty + 8 * prev);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr0;
          o[4 * j + 1] *= corr0;
          o[4 * j + 2] *= corr1;
          o[4 * j + 3] *= corr1;
        }
        pack_p();
      }
      if (it.ntiles > 0) {            // the last tile's P V
        const int last = (n + it.ntiles - 1) % STAGES;
        wgmma_fence();
        pv<D>(o, pa, base + L::V_OFF + last * L::KV_BYTES, sbo);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        if ((tid & 127) == 0) mbar_arrive(bar_empty + 8 * last);
      }
      n += it.ntiles;

      // the denominators over the row's four threads, then the output
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
      if constexpr (LSE) {
        // m is in the units of the scores before the scale, unless capped
        if ((lane & 3) == 0) {
          const float cm = SOFTCAP ? 1.f : p.scale;
          float* lse = p.lse + (static_cast<size_t>(it.bi) * p.hq + it.h0)
                                   * p.sq;
          if (pos0 < p.sq) lse[(r0 % p.gp) * p.sq + pos0] = m0 * cm + logf(l0);
          if (pos1 < p.sq)
            lse[((r0 + 8) % p.gp) * p.sq + pos1] = m1 * cm + logf(l1);
        }
      }
      __nv_bfloat16* out0 = p.out + ((static_cast<size_t>(it.bi) * p.sq
                                      + pos0) * p.hq + it.h0 + r0 % p.gp)
                                    * D + c;
      __nv_bfloat16* out1 = p.out + ((static_cast<size_t>(it.bi) * p.sq
                                      + pos1) * p.hq + it.h0
                                     + (r0 + 8) % p.gp) * D + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (pos0 < p.sq)
          *reinterpret_cast<uint32_t*>(out0 + 8 * j) =
              pack_bf16(o[4 * j] * d0, o[4 * j + 1] * d0);
        if (pos1 < p.sq)
          *reinterpret_cast<uint32_t*>(out1 + 8 * j) =
              pack_bf16(o[4 * j + 2] * d1, o[4 * j + 3] * d1);
      }
    }
    if (wg == 0) named_sync(2);       // warpgroup 1's last turn signal
  }
}

template <int D, bool SOFTCAP, class P>
cudaError_t launch(P& p, const void* q, const void* k, const void* v,
                   int b, int d, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh,
                   cudaStream_t stream) {
  using L = Layout<D>;
  const int npos = BM / p.gp;
  if (!make_map(&p.q_map, q, d, p.hq, p.sq, b, d,
                static_cast<long long>(p.hq) * d,
                static_cast<long long>(p.sq) * p.hq * d, L::DS, p.gp, npos)
      || !make_map(&p.k_map, k, d, p.hkv, p.skv, b, ksh, kss, ksb, L::DS, 1,
                   BN)
      || !make_map(&p.v_map, v, d, p.hkv, p.skv, b, vsh, vss, vsb, L::DS, 1,
                   BN))
    return cudaErrorInvalidValue;
  static bool sized = false;      // per instantiation: above 48 KB opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D, SOFTCAP, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  // persistent: one CTA per SM (or per item, when there are fewer)
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  const int items = (p.sq + npos - 1) / npos * (p.hq / p.gp) * b;
  flash_attention_kernel<D, SOFTCAP, P>
      <<<items < sms ? items : sms, THREADS, L::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// The instance for head dim d and the softcap, over the parameter type.
template <class P>
cudaError_t dispatch(P& p, const void* q, const void* k, const void* v, int d,
                     int ksb, int kss, int ksh, int vsb, int vss, int vsh,
                     cudaStream_t s) {
  const bool cap = p.softcap > 0.f;
  const int b = p.b;
  switch (d) {
    case 16: return cap ? launch<16, true>(p, q, k, v, b, d, ksb, kss, ksh,
                                           vsb, vss, vsh, s)
                        : launch<16, false>(p, q, k, v, b, d, ksb, kss, ksh,
                                            vsb, vss, vsh, s);
    case 32: return cap ? launch<32, true>(p, q, k, v, b, d, ksb, kss, ksh,
                                           vsb, vss, vsh, s)
                        : launch<32, false>(p, q, k, v, b, d, ksb, kss, ksh,
                                            vsb, vss, vsh, s);
    case 64: return cap ? launch<64, true>(p, q, k, v, b, d, ksb, kss, ksh,
                                           vsb, vss, vsh, s)
                        : launch<64, false>(p, q, k, v, b, d, ksb, kss, ksh,
                                            vsb, vss, vsh, s);
    case 128: return cap ? launch<128, true>(p, q, k, v, b, d, ksb, kss, ksh,
                                             vsb, vss, vsh, s)
                         : launch<128, false>(p, q, k, v, b, d, ksb, kss,
                                              ksh, vsb, vss, vsh, s);
    default: return cudaErrorInvalidValue;
  }
}

// Query heads of one KV group per work item: the largest power of two that
// divides Hq / Hkv, at most 16.
int heads_per_item(int hq, int hkv) {
  int gp = 1;
  while (gp < 16 && (hq / hkv) % (2 * gp) == 0) gp *= 2;
  return gp;
}

void fill(Params& p, void* out, const int* kv_len, int b, int sq, int skv,
          int hq, int hkv, int causal, int q_offset, int kv_len_default,
          float softcap, float scale) {
  p.out = static_cast<__nv_bfloat16*>(out);
  p.kv_len = kv_len;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.gp = heads_per_item(hq, hkv);
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_len_default = kv_len_default;
  p.softcap = softcap;
  p.scale = scale;
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, const int* kv_len,
    int b, int sq, int skv, int hq, int hkv, int d, int ksb, int kss, int ksh,
    int vsb, int vss, int vsh, int causal, int q_offset, int kv_len_default,
    float softcap, float scale, void* stream) {
  if (sq == 0 || b == 0) return 0;
  Params p{};
  fill(p, out, kv_len, b, sq, skv, hq, hkv, causal, q_offset, kv_len_default,
       softcap, scale);
  return static_cast<int>(dispatch(p, q, k, v, d, ksb, kss, ksh, vsb, vss,
                                   vsh, static_cast<cudaStream_t>(stream)));
}

// The training forward: causal self-attention over contiguous q (B, S, Hq,
// D), k and v (B, S, Hkv, D), q_offset 0, every key valid; writes out and
// the rows' log-sum-exp lse (B, Hq, S, fp32).
extern "C" int flash_attention_train_launch(
    const void* q, const void* k, const void* v, void* out, float* lse, int b,
    int s, int hq, int hkv, int d, float softcap, float scale, void* stream) {
  if (s == 0 || b == 0) return 0;
  TrainParams p{};
  fill(p, out, nullptr, b, s, s, hq, hkv, 1, 0, s, softcap, scale);
  p.lse = lse;
  const int kss = hkv * d, ksb = s * kss;
  return static_cast<int>(dispatch(p, q, k, v, d, ksb, kss, d, ksb, kss, d,
                                   static_cast<cudaStream_t>(stream)));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
