// The backward of causal flash attention for Hopper (sm_90a), bf16 in and
// out.
//
// Replaces no TPU kernel: the reference trains through the jnp
// flash_attention of src/repro/models/layers.py, which JAX differentiates,
// and has no backward kernel.  The port's training forward is the
// hand-written kernel of flash_attention.cu, which autograd cannot see
// through, so its backward is this kernel (the VJP of that attention, with
// the reference's repeat_kv folded in: query head h reads KV head
// h / (Hq / Hkv), and dK, dV sum over the group's query heads).
//
// The contract is the training call's: causal, q_offset 0, every key
// valid.  q, o, dO and dq are (B, S, Hq, D); k, v, dk and dv (B, S, Hkv,
// D); all bf16 and contiguous; lse (B, Hq, S) fp32 is the forward's m + log
// l.  The math is the standard recomputation: delta = rowsum(dO o O) in
// fp32; s = q.k scale (then cap tanh(s / cap) with a softcap); P = exp(s -
// lse); dV = P^T dO with P rounded to bf16 as the forward rounds it; dP =
// dO V^T; dS = P o (dP - delta), times 1 - (s / cap)^2 with a softcap;
// dQ = dS K scale; dK = dS^T Q scale.  Products take bf16 operands (dS
// rounded to bf16) and sum in fp32.
//
// What bounds it on this card: per visible (query, key) pair it does 5
// products of D multiply-adds (S, dP and dV, dQ, dK; 10 D flops, 2.5 times
// the forward's 4 D), about S^2 / 2 pairs per head, against one read of
// q, k, v, o, dO and one write of dq, dk, dv: at the training shapes (S =
// 2048, D = 128) the bf16 tensor cores bound it, not the memory.
//
// Head dims 64 and 128 (every published config's) take the Hopper design,
// three launches on the caller's stream:
// * prep: delta = rowsum(dO o O) and lse log2(e), one group of D / 8 lanes
//   per (b, s, h) row, into (B, Hq, Sp) rows padded to whole 64-row tiles
//   (zeros past S); it also zeroes the dQ ordering counters.
// * main (dkdvq_kernel): one CTA of 384 threads per work item, one 128-key
//   tile of one (batch row, KV head); one CTA fits an SM.  A CTA takes its
//   item from a global counter when it starts, not from blockIdx, so an
//   item is only ever taken after every item numbered before it.  Items
//   are numbered by super-group (a batch row's KV heads cg at a time, with
//   cg x key tiles <= 64), then key tile, then KV head, and each walks its
//   query tiles from the last down to its key tile's first (the group's
//   query heads fastest): the CTAs that run at once work on the same query
//   tiles of one or two super-groups, so the Q, dO and dQ-accumulator
//   tiles they share are read from L2, not from device memory (items
//   numbered by key tile over the whole batch, heaviest first, streamed
//   them from device memory).  Three warpgroups:
//   - warpgroup 2, the loads (setmaxnreg down to 24): one thread loads the
//     item's K and V tiles once by TMA, then streams each step's Q and dO
//     tiles (TMA, 128-byte swizzle) and lse and delta rows (bulk copies)
//     into a two-stage ring with full and empty mbarriers; a second thread
//     is the dQ writer (below).
//   - warpgroups 0 and 1, the math (setmaxnreg up to 240), 64 keys each.
//     S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 from shared memory
//     (K, V, Q, dO K-major); P^T and dS^T are made in registers (the mask
//     only on tiles the diagonal or S cuts) and rounded to bf16 in place,
//     which is the A-fragment layout of wgmma with A in registers, so
//     dV += P^T dO and dK += dS^T Q are wgmma m64nDk16 with dO and Q as
//     MN-major B operands.  dK and dV stay in registers over the whole
//     walk and are written once (dK times the scale).
//   - dQ, fused: each warpgroup also stores its dS^T (bf16, 128-byte
//     swizzle) into a 128 x 64 tile in shared memory (two buffers,
//     alternating by step); once both halves are in (a named barrier),
//     warpgroup w forms columns [w D / 2, (w + 1) D / 2) of the step's
//     64 x D partial dQ = dS K as wgmma m64n(D/2)k16 with dS^T and K both
//     MN-major (K is loaded in sub-tiles of D / 2 columns for this: 128-
//     byte swizzle at D = 128, 64-byte at D = 64).  It is issued before dK,
//     so the partial is stored to shared memory (fragment order, fp32,
//     16-byte stores, no bank conflict; two buffers) while dK runs, and
//     the dQ writer adds it to the fp32 accumulator (B, Hq, nq, 64 D), one
//     contiguous block per query tile in that same order, with one bulk
//     reduce-add.
// * post (dq_out_kernel): dq = bf16(accumulator x scale), one CTA per query
//   tile, through shared memory back to (B, S, Hq, D) rows.  It is a
//   programmatic dependent launch of main, whose CTAs signal it when they
//   start, so it runs on the SMs main's tail leaves idle; each CTA waits
//   for its tile's counter to hold every key tile's add.
// Determinism: no unordered atomics.  Query tile i of head h receives one
// partial from each key tile j <= i / 2, and they are added in increasing
// j: the writer of key tile j waits until the tile's counter reads j (an
// acquire load), adds (key tile 0 stores instead, so the accumulator needs
// no zeroing), waits for the bulk operation to complete and bumps the
// counter with a release add.  Key tile j - 1 of the same (batch, KV head)
// is numbered before j, so it was taken by a running CTA that waits only
// on items numbered before its own: no wait can deadlock
// (check_runs.fb_schedule models this schedule).  Every wgmma sums in a
// fixed order, so two runs agree bit for bit.
// Budget per instance, shared memory (K, V, the Q and dO rings, two dS^T
// and two dQ partial buffers, the lse and delta rows, barriers and
// alignment): D = 128, 231,552 bytes; D = 64, 133,248.  Registers: the
// math warpgroups hold dK and dV (D / 2 each), S^T and dP^T (32 each)
// while P^T and dS^T are made, then the bf16 P^T and dS^T (16 each) and
// the dQ partial (D / 4); the first k-step of each fresh accumulator
// writes it without reading it, so S^T and dP^T are not live across
// steps (ptxas: no spill).
//
// Head dims 16 and 32 (only the smoke configs') keep the first design,
// three launches with bf16 mma.sync m16n8k16 tiles:
// * delta: one thread per (b, s, h) row.
// * dK/dV: one CTA of four warps per (batch, KV head, 64-key tile).  Each
//   warp owns 16 keys; the CTA keeps the K and V tile in shared memory and
//   walks the group's query heads and, for each, the 64-row query tiles at
//   or past its first key, loading each tile's Q, dO, lse and delta.
//   S^T = K Q^T and dP^T = V dO^T are mma.sync m16n8k16 (fp32
//   accumulators); P^T and dS^T go from the accumulator layout straight
//   into the A fragments of dV += P^T dO and dK += dS^T Q.  dK and dV
//   stay in registers over the whole walk and are written once.
// * dQ: one CTA of four warps per (batch, query head, 64-row tile), each
//   warp 16 rows, walking the key tiles up to the diagonal: S = Q K^T,
//   dP = dO V^T, dS, then dQ += dS K, in registers, written once.
// Tiles are loaded by all threads with 16-byte loads into shared memory
// rows padded by 16 bytes (so ldmatrix's eight rows fall in distinct
// banks), then read as fragments with ldmatrix (.trans where the operand's
// contraction runs along the rows).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// ---------------------------------------------------------------------------
// Head dims 64 and 128: wgmma, a TMA ring, dQ fused in a fixed order
// ---------------------------------------------------------------------------

constexpr int HK = 128;           // keys per work item: two warpgroups of 64
constexpr int HQ = 64;            // query rows per step
constexpr int RING = 2;           // Q / dO ring depth
constexpr int HTHREADS = 384;     // math: warps 0-7; loads, dQ writer: 8-11
constexpr int LOAD_REGS = 24, MMA_REGS = 240;

struct BwdParams {
  CUtensorMap q_map, k_map, v_map, do_map;
  const float* lse2;              // (B, Hq, Sp): lse log2(e), 0 past S
  const float* delta;             // (B, Hq, Sp): rowsum(dO o O), 0 past S
  float* acc;                     // (B, Hq, nq, 64 D): dQ sums in fragment
                                  // order
  unsigned* counters;             // (B, Hq, nq): adds done; then the work
                                  // counter
  __nv_bfloat16 *dk, *dv;
  int b, s, hq, hkv, nq, sp;      // nq query tiles, Sp = 64 nq rows
  int nkt, cg;                    // key tiles; KV heads a super-group
  float softcap, scale;
};

// Shared-memory layout (bytes from a 1024-aligned base) for head dim D.
// V, Q, dO and dS^T are sub-tiles of 64 columns (128-byte rows, 128-byte
// swizzle); K is two sub-tiles of D / 2 columns, one per warpgroup's dQ.
template <int D>
struct HLayout {
  static constexpr int DSK = D / 2;                 // K sub-tile columns
  static constexpr int ROWK = DSK * 2;              // bytes per K row
  static constexpr uint32_t SWK = DSK == 64 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr int KV_BYTES = HK * D * 2;       // the K or V tile
  static constexpr int QT_BYTES = HQ * D * 2;       // one Q or dO tile
  static constexpr int DS_BYTES = HK * HQ * 2;      // one dS^T buffer
  static constexpr int DQ_BYTES = HQ * D * 4;       // the dQ partial
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;        // + stage * QT_BYTES
  static constexpr int DO_OFF = Q_OFF + RING * QT_BYTES;
  static constexpr int DS_OFF = DO_OFF + RING * QT_BYTES;
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;  // + buffer * DQ_BYTES
  static constexpr int ROWS_OFF = DQ_OFF + 2 * DQ_BYTES;  // + stage * 512: lse,
  static constexpr int BAR_OFF = ROWS_OFF + RING * 512;   // then delta
  static constexpr int BYTES = BAR_OFF + 128 + 1024;  // + alignment slack
};

// The work item numbered u: super-group (batch row, then cg KV heads)
// slowest, then key tile j, then the KV head in the super-group.
struct BwdItem {
  int j, bi, hk;
};

__device__ __forceinline__ BwdItem bwd_item(const BwdParams& p, int u) {
  const int per = p.nkt * p.cg, sg = u / per, r = u % per;
  const int sgs = p.hkv / p.cg;                     // super-groups a row
  return {r / p.cg, sg / sgs, (sg % sgs) * p.cg + r % p.cg};
}

// 64 x N (fp32) = / += A (64 x 16, bf16, shared) * B (16 x N, bf16,
// shared), for N = 64 and 32; TA / TB: A / B MN-major.  The overwriting
// form (ACC false) does not read D, so D is not kept live before it.
template <bool ACC, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
#define WG_N64_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
#define WG_N64_D(c)                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), \
  c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),     \
  c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),   \
  c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),   \
  c(d[29]), c(d[30]), c(d[31])
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_N64_REGS
        : WG_N64_D("+f")
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_N64_REGS
        : WG_N64_D("=f")
        : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
#undef WG_N64_REGS
#undef WG_N64_D
}

template <bool ACC, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
#define WG_N32_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
#define WG_N32_D(c)                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), \
  c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),     \
  c(d[15])
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_N32_REGS
        : WG_N32_D("+f")
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_N32_REGS
        : WG_N32_D("=f")
        : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
#undef WG_N32_REGS
#undef WG_N32_D
}

template <int N, bool ACC, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_ss_n64<ACC, TA, TB>(d, da, db);
  else wgmma_ss_n32<ACC, TA, TB>(d, da, db);
}

// Contiguous bytes global -> shared, completing on an mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Contiguous fp32 shared -> global, stored or added, in a bulk group.
template <bool ADD>
__device__ __forceinline__ void bulk_out(float* dst, uint32_t src,
                                         int bytes) {
  if constexpr (ADD)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;\n"
        :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                 "%2;\n" :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the counter reads want (acquire); traps after ~2^33 cycles.
__device__ __forceinline__ void wait_count(const unsigned* ctr,
                                           unsigned want) {
  long long start = 0;
  while (true) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(ctr) : "memory");
    if (v == want) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 33)) asm volatile("trap;");
  }
}

// delta and lse log2(e) into rows padded to Sp (zeros past S), one group of
// D / 8 lanes per (b, s, h) row of o and dO; the first n_ctr threads zero
// the counters.
template <int D>
__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout,
            const float* lse, float* lse2, float* delta, unsigned* counters,
            int n_ctr, int b, int s, int sp, int hq) {
  constexpr int G = D / 8;                        // lanes per row
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i < n_ctr) counters[i] = 0u;
  const long long row = i / G;                    // (b, pos, h), pos < Sp
  const int part = static_cast<int>(i % G), h = static_cast<int>(row % hq);
  const long long bs = row / hq;
  const int pos = static_cast<int>(bs % sp), bi = static_cast<int>(bs / sp);
  const bool in = bi < b, real = in && pos < s;
  float acc = 0.f;
  if (real) {
    const size_t off = ((static_cast<size_t>(bi) * s + pos) * hq + h) * D
                       + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(a2[k]), y = __bfloat1622float2(g2[k]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int m = G / 2; m > 0; m /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (in && part == 0) {
    const size_t r = (static_cast<size_t>(bi) * hq + h) * sp + pos;
    delta[r] = acc;
    lse2[r] = real ? lse[(static_cast<size_t>(bi) * hq + h) * s + pos] * LOG2E
                   : 0.f;
  }
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(HTHREADS, 1)
dkdvq_kernel(const __grid_constant__ BwdParams p) {
  using L = HLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::BAR_OFF;          // K and V loaded
  const uint32_t bar_full = bar_kv + 8;               // + 8 stage: loaded
  const uint32_t bar_empty = bar_full + 8 * RING;     // + 8 stage: released
  const uint32_t bar_dq_full = bar_empty + 8 * RING;  // + 8 buffer: partial
  const uint32_t bar_dq_empty = bar_dq_full + 16;     // stored, read out
  int* item_slot = reinterpret_cast<int*>(smem + L::BAR_OFF + 80);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);              // one per warpgroup
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_dq_full + 8 * s, 256);          // every math thread
      mbar_init(bar_dq_empty + 8 * s, 1);           // the dQ writer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *item_slot = static_cast<int>(
        atomicAdd(p.counters + static_cast<size_t>(p.b) * p.hq * p.nq, 1u));
  }
  __syncthreads();
  // every CTA has its item: the dq pass may be scheduled on SMs that free up
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const BwdItem it = bwd_item(p, *item_slot);
  const int group = p.hq / p.hkv, key0 = it.j * HK, q_first = key0 / HQ;

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(LOAD_REGS));
    if (warp == 8 && lane == 0) {
      // ---- loads: K and V once, then the ring of Q, dO, lse, delta -----
      mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
      for (int s = 0; s < 2; ++s)
        tma_load(base + L::K_OFF + s * HK * L::ROWK, &p.k_map, bar_kv,
                 s * L::DSK, it.hk, key0, it.bi);
      for (int s = 0; s < D / 64; ++s)
        tma_load(base + L::V_OFF + s * HK * 128, &p.v_map, bar_kv, s * 64,
                 it.hk, key0, it.bi);
      int n = 0;
      for (int qi = p.nq - 1; qi >= q_first; --qi) {
        for (int hg = 0; hg < group; ++hg, ++n) {
          const int h = it.hk * group + hg;
          const size_t rows = (static_cast<size_t>(it.bi) * p.hq + h) * p.sp;
          const int st = n % RING;
          if (n >= RING) mbar_wait(bar_empty + 8 * st, (n / RING - 1) & 1);
          const uint32_t full = bar_full + 8 * st;
          mbar_expect_tx(full, 2 * L::QT_BYTES + 2 * HQ * 4);
          for (int s = 0; s < D / 64; ++s) {
            const uint32_t off = st * L::QT_BYTES + s * HQ * 128;
            tma_load(base + L::Q_OFF + off, &p.q_map, full, s * 64, h,
                     qi * HQ, it.bi);
            tma_load(base + L::DO_OFF + off, &p.do_map, full, s * 64, h,
                     qi * HQ, it.bi);
          }
          const uint32_t r = base + L::ROWS_OFF + st * 512;
          bulk_load(r, p.lse2 + rows + qi * HQ, HQ * 4, full);
          bulk_load(r + 256, p.delta + rows + qi * HQ, HQ * 4, full);
        }
      }
    } else if (warp == 9 && lane == 0) {
      // ---- the dQ writer: each step's partial into the accumulator, in
      // key-tile order per query tile (see the top) ----------------------
      int n = 0;
      for (int qi = p.nq - 1; qi >= q_first; --qi) {
        for (int hg = 0; hg < group; ++hg, ++n) {
          const int h = it.hk * group + hg;
          const size_t t = (static_cast<size_t>(it.bi) * p.hq + h) * p.nq
                           + qi;
          unsigned* ctr = p.counters + t;
          float* dst = p.acc + t * (HQ * D);
          const int b2 = n & 1;
          const uint32_t src = base + L::DQ_OFF + b2 * L::DQ_BYTES;
          mbar_wait(bar_dq_full + 8 * b2, (n >> 1) & 1);
          if (it.j > 0) {
            wait_count(ctr, it.j);
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            bulk_out<true>(dst, src, L::DQ_BYTES);
          } else {
            bulk_out<false>(dst, src, L::DQ_BYTES);
          }
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(bar_dq_empty + 8 * b2);
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                       :: "l"(ctr) : "memory");
        }
      }
    }
  } else {
    // ---- math: warpgroup wg owns keys key0 + 64 wg .. + 63 --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(MMA_REGS));
    const int wg = warp >> 2, tw = tid & 127;
    const int g = lane >> 2, c = 2 * (lane & 3);
    const int r0 = 64 * wg + 16 * (warp & 3) + g;   // tile rows r0, r0 + 8
    const int kr0 = key0 + r0;                      // their keys
    const uint32_t ka = base + L::K_OFF, va = base + L::V_OFF;
    float dk[D / 2], dv[D / 2], st[32], dpt[32], dq[D / 4];
    uint32_t pa[4][4], da[4][4];                    // P^T, dS^T: A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(bar_kv, 0);

    int n = 0;
    for (int qi = p.nq - 1; qi >= q_first; --qi) {
      for (int hg = 0; hg < group; ++hg, ++n) {
        const int rs = n % RING, q0 = qi * HQ;
        const uint32_t qa = base + L::Q_OFF + rs * L::QT_BYTES;
        const uint32_t doa = base + L::DO_OFF + rs * L::QT_BYTES;
        const float* lse = reinterpret_cast<const float*>(
            smem + L::ROWS_OFF + rs * 512);
        const float* dlt = lse + HQ;
        mbar_wait(bar_full + 8 * rs, (n / RING) & 1);

        // S^T = K Q^T, dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ks = kk * 16 / L::DSK, kc = (kk * 16 % L::DSK) * 2;
          const int qs = kk * 16 / 64, qc = (kk * 16 % 64) * 2;
          const uint64_t a = desc(ka + ks * HK * L::ROWK + 64 * wg * L::ROWK
                                  + kc, 16, 8 * L::ROWK, L::SWK);
          const uint64_t b = desc(qa + qs * HQ * 128 + qc, 16, 1024, 1);
          if (kk == 0) wgmma_ss_n64<false, 0, 0>(st, a, b);
          else wgmma_ss_n64<true, 0, 0>(st, a, b);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int qs = kk * 16 / 64, qc = (kk * 16 % 64) * 2;
          const uint64_t a = desc(va + qs * HK * 128 + 64 * wg * 128 + qc, 16,
                                  1024, 1);
          const uint64_t b = desc(doa + qs * HQ * 128 + qc, 16, 1024, 1);
          if (kk == 0) wgmma_ss_n64<false, 0, 0>(dpt, a, b);
          else wgmma_ss_n64<true, 0, 0>(dpt, a, b);
        }
        wgmma_commit();

        // P^T (into st) while dP^T runs; with a softcap dS^T needs the
        // cap's factor, so both wait and dS^T is made in the same pass.
        // The thread holds keys kr0 (+ 8) and queries q0 + 8 j + c (+ 1).
        wgmma_wait<SOFTCAP ? 0 : 1>();
        fence_regs(st);
        if constexpr (SOFTCAP) fence_regs(dpt);
        auto probs = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(
                lse + 8 * j + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int query = q0 + 8 * j + c + (e & 1);
              const bool vis = !decltype(masked)::value
                               || (query >= kr0 + (e & 2) * 4 && query < p.s);
              const float le = e & 1 ? l2.y : l2.x;
              if constexpr (SOFTCAP) {
                const float t = tanhf(st[4 * j + e] * p.scale / p.softcap);
                const float pe = vis ? ex2(t * p.softcap * LOG2E - le) : 0.f;
                dpt[4 * j + e] = pe * (dpt[4 * j + e]
                                       - dlt[8 * j + c + (e & 1)])
                                 * (1.f - t * t);
                st[4 * j + e] = pe;
              } else {
                st[4 * j + e] = vis ? ex2(fmaf(st[4 * j + e],
                                               p.scale * LOG2E, -le)) : 0.f;
              }
            }
          }
        };
        // every pair of the warpgroup's 64 x 64 tile visible: no mask
        if (q0 >= key0 + 64 * wg + 63 && q0 + HQ <= p.s)
          probs(std::false_type());
        else
          probs(std::true_type());
        if constexpr (!SOFTCAP) {
          wgmma_wait<0>();
          fence_regs(dpt);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 d2 = *reinterpret_cast<const float2*>(
                dlt + 8 * j + c);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] = st[4 * j + e]
                               * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x));
          }
        }
        // chunk j holds queries 8 j .. 8 j + 7: k-step j / 2
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pa[j / 2][2 * (j & 1)] = pack_bf16(st[4 * j], st[4 * j + 1]);
          pa[j / 2][2 * (j & 1) + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
          da[j / 2][2 * (j & 1)] = pack_bf16(dpt[4 * j], dpt[4 * j + 1]);
          da[j / 2][2 * (j & 1) + 1] =
              pack_bf16(dpt[4 * j + 2], dpt[4 * j + 3]);
        }

        // dV += P^T dO (dO MN-major); dS^T into this step's buffer (row r,
        // 16-byte chunk j ^ (r & 7)) and, once both halves are in, dQ
        // (64 x D / 2 of this warpgroup) = dS K, dS^T and K MN-major; then
        // dK += dS^T Q (Q MN-major), which runs while the dQ partial is
        // stored
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HQ / 16; ++kk)
          wgmma_rs<D>(dv, pa[kk], desc(doa + kk * 16 * 128, HQ * 128, 1024, 1));
        wgmma_commit();
        const uint32_t dsa = base + L::DS_OFF + (n & 1) * L::DS_BYTES;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            asm volatile("st.shared.u32 [%0], %1;\n"
                         :: "r"(dsa + (r0 + 8 * h2) * 128 + ((j ^ g) << 4)
                                + 2 * c),
                            "r"(da[j / 2][2 * (j & 1) + h2]) : "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HK / 16; ++kk) {
          const uint64_t a = desc(dsa + kk * 16 * 128, HK * 128, 1024, 1);
          const uint64_t b = desc(ka + wg * HK * L::ROWK + kk * 16 * L::ROWK,
                                  HK * L::ROWK, 8 * L::ROWK, L::SWK);
          if (kk == 0) wgmma_ss<D / 2, false, 1, 1>(dq, a, b);
          else wgmma_ss<D / 2, true, 1, 1>(dq, a, b);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HQ / 16; ++kk)
          wgmma_rs<D>(dk, da[kk], desc(qa + kk * 16 * 128, HQ * 128, 1024, 1));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dv);
        fence_regs(dq);
        fence_regs(pa);

        // the partial in fragment order, in buffer n & 1: float4 (wg, j,
        // tw) holds rows 16 (tw / 32) + (tw % 32) / 4 (+ 8), columns
        // wg D / 2 + 8 j + 2 (tw % 4) (+ 1)
        const int b2 = n & 1;
        if (n >= 2) mbar_wait(bar_dq_empty + 8 * b2, ((n >> 1) - 1) & 1);
        float4* sdq = reinterpret_cast<float4*>(smem + L::DQ_OFF
                                                + b2 * L::DQ_BYTES);
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          sdq[(wg * (D / 16) + j) * 128 + tw] =
              make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2],
                          dq[4 * j + 3]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(bar_dq_full + 8 * b2);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(da);
        if (tw == 0) mbar_arrive(bar_empty + 8 * rs);
      }
    }

    // rows r0 and r0 + 8, columns 8 j + c (+ 1)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int key = kr0 + 8 * h2;
      if (key >= p.s) continue;
      const size_t off = ((static_cast<size_t>(it.bi) * p.s + key) * p.hkv
                          + it.hk) * D + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(p.dk + off + 8 * j) =
            pack_bf16(dk[4 * j + 2 * h2] * p.scale,
                      dk[4 * j + 2 * h2 + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + off + 8 * j) =
            pack_bf16(dv[4 * j + 2 * h2], dv[4 * j + 2 * h2 + 1]);
      }
    }
  }
}

// dq = bf16(accumulator x scale) for one (query tile, head, batch row):
// the fragment-ordered block through shared memory back to rows.  It is a
// programmatic dependent launch of the main kernel, so its CTAs run on the
// SMs the main kernel's tail leaves idle; each waits (acquire) until its
// tile's counter has every key tile's add.  CTA v takes tiles in the
// order they complete: super-group, then query tile from the last, then
// head.
template <int D>
__global__ void __launch_bounds__(256)
dq_out_kernel(const float* acc, const unsigned* counters, __nv_bfloat16* dq,
              int s, int hq, int hkv, int nq, int nkt, int cg, float scale) {
  __shared__ float tile[HQ][D + 8];
  const int group = hq / hkv, per = nq * cg * group, sgs = hkv / cg;
  const int sg = blockIdx.x / per, rem = blockIdx.x % per;
  const int bi = sg / sgs, qi = nq - 1 - rem / (cg * group);
  const int h = (sg % sgs) * cg * group + rem % (cg * group);
  const size_t tile_at = (static_cast<size_t>(bi) * hq + h) * nq + qi;
  if (threadIdx.x == 0)
    wait_count(counters + tile_at, min(qi / 2, nkt - 1) + 1);
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(
      acc + tile_at * (HQ * D));
  for (int i = threadIdx.x; i < HQ * D / 4; i += 256) {
    const float4 v = src[i];
    const int t = i % 128, j = (i / 128) % (D / 16), w = i / (128 * (D / 16));
    const int r = 16 * (t >> 5) + ((t & 31) >> 2);
    const int col = w * (D / 2) + 8 * j + 2 * (t & 3);
    *reinterpret_cast<float2*>(&tile[r][col]) = make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(&tile[r + 8][col]) = make_float2(v.z, v.w);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HQ * D / 8; i += 256) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8, pos = qi * HQ + r;
    if (pos >= s) continue;
    uint4 out;
    uint32_t* o32 = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o32[k] = pack_bf16(tile[r][c8 + 2 * k] * scale,
                         tile[r][c8 + 2 * k + 1] * scale);
    *reinterpret_cast<uint4*>(
        dq + ((static_cast<size_t>(bi) * s + pos) * hq + h) * D + c8) = out;
  }
}

template <int D, bool SOFTCAP>
cudaError_t launch_hopper(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* work, unsigned* counters, void* dq, void* dk,
                          void* dv, int b, int s, int hq, int hkv,
                          float softcap, float scale, cudaStream_t stream) {
  using L = HLayout<D>;
  BwdParams p{};
  p.b = b;
  p.s = s;
  p.hq = hq;
  p.hkv = hkv;
  p.nq = (s + HQ - 1) / HQ;
  p.sp = p.nq * HQ;
  p.nkt = (s + HK - 1) / HK;
  // KV heads a super-group: the most that divide Hkv with at most ~64
  // items a super-group
  p.cg = 1;
  for (int c = 2; c <= hkv; ++c)
    if (hkv % c == 0 && c * p.nkt <= 64) p.cg = c;
  p.softcap = softcap;
  p.scale = scale;
  p.softcap = softcap;
  p.scale = scale;
  const long long rows = static_cast<long long>(b) * hq * p.sp;
  float* lse2 = work;
  p.lse2 = lse2;
  p.delta = work + rows;
  p.acc = work + 2 * rows;
  p.counters = counters;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const long long qs = static_cast<long long>(hq) * D,
                  ks = static_cast<long long>(hkv) * D;
  if (!make_map(&p.q_map, q, D, hq, s, b, D, qs, s * qs, 64, 1, HQ)
      || !make_map(&p.do_map, dout, D, hq, s, b, D, qs, s * qs, 64, 1, HQ)
      || !make_map(&p.k_map, k, D, hkv, s, b, D, ks, s * ks, L::DSK, 1, HK)
      || !make_map(&p.v_map, v, D, hkv, s, b, D, ks, s * ks, 64, 1, HK))
    return cudaErrorInvalidValue;
  static bool sized = false;      // per instantiation: above 48 KB opt-in
  if (!sized) {
    const cudaError_t err = set_smem(dkdvq_kernel<D, SOFTCAP>, L::BYTES);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int n_ctr = b * hq * p.nq + 1;
  const long long threads = rows * (D / 8);
  prep_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                   stream>>>(static_cast<const __nv_bfloat16*>(o),
                             static_cast<const __nv_bfloat16*>(dout), lse,
                             lse2, work + rows, counters, n_ctr, b, s, p.sp,
                             hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items = p.nkt * b * hkv;
  dkdvq_kernel<D, SOFTCAP><<<items, HTHREADS, L::BYTES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * hq * p.nq));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dq_out_kernel<D>,
                           static_cast<const float*>(p.acc),
                           static_cast<const unsigned*>(counters),
                           static_cast<__nv_bfloat16*>(dq), s, hq, hkv, p.nq,
                           p.nkt, p.cg, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims 16 and 32: the first design, mma.sync
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;      // four warps of 16 rows each
constexpr int BK = 64;            // keys per tile (dK/dV: per CTA)
constexpr int BM = 64;            // query rows per CTA of the dQ kernel
constexpr int BQ = 64;            // dK/dV: rows per query tile

struct Params {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;                   // (B, Hq, S)
  __nv_bfloat16 *dq, *dk, *dv;
  int b, s, hq, hkv;
  float softcap, scale;
};

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;                // padded row, elements
};

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The fragments of one lane, for a tile stored row-major in shared memory
// at base with LD elements a row:
// the A fragment (16 x 16) at (row0, col0);
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t base,
                                       int row0, int col0, int lane) {
  ldsm(a, base + ((row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8) * 2);
}

// the B fragments of two n8 tiles (n0, n0 + 8), k from k0, of a B stored
// as [n][k] (k contiguous): b[0], b[1] for n0 and b[2], b[3] for n0 + 8;
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], uint32_t base,
                                          int n0, int k0, int lane) {
  ldsm(b, base + ((n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0
                  + ((lane >> 3) & 1) * 8) * 2);
}

// the same of a B stored as [k][n] (n contiguous), through the transpose.
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], uint32_t base,
                                          int k0, int n0, int lane) {
  ldsm_t(b, base + ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0
                    + (lane >> 4) * 8) * 2);
}

// Rows [r0, r0 + n) of head h of a (B, S, H, D) tensor into shared memory
// (LD elements a row), zeros past S.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int bi,
                                          int r0, int n, int s, int heads,
                                          int h) {
  constexpr int CH = D / 8;                       // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8, pos = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < s)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(bi) * s + pos) * heads + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * Cfg<D>::LD + c) = val;
  }
}

// P from a score (times the scale, then capped): exp(s - lse), 0 where
// masked; with a softcap also the factor 1 - (s / cap)^2 of dS.
template <bool SOFTCAP>
__device__ __forceinline__ float prob(float x, float lse, bool vis,
                                      const Params& p, float& f) {
  x *= p.scale;
  if constexpr (SOFTCAP) {
    const float t = tanhf(x / p.softcap);
    x = t * p.softcap;
    f = 1.f - t * t;
  }
  return vis ? exp2f((x - lse) * LOG2E) : 0.f;
}

// delta = rowsum(dO o O) in fp32, one thread per (b, s, h) row.
template <int D>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const __grid_constant__ Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * THREADS
                        + threadIdx.x;
  if (row >= static_cast<long long>(p.b) * p.s * p.hq) return;
  const uint4* o = reinterpret_cast<const uint4*>(p.o + row * D);
  const uint4* g = reinterpret_cast<const uint4*>(p.dout + row * D);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = o[c], b = g[c];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]), y = __bfloat1622float2(b2[j]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  const int h = static_cast<int>(row % p.hq);
  const long long bs = row / p.hq;
  const int pos = static_cast<int>(bs % p.s), bi = static_cast<int>(bs / p.s);
  p.delta[(static_cast<long long>(bi) * p.hq + h) * p.s + pos] = acc;
}

// dK and dV of one (batch, KV head, 64-key tile).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const __grid_constant__ Params p) {
  constexpr int LD = Cfg<D>::LD;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sk + BK * LD;
  __nv_bfloat16* sq = sv + BK * LD;
  __nv_bfloat16* sdo = sq + BQ * LD;
  float* slse = reinterpret_cast<float*>(sdo + BQ * LD);
  float* sdelta = slse + BQ;
  const uint32_t ak = smem_u32(sk), av = smem_u32(sv), aq = smem_u32(sq),
                 ado = smem_u32(sdo);

  const int key0 = blockIdx.x * BK, hk = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, kw = 16 * warp;   // warp's keys
  const int group = p.hq / p.hkv;
  load_rows<D>(sk, p.k, bi, key0, BK, p.s, p.hkv, hk);
  load_rows<D>(sv, p.v, bi, key0, BK, p.s, p.hkv, hk);

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int hg = 0; hg < group; ++hg) {
    const int h = hk * group + hg;
    const float* lse_h = p.lse + (static_cast<size_t>(bi) * p.hq + h) * p.s;
    const float* delta_h = p.delta + (static_cast<size_t>(bi) * p.hq + h)
                                         * p.s;
    for (int q0 = key0; q0 < p.s; q0 += BQ) {     // causal: queries >= keys
      __syncthreads();                            // the last tile is read
      load_rows<D>(sq, p.q, bi, q0, BQ, p.s, p.hq, h);
      load_rows<D>(sdo, p.dout, bi, q0, BQ, p.s, p.hq, h);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < p.s;
        slse[i] = in ? lse_h[q0 + i] : 0.f;
        sdelta[i] = in ? delta_h[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
      float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], av4[4];
        frag_a<LD>(a, ak, kw, 16 * kk, lane);
        frag_a<LD>(av4, av, kw, 16 * kk, lane);
#pragma unroll
        for (int nj = 0; nj < BQ / 16; ++nj) {
          uint32_t b[4];
          frag_b_nk<LD>(b, aq, 16 * nj, 16 * kk, lane);
          mma(st[2 * nj], a, b[0], b[1]);
          mma(st[2 * nj + 1], a, b[2], b[3]);
          frag_b_nk<LD>(b, ado, 16 * nj, 16 * kk, lane);
          mma(dpt[2 * nj], av4, b[0], b[1]);
          mma(dpt[2 * nj + 1], av4, b[2], b[3]);
        }
      }

      // P^T and dS^T, each thread's keys kw + g (+ 8) and queries 8 j +
      // 2 t (+ 1)
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        float pe[4], de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          const int key = key0 + kw + g + (e >= 2 ? 8 : 0), query = q0 + qc;
          float f = 1.f;
          pe[e] = prob<SOFTCAP>(st[j][e], slse[qc],
                                query >= key && query < p.s, p, f);
          de[e] = pe[e] * (dpt[j][e] - sdelta[qc]);
          if constexpr (SOFTCAP) de[e] *= f;
        }
        pa[j / 2][2 * (j & 1)] = pack_bf16(pe[0], pe[1]);
        pa[j / 2][2 * (j & 1) + 1] = pack_bf16(pe[2], pe[3]);
        da[j / 2][2 * (j & 1)] = pack_bf16(de[0], de[1]);
        da[j / 2][2 * (j & 1) + 1] = pack_bf16(de[2], de[3]);
      }

      // dV += P^T dO, dK += dS^T Q: the contraction runs over the queries
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t b[4];
          frag_b_kn<LD>(b, ado, 16 * kq, 16 * nd, lane);
          mma(dv[2 * nd], pa[kq], b[0], b[1]);
          mma(dv[2 * nd + 1], pa[kq], b[2], b[3]);
          frag_b_kn<LD>(b, aq, 16 * kq, 16 * nd, lane);
          mma(dk[2 * nd], da[kq], b[0], b[1]);
          mma(dk[2 * nd + 1], da[kq], b[2], b[3]);
        }
      }
    }
  }

  // rows kw + g and kw + g + 8 of the tile, columns 8 nd + 2 t (+ 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + kw + g + 8 * half;
    if (key >= p.s) continue;
    const size_t off = ((static_cast<size_t>(bi) * p.s + key) * p.hkv + hk)
                       * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(p.dk + off + 8 * nd) =
          pack_bf16(dk[nd][2 * half] * p.scale,
                    dk[nd][2 * half + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + off + 8 * nd) =
          pack_bf16(dv[nd][2 * half], dv[nd][2 * half + 1]);
    }
  }
}

// dQ of one (batch, query head, 64-row tile).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __grid_constant__ Params p) {
  constexpr int LD = Cfg<D>::LD;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdo = sq + BM * LD;
  __nv_bfloat16* sk = sdo + BM * LD;
  __nv_bfloat16* sv = sk + BK * LD;
  const uint32_t aq = smem_u32(sq), ado = smem_u32(sdo), ak = smem_u32(sk),
                 av = smem_u32(sv);

  const int q0 = blockIdx.x * BM, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, qw = 16 * warp;   // warp's rows
  load_rows<D>(sq, p.q, bi, q0, BM, p.s, p.hq, h);
  load_rows<D>(sdo, p.dout, bi, q0, BM, p.s, p.hq, h);
  // the thread's two rows: lse and delta (0 past S, where nothing is kept)
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + qw + g + 8 * r;
    const size_t i = (static_cast<size_t>(bi) * p.hq + h) * p.s + pos;
    lse[r] = pos < p.s ? p.lse[i] : 0.f;
    delta[r] = pos < p.s ? p.delta[i] : 0.f;
  }

  float dq[D / 8][4] = {};
  const int last = min(q0 + BM, p.s);             // keys below this
  for (int k0 = 0; k0 < last; k0 += BK) {
    __syncthreads();                              // the last tile is read
    load_rows<D>(sk, p.k, bi, k0, BK, p.s, p.hkv, hk);
    load_rows<D>(sv, p.v, bi, k0, BK, p.s, p.hkv, hk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ag[4];
      frag_a<LD>(a, aq, qw, 16 * kk, lane);
      frag_a<LD>(ag, ado, qw, 16 * kk, lane);
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t b[4];
        frag_b_nk<LD>(b, ak, 16 * nj, 16 * kk, lane);
        mma(s[2 * nj], a, b[0], b[1]);
        mma(s[2 * nj + 1], a, b[2], b[3]);
        frag_b_nk<LD>(b, av, 16 * nj, 16 * kk, lane);
        mma(dp[2 * nj], ag, b[0], b[1]);
        mma(dp[2 * nj + 1], ag, b[2], b[3]);
      }
    }

    // dS, the thread's rows qw + g (+ 8) and keys 8 j + 2 t (+ 1)
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int query = q0 + qw + g + 8 * r, key = k0 + 8 * j + 2 * t
                                                     + (e & 1);
        float f = 1.f;
        const float pr = prob<SOFTCAP>(s[j][e], lse[r],
                                       key <= query && query < p.s, p, f);
        de[e] = pr * (dp[j][e] - delta[r]);
        if constexpr (SOFTCAP) de[e] *= f;
      }
      da[j / 2][2 * (j & 1)] = pack_bf16(de[0], de[1]);
      da[j / 2][2 * (j & 1) + 1] = pack_bf16(de[2], de[3]);
    }

    // dQ += dS K: the contraction runs over the keys
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b[4];
        frag_b_kn<LD>(b, ak, 16 * kq, 16 * nd, lane);
        mma(dq[2 * nd], da[kq], b[0], b[1]);
        mma(dq[2 * nd + 1], da[kq], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = q0 + qw + g + 8 * half;
    if (pos >= p.s) continue;
    const size_t off = ((static_cast<size_t>(bi) * p.s + pos) * p.hq + h) * D
                       + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(p.dq + off + 8 * nd) =
          pack_bf16(dq[nd][2 * half] * p.scale,
                    dq[nd][2 * half + 1] * p.scale);
  }
}

template <int D, bool SOFTCAP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = Cfg<D>::LD;
  constexpr int kv_bytes = (2 * BK + 2 * BQ) * LD * 2 + 2 * BQ * 4;
  constexpr int q_bytes = (2 * BM + 2 * BK) * LD * 2;
  static bool sized = false;      // per instantiation: above 48 KB opt-in
  if (!sized) {
    cudaError_t err = set_smem(dkdv_kernel<D, SOFTCAP>, kv_bytes);
    if (err == cudaSuccess) err = set_smem(dq_kernel<D, SOFTCAP>, q_bytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const long long rows = static_cast<long long>(p.b) * p.s * p.hq;
  delta_kernel<D><<<static_cast<unsigned>((rows + THREADS - 1) / THREADS),
                    THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<D, SOFTCAP><<<dim3((p.s + BK - 1) / BK, p.hkv, p.b), THREADS,
                            kv_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D, SOFTCAP><<<dim3((p.s + BM - 1) / BM, p.hq, p.b), THREADS,
                          q_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dq, dk, dv of causal attention (the contract above).  work is fp32
// scratch and counters int32 scratch, sized by the caller: at D = 64 and
// 128, work holds 2 + D floats per (b, h, row) of Sp = 64 ceil(S / 64)
// rows (lse log2(e), delta, the dQ accumulator) and counters B Hq Sp / 64
// + 1 words; at D = 16 and 32, work is delta (B, Hq, S) and counters is
// unused.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* work, unsigned* counters,
    void* dq, void* dk, void* dv, int b, int s, int hq, int hkv, int d,
    float softcap, float scale, void* stream) {
  if (s == 0 || b == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (d == 64 || d == 128) {
    cudaError_t err;
    if (d == 64)
      err = cap ? launch_hopper<64, true>(q, k, v, o, dout, lse, work,
                                          counters, dq, dk, dv, b, s, hq, hkv,
                                          softcap, scale, st)
                : launch_hopper<64, false>(q, k, v, o, dout, lse, work,
                                           counters, dq, dk, dv, b, s, hq,
                                           hkv, softcap, scale, st);
    else
      err = cap ? launch_hopper<128, true>(q, k, v, o, dout, lse, work,
                                           counters, dq, dk, dv, b, s, hq,
                                           hkv, softcap, scale, st)
                : launch_hopper<128, false>(q, k, v, o, dout, lse, work,
                                            counters, dq, dk, dv, b, s, hq,
                                            hkv, softcap, scale, st);
    return static_cast<int>(err);
  }
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = work;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.b = b;
  p.s = s;
  p.hq = hq;
  p.hkv = hkv;
  p.softcap = softcap;
  p.scale = scale;
  cudaError_t err;
  switch (d) {
    case 16: err = cap ? launch<16, true>(p, st) : launch<16, false>(p, st);
             break;
    case 32: err = cap ? launch<32, true>(p, st) : launch<32, false>(p, st);
             break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
