// The backward of causal flash attention for Hopper (sm_90a), bf16 in and
// out, with bf16 mma.sync tensor-core tiles.
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
// The design, simple before fast: three launches on the caller's stream.
// * delta: one thread per (b, s, h) row.
// * dK/dV: one CTA of four warps per (batch, KV head, 64-key tile).  Each
//   warp owns 16 keys; the CTA keeps the K and V tile in shared memory and
//   walks the group's query heads and, for each, the query tiles at or
//   past its first key (BQ rows: 64, or 32 at D = 128 for registers),
//   loading each tile's Q, dO, lse and delta.  S^T = K Q^T and dP^T =
//   V dO^T are mma.sync m16n8k16 (fp32 accumulators); P^T and dS^T go
//   from the accumulator layout straight into the A fragments of dV +=
//   P^T dO and dK += dS^T Q.  dK and dV stay in registers over the whole
//   walk and are written once: no atomics, so runs are reproducible.
// * dQ: one CTA of four warps per (batch, query head, 64-row tile), each
//   warp 16 rows, walking the key tiles up to the diagonal: S = Q K^T,
//   dP = dO V^T, dS, then dQ += dS K, in registers, written once.
// Tiles are loaded by all threads with 16-byte loads into shared memory
// rows padded by 16 bytes (so ldmatrix's eight rows fall in distinct
// banks), then read as fragments with ldmatrix (.trans where the operand's
// contraction runs along the rows).  No TMA, wgmma or pipelining yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // four warps of 16 rows each
constexpr int BK = 64;            // keys per tile (dK/dV: per CTA)
constexpr int BM = 64;            // query rows per CTA of the dQ kernel
constexpr float LOG2E = 1.4426950408889634f;

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
  static constexpr int BQ = D == 128 ? 32 : 64;   // dK/dV: rows per q tile
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
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
  using C = Cfg<D>;
  constexpr int LD = C::LD, BQ = C::BQ;
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

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <int D, bool SOFTCAP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int kv_bytes = (2 * BK + 2 * C::BQ) * C::LD * 2 + 2 * C::BQ * 4;
  constexpr int q_bytes = (2 * BM + 2 * BK) * C::LD * 2;
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

// dq, dk, dv of causal attention (the contract above); delta is (B, Hq, S)
// fp32 scratch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int s, int hq, int hkv, int d, float softcap,
    float scale, void* stream) {
  if (s == 0 || b == 0) return 0;
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.b = b;
  p.s = s;
  p.hq = hq;
  p.hkv = hkv;
  p.softcap = softcap;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  cudaError_t err;
  switch (d) {
    case 16: err = cap ? launch<16, true>(p, st) : launch<16, false>(p, st);
             break;
    case 32: err = cap ? launch<32, true>(p, st) : launch<32, false>(p, st);
             break;
    case 64: err = cap ? launch<64, true>(p, st) : launch<64, false>(p, st);
             break;
    case 128: err = cap ? launch<128, true>(p, st) : launch<128, false>(p, st);
              break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
