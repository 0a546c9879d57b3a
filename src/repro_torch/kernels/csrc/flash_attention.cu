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
// accumulator are fp32; P is rounded to bf16 before P.V; the output is
// acc / max(l, 1e-30) rounded to bf16.
//
// What bounds it on this card: a prefill of S tokens does 4*D*Hq flops
// per visible (query, key) pair, about S^2/2 pairs when causal, against
// one read of q, k, v and one write of out.  At the serving path's shapes
// (S = 1280, D = 128, 32 query and 8 KV heads) that is ~13 GFLOP against
// ~26 MB, so the bf16 tensor cores bound it, not the memory.
//
// The design, simple and right first: one block of four warps per
// (64-row query tile, query head, batch row); each warp owns 16 query rows
// and keeps their Q fragments, running max and denominator, and fp32
// accumulator (16 x D) in registers.  The block loops over 64-key tiles
// only up to the last key its rows may see, which takes the place of the
// Pallas kernel's sequential kv grid axis and its pl.when skip.  Each K/V
// tile is staged in shared memory (rows padded by 16 bytes, so the
// fragment loads hit distinct banks); keys past kv_len or Skv are zero.
// S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate); P goes from the S accumulators to the A fragments in
// registers.  Heavier query tiles (later rows, when causal) start first.
// wgmma, TMA, a pipelined tile ring and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr float NEG_INF = -1e30f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  const int* kv_len;              // (B,) or null: then kv_len_default
  int b, sq, skv, hq, hkv;
  int ksb, kss, ksh, vsb, vss, vsh;
  int causal, q_offset, kv_len_default;
  float softcap, scale;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_attention_kernel(Args a) {
  constexpr int LD = D + 8;       // padded shared-memory row, in elements
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + (lane >> 2);   // this thread's two rows
  const int r1 = r0 + 8;
  const int c = (lane & 3) * 2;                  // its column pair

  int kv_lim = a.kv_len ? a.kv_len[bi] : a.kv_len_default;
  kv_lim = min(kv_lim, a.skv);
  int hi = kv_lim;
  if (a.causal) hi = min(hi, a.q_offset + min(q0 + BQ, a.sq));
  const int ntiles = hi > 0 ? (hi + BK - 1) / BK : 0;

  // Q fragments (A operand, row-major 16 x 16 per k-step) in registers
  const size_t q_row = static_cast<size_t>(a.hq) * D;
  const __nv_bfloat16* qb =
      a.q + (static_cast<size_t>(bi) * a.sq * a.hq + h) * D;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + c;
    const uint32_t* p0 =
        reinterpret_cast<const uint32_t*>(qb + r0 * q_row + col);
    const uint32_t* p1 =
        reinterpret_cast<const uint32_t*>(qb + r1 * q_row + col);
    qf[kk][0] = r0 < a.sq ? p0[0] : 0u;
    qf[kk][1] = r1 < a.sq ? p1[0] : 0u;
    qf[kk][2] = r0 < a.sq ? p0[4] : 0u;          // 8 columns on
    qf[kk][3] = r1 < a.sq ? p1[4] : 0u;
  }

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  const __nv_bfloat16* kb = a.k + static_cast<size_t>(bi) * a.ksb
                            + static_cast<size_t>(hk) * a.ksh;
  const __nv_bfloat16* vb = a.v + static_cast<size_t>(bi) * a.vsb
                            + static_cast<size_t>(hk) * a.vsh;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                             // last tile's reads done
    for (int i = threadIdx.x; i < BK * (D / 8); i += NWARPS * 32) {
      const int r = i / (D / 8), cc = (i % (D / 8)) * 8;
      const int kp = k0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (kp < kv_lim) {
        kx = *reinterpret_cast<const uint4*>(
            kb + static_cast<size_t>(kp) * a.kss + cc);
        vx = *reinterpret_cast<const uint4*>(
            vb + static_cast<size_t>(kp) * a.vss + cc);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + cc) = kx;
      *reinterpret_cast<uint4*>(vs + r * LD + cc) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + (lane >> 2)) * LD + c;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    }

    // scale, softcap, mask; the tile's row maxima
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + n * 8 + c + (e & 1);
        float x = s[n][e] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        const bool ok = col < kv_lim && (!a.causal || col <= a.q_offset + row);
        s[n][e] = ok ? x : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {                // the row's four threads
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float corr0 = expf(m[0] - mx[0]), corr1 = expf(m[1] - mx[1]);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = expf(s[n][0] - mx[0]);
      s[n][1] = expf(s[n][1] - mx[0]);
      s[n][2] = expf(s[n][2] - mx[1]);
      s[n][3] = expf(s[n][3] - mx[1]);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l[0] = l[0] * corr0 + rs0;                   // this thread's columns
    l[1] = l[1] * corr1 + rs1;
    m[0] = mx[0];
    m[1] = mx[1];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= corr0;
      o[dn][1] *= corr0;
      o[dn][2] *= corr1;
      o[dn][3] *= corr1;
    }

    // O += P V: P (bf16) from the S accumulators, 16 keys per k-step
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* v0 = vs + (j * 16 + c) * LD + (lane >> 2);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vp = v0 + dn * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
  }

  // the denominators over the row's four threads, then the output
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  __nv_bfloat16* ob = a.out + (static_cast<size_t>(bi) * a.sq * a.hq + h) * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + c;
    if (r0 < a.sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + col) =
          pack_bf16(o[dn][0] / d0, o[dn][1] / d0);
    if (r1 < a.sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + col) =
          pack_bf16(o[dn][2] / d1, o[dn][3] / d1);
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.b);
  flash_attention_kernel<D><<<grid, NWARPS * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, const int* kv_len,
    int b, int sq, int skv, int hq, int hkv, int d, int ksb, int kss, int ksh,
    int vsb, int vss, int vsh, int causal, int q_offset, int kv_len_default,
    float softcap, float scale, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(out),
               kv_len, b, sq, skv, hq, hkv, ksb, kss, ksh, vsb, vss, vsh,
               causal, q_offset, kv_len_default, softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq == 0 || b == 0) return 0;
  switch (d) {
    case 16: return static_cast<int>(launch<16>(a, s));
    case 32: return static_cast<int>(launch<32>(a, s));
    case 64: return static_cast<int>(launch<64>(a, s));
    case 128: return static_cast<int>(launch<128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
