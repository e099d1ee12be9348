// Rel-pos self-attention in bf16 on the Hopper tensor cores: forward (K1)
// and the backward's main kernels (K4b, K4c).  The f32 kernels, K4a
// (D = rowsum(g∘out)) and the C entry points are in rel_pos_attention.cu,
// which sends every bf16 call here; the arithmetic is the one described
// there (replacing reverb_tpu/ops/flash_attention.py:_attn_kernel and
// _attn_bwd_kernel).
//
// What bounds them: at the training shape (B·H = 128, T = 512, dk = 64) K1
// is ~13 GFLOP and K4 ~34 GFLOP against ~30 MB of inputs (68 MB with the
// int8 keep-mask), so both are bound by the tensor cores' bf16 rate; only
// K1 with the mask comes near the memory bound.  The design follows
// FlashAttention-2 with `mma.sync.m16n8k16` (bf16 in, f32 accumulate):
//   - each warp owns 16 rows of the block's 64-row tile; the score
//     fragment is one contraction of depth 128, [q+u | q+v]·[k | p]ᵀ;
//   - operands come from bf16 shared-memory tiles through `ldmatrix`
//     (`.trans` where the contraction runs over the tile's rows), with rows
//     padded by 16 bytes so the eight row addresses of each 8x8 matrix fall
//     in distinct banks;
//   - the C fragment of one product is rounded to bf16 in registers and is
//     the A fragment of the next (P·V in K1, P_dᵀ·G and dSᵀ·[Qu|Qv] in K4b,
//     dS·[K|P] in K4c): probabilities never go through shared memory;
//   - the next tile streams in with `cp.async` (16 bytes a thread, rows
//     past the end zero-filled) while the current one computes (two stages).
// Rounding points: q+u and q+v are rounded to bf16 as the plain version
// does; P (unnormalised in K1) and dS are rounded to bf16 before they enter
// an MMA, where autograd's plain backward rounds too; every sum is f32.
// Not yet used: `wgmma` and TMA (the next step, ROADMAP queue 2).
//
// Layout of the fragments (PTX ISA, mma.m16n8k16): lane = 4·gid + tq; a C
// fragment holds rows gid and gid+8, columns 2tq and 2tq+1 of an 8-wide
// block; an A fragment of 16 columns is two such C blocks side by side.
//
// K4 follows the FlashAttention-2 split: K4b, one block per (b·h, 64-key
// tile), loops over the q tiles and accumulates dk, dv and dp; K4c, one
// block per (b·h, 64-query tile), loops over the key tiles for dq and
// writes per-tile column sums of dq's two halves (du/dvb).  No atomics:
// the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rel_pos_attention.cuh"

namespace reverb_rpa {
namespace {

using bf16 = __nv_bfloat16;

constexpr int DK = 64;            // head dim (the only one built)
constexpr int D2 = 2 * DK;        // depth of [q+u | q+v]·[k | p]ᵀ
constexpr int BQ = 64;            // queries per tile
constexpr int BK = 64;            // keys per tile
constexpr int NT = 128;           // 4 warps
constexpr int LD1 = DK + 8;       // bf16 row stride of a 64-wide tile
constexpr int LD2 = D2 + 8;       // bf16 row stride of a 128-wide tile
constexpr int LDM = 80;           // byte row stride of a keep-mask tile
constexpr int TILE1 = BQ * LD1;   // elements of a 64-wide tile
constexpr int TILE2 = BQ * LD2;   // elements of a 128-wide tile
constexpr int MTILE = BQ * LDM;   // bytes of a mask tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------ PTX helpers ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared; ok == false writes zeros (src not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a·b  (16x16 bf16 row-major A, 16x8 bf16 B, f32 C)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addresses for one lane, in a row-major bf16 tile of stride ld.
// A operand (or a .trans B operand): the 16x16 block at (r0, c0).
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int ld, int r0,
                                              int c0) {
  const int lane = threadIdx.x & 31;
  return s + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

// B operand of a product with the tile's rows as its columns (n): the
// n-blocks n0..n0+7 and n0+8..n0+15 at depth c0..c0+15; the result's
// registers {0,1} feed the first block, {2,3} the second.
__device__ __forceinline__ const bf16* b_addr(const bf16* s, int ld, int n0,
                                              int c0) {
  const int lane = threadIdx.x & 31;
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

// acc[n] += A · B, both from shared memory: A is the 16 rows ra.. of tile
// sa from column ca, depth 16·KS; B's columns are the rows n0.. of tile s
// from column c0 (NB n-blocks of 8).  A is loaded one k-step at a time,
// which keeps the registers of the kernels below within ptxas' budget.
template <int KS, int NB>
__device__ __forceinline__ void mm_rows(float (&acc)[NB][4], const bf16* sa,
                                        int lda, int ra, int ca,
                                        const bf16* s, int ld, int n0,
                                        int c0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    ldsm(a, a_addr(sa, lda, ra, ca + kk * 16));
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      ldsm(b, b_addr(s, ld, n0 + np * 16, c0 + kk * 16));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += A(16 x 16·KS) · B where B's rows are rows r0.. of the tile s
// and its columns the tile's columns c0..c0+8·NB (ldmatrix .trans)
template <int KS, int NB>
__device__ __forceinline__ void mm_cols(float (&acc)[NB][4],
                                        const uint32_t (&a)[KS][4],
                                        const bf16* s, int ld, int r0,
                                        int c0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      ldsm_t(b, a_addr(s, ld, r0 + kk * 16, c0 + np * 16));
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

template <int NB>
__device__ __forceinline__ void zero(float (&c)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// --------------------------- tile loaders ---------------------------

// rows t0..t0+63 of a (time, 64) bf16 operand with time stride st into a
// tile of stride ld (asynchronous; rows past T are zero)
__device__ __forceinline__ void cp_rows(bf16* s, int ld, const bf16* base,
                                        long long st, int t0, int T) {
#pragma unroll
  for (int j = 0; j < BQ * DK / 8 / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = t0 + r < T;
    cp16(s + r * ld + c, ok ? base + (t0 + r) * st + c : base, ok);
  }
}

// 64 f32 values v[t0..] (zero past T) into s, 4 bytes a copy, threads 0-63
__device__ __forceinline__ void cp_vec(float* s, const float* v, int t0,
                                       int T) {
  const int i = threadIdx.x;
  if (i < BQ) cp4(s + i, v + min(t0 + i, T - 1), t0 + i < T);
}

// keep-mask tile [query][key] at (q0, k0); outside the matrix: 0.  16-byte
// copies when every row starts on 16 bytes, else plain byte loads.
__device__ __forceinline__ void load_mask(unsigned char* s,
                                          const int8_t* mrow, int q0, int k0,
                                          int Tq, int Tk) {
  if ((Tk & 15) == 0) {
#pragma unroll
    for (int j = 0; j < BQ * BK / 16 / NT; ++j) {
      const int i = threadIdx.x + j * NT;
      const int r = i >> 2, c = (i & 3) * 16;
      const bool ok = q0 + r < Tq && k0 + c < Tk;
      cp16(s + r * LDM + c,
           ok ? mrow + (long long)(q0 + r) * Tk + k0 + c : mrow, ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < BQ * BK / NT; ++j) {
      const int i = threadIdx.x + j * NT;
      const int r = i >> 6, c = i & 63;
      const bool ok = q0 + r < Tq && k0 + c < Tk;
      s[r * LDM + c] = ok ? mrow[(long long)(q0 + r) * Tk + k0 + c] : 0;
    }
  }
}

// 8 bf16 values plus a bias, rounded to bf16 (q+u and q+v)
__device__ __forceinline__ uint4 add8(uint4 x, uint4 b) {
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ba = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* ra = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(xa[i]);
    const float2 bf = __bfloat1622float2(ba[i]);
    ra[i] = __floats2bfloat162_rn(xf.x + bf.x, xf.y + bf.y);
  }
  return r;
}

// The columns this thread converts in write_qcat (fixed per thread).
__device__ __forceinline__ int qcat_col() { return (threadIdx.x & 7) * 8; }

// [q+u | q+v] of queries q0.. into the 128-wide tile sQ, from the raw q
// rows either in global memory (qg, time stride st) or in a 64-wide shared
// tile (qs); rows past Tq are 0.  uu/vv: this thread's 8 bias values.
__device__ __forceinline__ void write_qcat(bf16* sQ, const bf16* qg,
                                           long long st, const bf16* qs,
                                           uint4 uu, uint4 vv, int q0,
                                           int Tq) {
  const int c = qcat_col();
#pragma unroll
  for (int j = 0; j < BQ * DK / 8 / NT; ++j) {
    const int r = (threadIdx.x + j * NT) >> 3;
    uint4 a = make_uint4(0, 0, 0, 0), e = a;
    if (q0 + r < Tq) {
      const uint4 x = qs ? *reinterpret_cast<const uint4*>(qs + r * LD1 + c)
                         : *reinterpret_cast<const uint4*>(
                               qg + (q0 + r) * st + c);
      a = add8(x, uu);
      e = add8(x, vv);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD2 + c) = a;
    *reinterpret_cast<uint4*>(sQ + r * LD2 + DK + c) = e;
  }
}

// keep bits of one C-fragment element pair from a [row][col] mask tile
__device__ __forceinline__ uint32_t keep2(const unsigned char* m, int row,
                                          int col) {
  return *reinterpret_cast<const uint16_t*>(m + row * LDM + col);
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

constexpr int FWD_SMEM_NOMASK = (TILE2 + 2 * TILE2 + 2 * TILE1) * 2;
constexpr int FWD_SMEM_MASK = FWD_SMEM_NOMASK + 2 * MTILE;

template <bool MASK>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ p,
    const bf16* __restrict__ u, const bf16* __restrict__ vb,
    const int* __restrict__ kv_lens, const int8_t* __restrict__ mask,
    bf16* __restrict__ out, float* __restrict__ lse, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [q+u | q+v]
  bf16* sKP = sQ + TILE2;                     // 2 stages of [k | p]
  bf16* sV = sKP + 2 * TILE2;                 // 2 stages of v
  unsigned char* sM = reinterpret_cast<unsigned char*>(sV + 2 * TILE1);

  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int kv_len = min(max(kv_lens[b], 0), g.Tk);
  const int n_tiles = (kv_len + BK - 1) / BK;

  const bf16* kb = k + b * g.ks.b + h * g.ks.h;
  const bf16* vbase = v + b * g.vs.b + h * g.vs.h;
  const bf16* pb = p + h * g.p_sh;
  const int8_t* mrow = MASK ? mask + (long long)bh * g.Tq * g.Tk : nullptr;

  auto prefetch = [&](int kt) {
    const int st = kt & 1, k0 = kt * BK;
    cp_rows(sKP + st * TILE2, LD2, kb, g.ks.t, k0, g.Tk);
    cp_rows(sKP + st * TILE2 + DK, LD2, pb, g.p_st, k0, g.Tk);
    cp_rows(sV + st * TILE1, LD1, vbase, g.vs.t, k0, g.Tk);
    if (MASK) load_mask(sM + st * MTILE, mrow, q0, k0, g.Tq, g.Tk);
    cp_commit();
  };
  if (n_tiles > 0) prefetch(0);
  {
    const int c = qcat_col();
    write_qcat(sQ, q + b * g.qs.b + h * g.qs.h, g.qs.t, nullptr,
               *reinterpret_cast<const uint4*>(u + h * DK + c),
               *reinterpret_cast<const uint4*>(vb + h * DK + c), q0, g.Tq);
  }
  __syncthreads();

  float acc[DK / 8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = g.scale * LOG2E;
  const int row = warp * 16 + gid;   // tile rows row and row + 8

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      prefetch(kt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* tKP = sKP + (kt & 1) * TILE2;
    const bf16* tV = sV + (kt & 1) * TILE1;
    const unsigned char* tM = sM + (kt & 1) * MTILE;
    const int k0 = kt * BK;

    float s[BK / 8][4];
    zero(s);
    mm_rows<D2 / 16>(s, sQ, LD2, warp * 16, 0, tKP, LD2, 0, 0);

    // online softmax (log2 domain) over this tile; a quad shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + nb * 8 + 2 * tq + (e & 1) < kv_len;
        s[nb][e] = ok ? s[nb][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);   // finite: key k0 is valid
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t pa[BK / 16][4];   // bf16 (dropped) probabilities: A of P·V
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e4[e] = exp2f(s[nb][e] - m[e >> 1]);
        sum[e >> 1] += e4[e];
      }
      if (MASK) {
        const uint32_t k01 = keep2(tM, row, nb * 8 + 2 * tq);
        const uint32_t k23 = keep2(tM, row + 8, nb * 8 + 2 * tq);
        e4[0] = (k01 & 0xff) ? e4[0] * g.keep_scale : 0.f;
        e4[1] = (k01 >> 8) ? e4[1] * g.keep_scale : 0.f;
        e4[2] = (k23 & 0xff) ? e4[2] * g.keep_scale : 0.f;
        e4[3] = (k23 >> 8) ? e4[3] * g.keep_scale : 0.f;
      }
      pa[nb >> 1][(nb & 1) * 2] = pack(e4[0], e4[1]);
      pa[nb >> 1][(nb & 1) * 2 + 1] = pack(e4[2], e4[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int nb = 0; nb < DK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] *= alpha[e >> 1];
    mm_cols(acc, pa, tV, LD1, 0, 0);
    __syncthreads();   // this stage is refilled two tiles on
  }

  bf16* ob = out + b * g.os.b + h * g.os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row + 8 * r;
    if (t >= g.Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < DK / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(ob + t * g.os.t + nb * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[nb][2 * r] * inv,
                                acc[nb][2 * r + 1] * inv);
    if (lse && tq == 0)
      lse[(long long)bh * g.Tq + t] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K4b: dk, dv, dp for one 64-key tile of one (b, h) row
// ---------------------------------------------------------------------------

// shared memory: [k|p], v of the key tile; per q-tile stage: raw q, g,
// lse, D, keep-mask; the converted [q+u | q+v] tile
constexpr int KV_STAGE = 2 * TILE1 * 2 + 2 * BQ * 4 + MTILE;   // bytes
constexpr int DKDV_SMEM = (TILE2 + TILE1 + TILE2) * 2 + 2 * KV_STAGE;
constexpr int QS = 32;   // queries per sub-step of a q tile (registers)

template <bool MASK>
__global__ void __launch_bounds__(NT) dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ p,
    const bf16* __restrict__ u, const bf16* __restrict__ vb,
    const int* __restrict__ kv_lens, const int8_t* __restrict__ mask,
    const bf16* __restrict__ gr, const float* __restrict__ lse,
    const float* __restrict__ D, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dp_rows, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sKP = reinterpret_cast<bf16*>(smem);
  bf16* sV = sKP + TILE2;
  bf16* sQ = sV + TILE1;                       // [q+u | q+v] of the q tile
  unsigned char* stage0 = reinterpret_cast<unsigned char*>(sQ + TILE2);
  // stage layout: raw q (TILE1 bf16), g (TILE1 bf16), lse, D (BQ f32),
  // mask (MTILE bytes)
  auto sQr = [&](int st) {
    return reinterpret_cast<bf16*>(stage0 + st * KV_STAGE);
  };
  auto sG = [&](int st) { return sQr(st) + TILE1; };
  auto sL = [&](int st) { return reinterpret_cast<float*>(sG(st) + TILE1); };
  auto sD = [&](int st) { return sL(st) + BQ; };
  auto sM = [&](int st) {
    return reinterpret_cast<unsigned char*>(sD(st) + BQ);
  };

  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int kv_len = min(max(kv_lens[b], 0), g.Tk);
  const int row = warp * 16 + gid;   // the warp's key rows row, row + 8

  float aK[DK / 8][4], aV[DK / 8][4], aP[DK / 8][4];
  zero(aK);
  zero(aV);
  zero(aP);

  if (k0 < kv_len) {
    const bf16* qb = q + b * g.qs.b + h * g.qs.h;
    const bf16* gb = gr + b * g.gs.b + h * g.gs.h;
    const float* lrow = lse + (long long)bh * g.Tq;
    const float* drow = D + (long long)bh * g.Tq;
    const int8_t* mrow = MASK ? mask + (long long)bh * g.Tq * g.Tk : nullptr;
    cp_rows(sKP, LD2, k + b * g.ks.b + h * g.ks.h, g.ks.t, k0, g.Tk);
    cp_rows(sKP + DK, LD2, p + h * g.p_sh, g.p_st, k0, g.Tk);
    cp_rows(sV, LD1, v + b * g.vs.b + h * g.vs.h, g.vs.t, k0, g.Tk);
    auto prefetch = [&](int qt) {
      const int st = qt & 1, q0 = qt * BQ;
      cp_rows(sQr(st), LD1, qb, g.qs.t, q0, g.Tq);
      cp_rows(sG(st), LD1, gb, g.gs.t, q0, g.Tq);
      cp_vec(sL(st), lrow, q0, g.Tq);
      cp_vec(sD(st), drow, q0, g.Tq);
      if (MASK) load_mask(sM(st), mrow, q0, k0, g.Tq, g.Tk);
      cp_commit();
    };
    const int c = qcat_col();
    const uint4 uu = *reinterpret_cast<const uint4*>(u + h * DK + c);
    const uint4 vv = *reinterpret_cast<const uint4*>(vb + h * DK + c);
    const bool kok[2] = {k0 + row < kv_len, k0 + row + 8 < kv_len};
    const float sl2 = g.scale * LOG2E;
    const int n_q = (g.Tq + BQ - 1) / BQ;
    prefetch(0);
    for (int qt = 0; qt < n_q; ++qt) {
      const int st = qt & 1, q0 = qt * BQ;
      if (qt + 1 < n_q) {
        prefetch(qt + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      write_qcat(sQ, nullptr, 0, sQr(st), uu, vv, q0, g.Tq);
      __syncthreads();
      const bf16* tG = sG(st);
      const float* tL = sL(st);
      const float* tD = sD(st);
      const unsigned char* tM = sM(st);

#pragma unroll 1
      for (int h0 = 0; h0 < BQ; h0 += QS) {
        // Sᵀ: this warp's 16 keys x QS queries, depth 128
        float s[QS / 8][4];
        zero(s);
        mm_rows<D2 / 16>(s, sKP, LD2, warp * 16, 0, sQ, LD2, h0, 0);
        // P (0 outside the valid keys and queries) and keep bits
        uint32_t keep[QS / 8] = {};
#pragma unroll
        for (int nb = 0; nb < QS / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = h0 + nb * 8 + 2 * tq + (e & 1);
            const bool ok = kok[e >> 1] && q0 + i < g.Tq;
            s[nb][e] = ok ? exp2f(s[nb][e] * sl2 - tL[i] * LOG2E) : 0.f;
            if (MASK && tM[i * LDM + row + 8 * (e >> 1)])
              keep[nb] |= 1u << e;
          }
        // dv += P_dᵀ · g
        {
          uint32_t pa[QS / 16][4];
#pragma unroll
          for (int nb = 0; nb < QS / 8; ++nb) {
            float d4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              d4[e] = MASK ? ((keep[nb] >> e) & 1 ? s[nb][e] * g.keep_scale
                                                  : 0.f)
                           : s[nb][e];
            pa[nb >> 1][(nb & 1) * 2] = pack(d4[0], d4[1]);
            pa[nb >> 1][(nb & 1) * 2 + 1] = pack(d4[2], d4[3]);
          }
          mm_cols(aV, pa, tG, LD1, h0, 0);
        }
        // dPᵀ = v · gᵀ, then dSᵀ = P ⊙ (dattn − D) · scale
        uint32_t sa[QS / 16][4];
        {
          float dpt[QS / 8][4];
          zero(dpt);
          mm_rows<DK / 16>(dpt, sV, LD1, warp * 16, 0, tG, LD1, h0, 0);
#pragma unroll
          for (int nb = 0; nb < QS / 8; ++nb) {
            float d4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = h0 + nb * 8 + 2 * tq + (e & 1);
              float da = dpt[nb][e];
              if (MASK) da = (keep[nb] >> e) & 1 ? da * g.keep_scale : 0.f;
              d4[e] = s[nb][e] * (da - tD[i]) * g.scale;
            }
            sa[nb >> 1][(nb & 1) * 2] = pack(d4[0], d4[1]);
            sa[nb >> 1][(nb & 1) * 2 + 1] = pack(d4[2], d4[3]);
          }
        }
        // dk += dSᵀ · (q+u), dp += dSᵀ · (q+v)
        mm_cols(aK, sa, sQ, LD2, h0, 0);
        mm_cols(aP, sa, sQ, LD2, h0, DK);
      }
      __syncthreads();   // sQ and this stage are rewritten next
    }
  }

  // keys past kv_len (and whole tiles past it) get 0
  bf16* dkb = dk + b * g.dks.b + h * g.dks.h;
  bf16* dvb = dv + b * g.dks.b + h * g.dks.h;
  float* dpb = dp_rows + (long long)bh * g.Tk * DK;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + row + 8 * r;
    if (t >= g.Tk) continue;
#pragma unroll
    for (int nb = 0; nb < DK / 8; ++nb) {
      const int d = nb * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dkb + t * g.dks.t + d) =
          __floats2bfloat162_rn(aK[nb][2 * r], aK[nb][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + t * g.dks.t + d) =
          __floats2bfloat162_rn(aV[nb][2 * r], aV[nb][2 * r + 1]);
      *reinterpret_cast<float2*>(dpb + (long long)t * DK + d) =
          make_float2(aP[nb][2 * r], aP[nb][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4c: dq and the du/dvb partial sums for one 64-query tile of one (b, h)
// ---------------------------------------------------------------------------

constexpr int DQ_SMEM_NOMASK = (TILE2 + TILE1 + 2 * TILE2 + 2 * TILE1) * 2 +
                               2 * 4 * DK * 4;
constexpr int DQ_SMEM_MASK = DQ_SMEM_NOMASK + 2 * MTILE;

template <bool MASK>
__global__ void __launch_bounds__(NT) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ p,
    const bf16* __restrict__ u, const bf16* __restrict__ vb,
    const int* __restrict__ kv_lens, const int8_t* __restrict__ mask,
    const bf16* __restrict__ gr, const float* __restrict__ lse,
    const float* __restrict__ D, bf16* __restrict__ dq,
    float* __restrict__ du_part, float* __restrict__ dvb_part, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [q+u | q+v]
  bf16* sG = sQ + TILE2;
  bf16* sKP = sG + TILE1;                     // 2 stages of [k | p]
  bf16* sV = sKP + 2 * TILE2;                 // 2 stages of v
  float* sRed = reinterpret_cast<float*>(sV + 2 * TILE1);   // 2 x 4 x DK
  unsigned char* sM = reinterpret_cast<unsigned char*>(sRed + 2 * 4 * DK);

  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int kv_len = min(max(kv_lens[b], 0), g.Tk);
  const int n_tiles = (kv_len + BK - 1) / BK;
  const int row = warp * 16 + gid;   // the warp's query rows row, row + 8

  const bf16* kb = k + b * g.ks.b + h * g.ks.h;
  const bf16* vbase = v + b * g.vs.b + h * g.vs.h;
  const bf16* pb = p + h * g.p_sh;
  const int8_t* mrow = MASK ? mask + (long long)bh * g.Tq * g.Tk : nullptr;

  auto prefetch = [&](int kt) {
    const int st = kt & 1, k0 = kt * BK;
    cp_rows(sKP + st * TILE2, LD2, kb, g.ks.t, k0, g.Tk);
    cp_rows(sKP + st * TILE2 + DK, LD2, pb, g.p_st, k0, g.Tk);
    cp_rows(sV + st * TILE1, LD1, vbase, g.vs.t, k0, g.Tk);
    if (MASK) load_mask(sM + st * MTILE, mrow, q0, k0, g.Tq, g.Tk);
    cp_commit();
  };
  cp_rows(sG, LD1, gr + b * g.gs.b + h * g.gs.h, g.gs.t, q0, g.Tq);
  if (n_tiles > 0) prefetch(0);   // one group with the g tile
  else cp_commit();
  {
    const int c = qcat_col();
    write_qcat(sQ, q + b * g.qs.b + h * g.qs.h, g.qs.t, nullptr,
               *reinterpret_cast<const uint4*>(u + h * DK + c),
               *reinterpret_cast<const uint4*>(vb + h * DK + c), q0, g.Tq);
  }
  float l2[2], dd[2];
  bool qok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row + 8 * r;
    qok[r] = t < g.Tq;
    l2[r] = qok[r] ? lse[(long long)bh * g.Tq + t] * LOG2E : 0.f;
    dd[r] = qok[r] ? D[(long long)bh * g.Tq + t] : 0.f;
  }

  float aU[DK / 8][4], aW[DK / 8][4];   // dS·k and dS·p
  zero(aU);
  zero(aW);
  const float sl2 = g.scale * LOG2E;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      prefetch(kt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* tKP = sKP + (kt & 1) * TILE2;
    const bf16* tV = sV + (kt & 1) * TILE1;
    const unsigned char* tM = sM + (kt & 1) * MTILE;
    const int k0 = kt * BK;

    float s[BK / 8][4];
    zero(s);
    mm_rows<D2 / 16>(s, sQ, LD2, warp * 16, 0, tKP, LD2, 0, 0);
    float dpm[BK / 8][4];
    zero(dpm);
    mm_rows<DK / 16>(dpm, sG, LD1, warp * 16, 0, tV, LD1, 0, 0);
    uint32_t sa[BK / 16][4];   // dS in bf16: A of dS·[k | p]
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      uint32_t kp[2] = {0xffffu, 0xffffu};
      if (MASK) {
        kp[0] = keep2(tM, row, nb * 8 + 2 * tq);
        kp[1] = keep2(tM, row + 8, nb * 8 + 2 * tq);
      }
      float d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = qok[r] && k0 + nb * 8 + 2 * tq + (e & 1) < kv_len;
        const float P = ok ? exp2f(s[nb][e] * sl2 - l2[r]) : 0.f;
        float da = dpm[nb][e];
        if (MASK) da = (kp[r] >> (8 * (e & 1))) & 0xff ? da * g.keep_scale
                                                       : 0.f;
        d4[e] = P * (da - dd[r]) * g.scale;
      }
      sa[nb >> 1][(nb & 1) * 2] = pack(d4[0], d4[1]);
      sa[nb >> 1][(nb & 1) * 2 + 1] = pack(d4[2], d4[3]);
    }
    mm_cols(aU, sa, tKP, LD2, 0, 0);
    mm_cols(aW, sa, tKP, LD2, 0, DK);
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_wait<0>();        // the g group when no key tile ran

  bf16* dqb = dq + b * g.dqs.b + h * g.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!qok[r]) continue;
    const int t = q0 + row + 8 * r;
#pragma unroll
    for (int nb = 0; nb < DK / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(dqb + t * g.dqs.t + nb * 8 +
                                         2 * tq) =
          __floats2bfloat162_rn(aU[nb][2 * r] + aW[nb][2 * r],
                                aU[nb][2 * r + 1] + aW[nb][2 * r + 1]);
  }
  // column sums of the dq halves over this tile's rows (fixed order: the
  // two rows of a lane, then the 8 row groups of a warp, then the warps)
#pragma unroll
  for (int nb = 0; nb < DK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float su = aU[nb][e] + aU[nb][2 + e];
      float sw = aW[nb][e] + aW[nb][2 + e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        su += __shfl_xor_sync(0xffffffffu, su, o);
        sw += __shfl_xor_sync(0xffffffffu, sw, o);
      }
      if (gid == 0) {
        sRed[warp * DK + nb * 8 + 2 * tq + e] = su;
        sRed[4 * DK + warp * DK + nb * 8 + 2 * tq + e] = sw;
      }
    }
  __syncthreads();
  if (threadIdx.x < DK) {
    const int d = threadIdx.x;
    float su = 0.f, sw = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      su += sRed[w * DK + d];
      sw += sRed[4 * DK + w * DK + d];
    }
    const long long o = ((long long)bh * gridDim.x + blockIdx.x) * DK + d;
    du_part[o] = su;
    dvb_part[o] = sw;
  }
}

template <bool MASK>
int launch_fwd(const void* q, const void* k, const void* v, const void* p,
               const void* u, const void* vb, const int* kv_lens,
               const int8_t* mask, void* out, float* lse, int B,
               const Geom& g, cudaStream_t stream) {
  constexpr int smem = MASK ? FWD_SMEM_MASK : FWD_SMEM_NOMASK;
  static bool attr_set[64] = {};   // per instantiation and device
  const cudaError_t e = set_smem_once(fwd_kernel<MASK>, smem, attr_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.Tq + BQ - 1) / BQ, B * g.H);
  fwd_kernel<MASK><<<grid, NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)p,
      (const bf16*)u, (const bf16*)vb, kv_lens, mask, (bf16*)out, lse, g);
  return (int)cudaGetLastError();
}

template <bool MASK>
int launch_bwd(const void* q, const void* k, const void* v, const void* p,
               const void* u, const void* vb, const int* kv_lens,
               const int8_t* mask, const void* gr, const float* lse,
               const float* D, void* dq, void* dk, void* dv, float* dp_rows,
               float* du_part, float* dvb_part, int B, const Geom& g,
               cudaStream_t stream) {
  constexpr int dq_smem = MASK ? DQ_SMEM_MASK : DQ_SMEM_NOMASK;
  static bool dkdv_set[64] = {}, dq_set[64] = {};   // per device
  cudaError_t e = set_smem_once(dkdv_kernel<MASK>, DKDV_SMEM, dkdv_set);
  if (e == cudaSuccess) e = set_smem_once(dq_kernel<MASK>, dq_smem, dq_set);
  if (e != cudaSuccess) return (int)e;
  const int BH = B * g.H;
  dim3 gk((g.Tk + BK - 1) / BK, BH);
  dkdv_kernel<MASK><<<gk, NT, DKDV_SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)p,
      (const bf16*)u, (const bf16*)vb, kv_lens, mask, (const bf16*)gr, lse,
      D, (bf16*)dk, (bf16*)dv, dp_rows, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((g.Tq + BQ - 1) / BQ, BH);
  dq_kernel<MASK><<<gq, NT, dq_smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)p,
      (const bf16*)u, (const bf16*)vb, kv_lens, mask, (const bf16*)gr, lse,
      D, (bf16*)dq, du_part, dvb_part, g);
  return (int)cudaGetLastError();
}

}  // namespace

int bf16_fwd(const void* q, const void* k, const void* v, const void* p,
             const void* u, const void* vb, const int* kv_lens,
             const int8_t* mask, void* out, float* lse, int B,
             const Geom& g, cudaStream_t stream) {
  return mask ? launch_fwd<true>(q, k, v, p, u, vb, kv_lens, mask, out, lse,
                                 B, g, stream)
              : launch_fwd<false>(q, k, v, p, u, vb, kv_lens, mask, out,
                                  lse, B, g, stream);
}

int bf16_bwd(const void* q, const void* k, const void* v, const void* p,
             const void* u, const void* vb, const int* kv_lens,
             const int8_t* mask, const void* gr, const float* lse,
             const float* D, void* dq, void* dk, void* dv, float* dp_rows,
             float* du_part, float* dvb_part, int B, const Geom& g,
             cudaStream_t stream) {
  return mask ? launch_bwd<true>(q, k, v, p, u, vb, kv_lens, mask, gr, lse,
                                 D, dq, dk, dv, dp_rows, du_part, dvb_part,
                                 B, g, stream)
              : launch_bwd<false>(q, k, v, p, u, vb, kv_lens, mask, gr, lse,
                                  D, dq, dk, dv, dp_rows, du_part, dvb_part,
                                  B, g, stream);
}

}  // namespace reverb_rpa
