// Rel-pos self-attention (WeNet variant, no rel_shift) for Hopper: forward
// (K1) and backward (K4).
//
// K1 replaces the TPU kernel reverb_tpu/ops/flash_attention.py:_attn_kernel
// (launched by _flash_fwd).  Per (batch*head) row it computes
//
//   scores[i,j] = ((q_i+u)·k_j + (q_i+v)·p_j) / sqrt(dk),  keys j >= kv_len
//                 masked out
//   attn        = softmax_j(scores[i,:])                 (f32 softmax)
//   attn_d      = keep[i,j] ? attn / (1-rate) : 0         (optional dropout)
//   out_i       = attn_d · V
//
// with the rel-pos table p (H,Tk,dk) shared by every batch row of a head.
// q+u and q+v are rounded to the input type (the TPU kernel adds them in
// the compute dtype), the probabilities are rounded to V's type before the
// second product, and both products accumulate in f32.  A row with no
// valid key (kv_len 0) comes out as 0, as in the TPU kernel.  The int8
// keep-mask (B,H,Tq,Tk) is drawn outside, so kernel and plain version see
// the same draw.  When training, K1 also writes each row's logsumexp so the
// backward can rebuild the probabilities without the (T,T) matrix.
//
// K4 replaces reverb_tpu/ops/flash_attention.py:_attn_bwd_kernel (launched
// by _flash_bwd): the six gradients dq, dk, dv, dp, du, dvb.  With
// P = exp(scores - lse), dattn = keep/(1-rate) · (g·Vᵀ) and
// D_i = Σ_j P_ij dattn_ij = g_i·out_i (FlashAttention-2), the softmax
// jacobian is dS = P ⊙ (dattn − D) · scale, and
//   dv = P_dᵀ g,  dk = dSᵀ (q+u),  dp = dSᵀ (q+v),  dq = dS (k + p),
//   du = Σ_i (dS k)_i,  dvb = Σ_i (dS p)_i.
//
// What bounds them on the H100: at the training shape (B·H = 128, T = 512,
// dk = 64) K1 is ~13 GFLOP and K4 ~34 GFLOP, against tens of MB of q/k/v/
// p/g/mask traffic — far above the card's ridge point, so both are bound by
// arithmetic.  bf16, the type both main paths run, goes to the tensor-core
// kernels of rel_pos_attention_bf16.cu.  This file keeps the f32 kernels:
// f32 FMAs from shared memory (no tensor cores; TF32 would break the 1e-4 /
// 1e-3 tolerances the f32 references hold the kernels to), one 128-thread
// block per SM for K4's ~135 KB of shared memory, and K4a for both types.
//
// Design of the f32 kernels: the TPU kernels keep all Tk keys of a row in
// VMEM; K4 carries dk/dv/dp across a sequential q-grid in resident output
// blocks.  Hopper blocks run in no order and hold at most 227 KB of shared
// memory, so:
//   - K1: one block owns a 64-query tile of one (b, h) row and walks 64-key
//     tiles with an online softmax; the unnormalised tile probabilities get
//     keep/(1-rate) and the row sum divides at the end.  The dropout
//     variant is its own instantiation (MASK), so serving runs no mask code.
//   - K4a: D_i = rowsum(g ∘ out), one warp per query row.
//   - K4b: one block per (b·h, 64-key tile) loops over every q tile and
//     accumulates dk, dv and dp for its keys in registers.
//   - K4c: one block per (b·h, 64-query tile) loops over the key tiles up to
//     kv_len, forms dq, and writes per-tile column sums of dq's two halves;
//     the wrapper sums those (and dp) over q tiles and the batch rows of
//     each head, as the TPU wrapper does (_flash_bwd:413-416).
// Each of the 128 threads owns a 4x8 patch of every 64x64 tile; tile rows
// are padded to 65 floats so the column-strided reads hit distinct banks.
// q/k/v/g/out/dq/dk/dv are read and written through (batch, head, time)
// strides, so the (B, T, H, dk) projection layout needs no transpose copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rel_pos_attention.cuh"

namespace {

using reverb_rpa::Geom;
using reverb_rpa::Str3;

constexpr int BQ = 64;    // queries per tile
constexpr int BK = 64;    // keys per tile
constexpr int DK = 64;    // head dim (the only one built)
constexpr int NT = 128;   // threads per block
constexpr int LD = DK + 1;
constexpr int TILE = BQ * LD;                        // floats per padded tile
constexpr int MASK_BYTES = BQ * BK;
constexpr int FWD_SMEM = 6 * TILE * (int)sizeof(float) + MASK_BYTES;
// K4b: K P V Qu Qv G, P_d, dS, lse, D, mask
constexpr int DKDV_SMEM = 8 * TILE * (int)sizeof(float)
                          + 2 * BQ * (int)sizeof(float) + MASK_BYTES;
// K4c: Qu Qv G K P V dS, lse, D, column partials, mask
constexpr int DQ_SMEM = 7 * TILE * (int)sizeof(float)
                        + 2 * BQ * (int)sizeof(float)
                        + 2 * 16 * DK * (int)sizeof(float) + MASK_BYTES;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
// round to T's precision (models an op the TPU kernel does in T)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// The tile loaders below read a whole 64x64 tile per block, PER = 32
// elements per thread; each thread starts LOADS global loads before any
// shared-memory store (one at a time left them latency-bound; all 32 at
// once spilled registers): K1 f32 0.66 ms batched vs 0.91 ms plain on the
// H100 at T = 512.
constexpr int PER = BQ * DK / NT;
constexpr int LOADS = 4;

// (q+u, q+v) of queries q0.. into two padded tiles; rows past Tq are 0.
template <typename T>
__device__ __forceinline__ void load_q_tile(const T* qb, const T* u,
                                            const T* vb, int h, int q0,
                                            const Geom& g, float* sQu,
                                            float* sQv) {
  for (int i = threadIdx.x; i < BQ * DK; i += NT) {
    const int r = i / DK, d = i % DK;
    const int t = q0 + r;
    float qu = 0.f, qv = 0.f;
    if (t < g.Tq) {
      const float qf = to_f<T>(qb[t * g.qs.t + d]);
      qu = round_to<T>(qf + to_f<T>(u[h * DK + d]));
      qv = round_to<T>(qf + to_f<T>(vb[h * DK + d]));
    }
    sQu[r * LD + d] = qu;
    sQv[r * LD + d] = qv;
  }
}

// rows t0.. of a (time, DK) operand with time stride `st`; rows past T are 0
template <typename T>
__device__ __forceinline__ void load_rows(const T* base, long long st, int t0,
                                          int T_, float* s) {
#pragma unroll 1
  for (int j0 = 0; j0 < PER; j0 += LOADS) {
    float x[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = threadIdx.x + (j0 + j) * NT;
      const int t = t0 + i / DK;
      x[j] = t < T_ ? to_f<T>(base[t * st + i % DK]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = threadIdx.x + (j0 + j) * NT;
      s[(i / DK) * LD + i % DK] = x[j];
    }
  }
}

// key rows k0.. of k, p and v together
template <typename T>
__device__ __forceinline__ void load_kpv(const T* kb, const T* pb,
                                         const T* vbase, int k0,
                                         const Geom& g, float* sK, float* sP,
                                         float* sV) {
#pragma unroll 1
  for (int j0 = 0; j0 < PER; j0 += LOADS) {
    float xk[LOADS], xp[LOADS], xv[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = threadIdx.x + (j0 + j) * NT;
      const int t = k0 + i / DK, d = i % DK;
      const bool ok = t < g.Tk;
      xk[j] = ok ? to_f<T>(kb[t * g.ks.t + d]) : 0.f;
      xp[j] = ok ? to_f<T>(pb[t * g.p_st + d]) : 0.f;
      xv[j] = ok ? to_f<T>(vbase[t * g.vs.t + d]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = threadIdx.x + (j0 + j) * NT;
      const int o = (i / DK) * LD + i % DK;
      sK[o] = xk[j];
      sP[o] = xp[j];
      sV[o] = xv[j];
    }
  }
}

// keep-mask tile [query][key] of (q0, k0); outside the matrix: 0
__device__ __forceinline__ void load_mask(const int8_t* mrow, int q0, int k0,
                                          int Tq, int Tk, unsigned char* sM) {
#pragma unroll 1
  for (int j0 = 0; j0 < PER; j0 += LOADS) {
    unsigned char x[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = threadIdx.x + (j0 + j) * NT;
      const int t = q0 + i / BK, c = k0 + i % BK;
      x[j] = (t < Tq && c < Tk) ? (mrow[(long long)t * Tk + c] != 0) : 0;
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) sM[threadIdx.x + (j0 + j) * NT] = x[j];
  }
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

template <typename T, bool MASK>
__global__ void __launch_bounds__(NT) rel_pos_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ p,
    const T* __restrict__ u, const T* __restrict__ vb,
    const int* __restrict__ kv_lens, const int8_t* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ lse, Geom g) {
  extern __shared__ float smem[];
  float* sQu = smem;            // BQ x LD  (q+u)
  float* sQv = sQu + TILE;      // BQ x LD  (q+v)
  float* sK = sQv + TILE;       // BK x LD
  float* sP = sK + TILE;        // BK x LD
  float* sV = sP + TILE;        // BK x LD
  float* sS = sV + TILE;        // BQ x LD  probabilities of this tile
  unsigned char* sM = reinterpret_cast<unsigned char*>(sS + TILE);

  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int kv_len = min(max(kv_lens[b], 0), g.Tk);

  const T* kb = k + b * g.ks.b + h * g.ks.h;
  const T* vbase = v + b * g.vs.b + h * g.vs.h;
  const T* pb = p + h * g.p_sh;
  const int8_t* mrow = MASK ? mask + (long long)bh * g.Tq * g.Tk : nullptr;

  load_q_tile<T>(q + b * g.qs.b + h * g.qs.h, u, vb, h, q0, g, sQu, sQv);

  float acc[4][8];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // previous tile fully consumed (and sQ written)
    load_kpv<T>(kb, pb, vbase, k0, g, sK, sP, sV);
    if (MASK) load_mask(mrow, q0, k0, g.Tq, g.Tk, sM);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float a[4], e[4], kk[8], pp[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = sQu[(ty * 4 + r) * LD + d];
        e[r] = sQv[(ty * 4 + r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        kk[c] = sK[(tx + 8 * c) * LD + d];
        pp[c] = sP[(tx + 8 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          s[r][c] = fmaf(a[r], kk[c], fmaf(e[r], pp[c], s[r][c]));
    }

    // online softmax over this tile; lanes tx=0..7 of a row are adjacent
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const bool ok = k0 + tx + 8 * c < kv_len;
        s[r][c] = ok ? s[r][c] * g.scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);   // finite: tile has a valid key
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const bool ok = k0 + tx + 8 * c < kv_len;
        const float e = ok ? expf(s[r][c] - m_new) : 0.f;
        sum += e;
        float pd = e;
        if (MASK)
          pd = sM[(ty * 4 + r) * BK + tx + 8 * c] ? e * g.keep_scale : 0.f;
        sS[(ty * 4 + r) * LD + tx + 8 * c] = round_to<T>(pd);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[8], ss[4];
#pragma unroll
      for (int c = 0; c < 8; ++c) sv[c] = sV[j * LD + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) ss[r] = sS[(ty * 4 + r) * LD + j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ss[r], sv[c], acc[r][c]);
    }
  }

  T* ob = out + b * g.os.b + h * g.os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t >= g.Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      ob[t * g.os.t + tx + 8 * c] = from_f<T>(acc[r][c] * inv);
    if (lse && tx == 0)
      lse[(long long)bh * g.Tq + t] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K4a: D_i = Σ_d g[i,d] · out[i,d]   (one warp per query row)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) attn_bwd_rowdot_kernel(
    const T* __restrict__ gr, const T* __restrict__ out,
    float* __restrict__ D, int BH, Geom g) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)BH * g.Tq) return;
  const int bh = (int)(row / g.Tq), t = (int)(row % g.Tq);
  const int b = bh / g.H, h = bh % g.H;
  const T* gp = gr + b * g.gs.b + h * g.gs.h + t * g.gs.t;
  const T* op = out + b * g.os.b + h * g.os.h + t * g.os.t;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < DK; d += 32) s += to_f<T>(gp[d]) * to_f<T>(op[d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) D[row] = s;
}

// S (or Sᵀ) patch of one thread: rows A[ra..ra+3], columns B[cb + 8c]
__device__ __forceinline__ void patch_dot2(const float* A1, const float* A2,
                                           const float* B1, const float* B2,
                                           int ra, int cb, float s[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DK; ++d) {
    float a[4], e[4], x[8], y[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = A1[(ra + r) * LD + d];
      e[r] = A2[(ra + r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      x[c] = B1[(cb + 8 * c) * LD + d];
      y[c] = B2[(cb + 8 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        s[r][c] = fmaf(a[r], x[c], fmaf(e[r], y[c], s[r][c]));
  }
}

__device__ __forceinline__ void patch_dot(const float* A, const float* B,
                                          int ra, int cb, float s[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DK; ++d) {
    float a[4], x[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ra + r) * LD + d];
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] = B[(cb + 8 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = fmaf(a[r], x[c], s[r][c]);
  }
}

// acc[r][c] += Σ_j W[ra+r][j] · X[j][cb+8c]   (W, X padded 64x64 tiles)
__device__ __forceinline__ void patch_mm(const float* W, const float* X,
                                         int ra, int cb, float acc[4][8]) {
#pragma unroll 4
  for (int j = 0; j < 64; ++j) {
    float w[4], x[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] = X[j * LD + cb + 8 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = W[(ra + r) * LD + j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(w[r], x[c], acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// K4b: dk, dv, dp for one 64-key tile of one (b, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ p,
    const T* __restrict__ u, const T* __restrict__ vb,
    const int* __restrict__ kv_lens, const int8_t* __restrict__ mask,
    const T* __restrict__ gr, const float* __restrict__ lse,
    const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dp_rows, Geom g) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sP = sK + TILE;
  float* sV = sP + TILE;
  float* sQu = sV + TILE;
  float* sQv = sQu + TILE;
  float* sG = sQv + TILE;
  float* sPd = sG + TILE;     // [key][query] dropped probabilities
  float* sdS = sPd + TILE;    // [key][query] dS
  float* sL = sdS + TILE;     // lse of the q tile
  float* sD = sL + BQ;        // D of the q tile
  unsigned char* sM = reinterpret_cast<unsigned char*>(sD + BQ);

  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int kv_len = min(max(kv_lens[b], 0), g.Tk);

  float aK[4][8], aV[4][8], aP[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) aK[r][c] = aV[r][c] = aP[r][c] = 0.f;

  if (k0 < kv_len) {
    const T* qb = q + b * g.qs.b + h * g.qs.h;
    const T* gb = gr + b * g.gs.b + h * g.gs.h;
    const int8_t* mrow = mask ? mask + (long long)bh * g.Tq * g.Tk : nullptr;
    load_kpv<T>(k + b * g.ks.b + h * g.ks.h, p + h * g.p_sh,
                v + b * g.vs.b + h * g.vs.h, k0, g, sK, sP, sV);
    const int n_q = (g.Tq + BQ - 1) / BQ;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // previous q tile fully consumed
      load_q_tile<T>(qb, u, vb, h, q0, g, sQu, sQv);
      load_rows<T>(gb, g.gs.t, q0, g.Tq, sG);
      if (mrow) load_mask(mrow, q0, k0, g.Tq, g.Tk, sM);
      for (int i = tid; i < BQ; i += NT) {
        const int t = q0 + i;
        sL[i] = t < g.Tq ? lse[(long long)bh * g.Tq + t] : 0.f;
        sD[i] = t < g.Tq ? D[(long long)bh * g.Tq + t] : 0.f;
      }
      __syncthreads();

      // Sᵀ patch: keys ty*4+r, queries tx+8c
      float pr[4][8], da[4][8];
      patch_dot2(sK, sP, sQu, sQv, ty * 4, tx, pr);
      patch_dot(sV, sG, ty * 4, tx, da);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jl = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int il = tx + 8 * c;
          const bool ok = k0 + jl < kv_len && q0 + il < g.Tq;
          const float P = ok ? expf(pr[r][c] * g.scale - sL[il]) : 0.f;
          float pd = P, dattn = da[r][c];
          if (mask) {
            const bool keep = sM[il * BK + jl] != 0;
            pd = keep ? P * g.keep_scale : 0.f;
            dattn = keep ? dattn * g.keep_scale : 0.f;
          }
          sPd[jl * LD + il] = pd;
          sdS[jl * LD + il] = P * (dattn - sD[il]) * g.scale;
        }
      }
      __syncthreads();
      patch_mm(sPd, sG, ty * 4, tx, aV);
      patch_mm(sdS, sQu, ty * 4, tx, aK);
      patch_mm(sdS, sQv, ty * 4, tx, aP);
    }
  }

  // keys past kv_len (and whole tiles past it) get 0
  T* dkb = dk + b * g.dks.b + h * g.dks.h;
  T* dvb = dv + b * g.dks.b + h * g.dks.h;
  float* dpb = dp_rows + (long long)bh * g.Tk * DK;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = k0 + ty * 4 + r;
    if (t >= g.Tk) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tx + 8 * c;
      dkb[t * g.dks.t + d] = from_f<T>(aK[r][c]);
      dvb[t * g.dks.t + d] = from_f<T>(aV[r][c]);
      dpb[(long long)t * DK + d] = aP[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K4c: dq and the du/dvb partial sums for one 64-query tile of one (b, h)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ p,
    const T* __restrict__ u, const T* __restrict__ vb,
    const int* __restrict__ kv_lens, const int8_t* __restrict__ mask,
    const T* __restrict__ gr, const float* __restrict__ lse,
    const float* __restrict__ D, T* __restrict__ dq,
    float* __restrict__ du_part, float* __restrict__ dvb_part, Geom g) {
  extern __shared__ float smem[];
  float* sQu = smem;
  float* sQv = sQu + TILE;
  float* sG = sQv + TILE;
  float* sK = sG + TILE;
  float* sP = sK + TILE;
  float* sV = sP + TILE;
  float* sdS = sV + TILE;     // [query][key]
  float* sL = sdS + TILE;
  float* sD = sL + BQ;
  float* sRed = sD + BQ;      // 2 x 16 x DK column partials
  unsigned char* sM = reinterpret_cast<unsigned char*>(sRed + 2 * 16 * DK);

  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H;
  const int q0 = blockIdx.x * BQ;
  const int n_qt = gridDim.x;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int kv_len = min(max(kv_lens[b], 0), g.Tk);
  const int8_t* mrow = mask ? mask + (long long)bh * g.Tq * g.Tk : nullptr;

  load_q_tile<T>(q + b * g.qs.b + h * g.qs.h, u, vb, h, q0, g, sQu, sQv);
  load_rows<T>(gr + b * g.gs.b + h * g.gs.h, g.gs.t, q0, g.Tq, sG);
  for (int i = tid; i < BQ; i += NT) {
    const int t = q0 + i;
    sL[i] = t < g.Tq ? lse[(long long)bh * g.Tq + t] : 0.f;
    sD[i] = t < g.Tq ? D[(long long)bh * g.Tq + t] : 0.f;
  }

  float aU[4][8], aV[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) aU[r][c] = aV[r][c] = 0.f;

  const T* kb = k + b * g.ks.b + h * g.ks.h;
  const T* vbase = v + b * g.vs.b + h * g.vs.h;
  const T* pb = p + h * g.p_sh;
  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // previous key tile fully consumed (and sQ written)
    load_kpv<T>(kb, pb, vbase, k0, g, sK, sP, sV);
    if (mrow) load_mask(mrow, q0, k0, g.Tq, g.Tk, sM);
    __syncthreads();

    // S patch: queries ty*4+r, keys tx+8c
    float pr[4][8], da[4][8];
    patch_dot2(sQu, sQv, sK, sP, ty * 4, tx, pr);
    patch_dot(sG, sV, ty * 4, tx, da);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int jl = tx + 8 * c;
        const bool ok = k0 + jl < kv_len && q0 + il < g.Tq;
        const float P = ok ? expf(pr[r][c] * g.scale - sL[il]) : 0.f;
        float dattn = da[r][c];
        if (mrow) dattn = sM[il * BK + jl] ? dattn * g.keep_scale : 0.f;
        sdS[il * LD + jl] = P * (dattn - sD[il]) * g.scale;
      }
    }
    __syncthreads();
    patch_mm(sdS, sK, ty * 4, tx, aU);
    patch_mm(sdS, sP, ty * 4, tx, aV);
  }

  T* dqb = dq + b * g.dqs.b + h * g.dqs.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t >= g.Tq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      dqb[t * g.dqs.t + tx + 8 * c] = from_f<T>(aU[r][c] + aV[r][c]);
  }
  // column sums of the dq halves over this tile's rows (fixed order)
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float su = 0.f, sv = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      su += aU[r][c];
      sv += aV[r][c];
    }
    sRed[ty * DK + tx + 8 * c] = su;
    sRed[16 * DK + ty * DK + tx + 8 * c] = sv;
  }
  __syncthreads();
  if (tid < DK) {
    float su = 0.f, sv = 0.f;
    for (int y = 0; y < 16; ++y) {
      su += sRed[y * DK + tid];
      sv += sRed[16 * DK + y * DK + tid];
    }
    const long long o = ((long long)bh * n_qt + blockIdx.x) * DK + tid;
    du_part[o] = su;
    dvb_part[o] = sv;
  }
}

// MASK: the dropout variant (a separate instantiation, so the serving
// kernel carries no mask code and no mask tile in shared memory)
template <typename T, bool MASK>
int launch_fwd_variant(const void* q, const void* k, const void* v,
                       const void* p, const void* u, const void* vb,
                       const int* kv_lens, const int8_t* mask, void* out,
                       float* lse, int B, const Geom& g,
                       cudaStream_t stream) {
  // the keep-mask tile sits at the end of shared memory
  constexpr int smem = MASK ? FWD_SMEM : FWD_SMEM - MASK_BYTES;
  static bool attr_set[64] = {};   // per instantiation and device
  const cudaError_t e = reverb_rpa::set_smem_once(
      rel_pos_attn_kernel<T, MASK>, smem, attr_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.Tq + BQ - 1) / BQ, B * g.H);
  rel_pos_attn_kernel<T, MASK><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)u,
      (const T*)vb, kv_lens, mask, (T*)out, lse, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* p,
               const void* u, const void* vb, const int* kv_lens,
               const int8_t* mask, void* out, float* lse, int B,
               const Geom& g, cudaStream_t stream) {
  return mask ? launch_fwd_variant<T, true>(q, k, v, p, u, vb, kv_lens,
                                            mask, out, lse, B, g, stream)
              : launch_fwd_variant<T, false>(q, k, v, p, u, vb, kv_lens,
                                             mask, out, lse, B, g, stream);
}

// K4a for either type
template <typename T>
int launch_rowdot(const void* out, const void* gr, float* D, int BH,
                  const Geom& g, cudaStream_t stream) {
  const long long rows = (long long)BH * g.Tq;
  attn_bwd_rowdot_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const T*)gr, (const T*)out, D, BH, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* p,
               const void* u, const void* vb, const int* kv_lens,
               const int8_t* mask, const void* out, const void* gr,
               const float* lse, float* D, void* dq, void* dk, void* dv,
               float* dp_rows, float* du_part, float* dvb_part, int B,
               const Geom& g, cudaStream_t stream) {
  static bool dkdv_set[64] = {}, dq_set[64] = {};   // per device
  cudaError_t e = reverb_rpa::set_smem_once(attn_bwd_dkdv_kernel<T>,
                                            DKDV_SMEM, dkdv_set);
  if (e == cudaSuccess)
    e = reverb_rpa::set_smem_once(attn_bwd_dq_kernel<T>, DQ_SMEM, dq_set);
  if (e != cudaSuccess) return (int)e;
  const int BH = B * g.H;
  e = (cudaError_t)launch_rowdot<T>(out, gr, D, BH, g, stream);
  if (e != cudaSuccess) return (int)e;
  dim3 gk((g.Tk + BK - 1) / BK, BH);
  attn_bwd_dkdv_kernel<T><<<gk, NT, DKDV_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)u,
      (const T*)vb, kv_lens, mask, (const T*)gr, lse, D, (T*)dk, (T*)dv,
      dp_rows, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((g.Tq + BQ - 1) / BQ, BH);
  attn_bwd_dq_kernel<T><<<gq, NT, DQ_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)u,
      (const T*)vb, kv_lens, mask, (const T*)gr, lse, D, (T*)dq, du_part,
      dvb_part, g);
  return (int)cudaGetLastError();
}

// strides: q, k, v, out, g, dq, dk/dv as (batch, head, time) triples, then
// the rel-pos table's (head, time) pair — 23 values
Geom make_geom(int H, int Tq, int Tk, const long long* st, float scale,
               float keep_scale) {
  Geom g;
  g.H = H;
  g.Tq = Tq;
  g.Tk = Tk;
  Str3* s3[7] = {&g.qs, &g.ks, &g.vs, &g.os, &g.gs, &g.dqs, &g.dks};
  for (int i = 0; i < 7; ++i) *s3[i] = Str3{st[3 * i], st[3 * i + 1],
                                            st[3 * i + 2]};
  g.p_sh = st[21];
  g.p_st = st[22];
  g.scale = scale;
  g.keep_scale = keep_scale;
  return g;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `strides` is a host array of 23
// element strides: (batch, head, time) of q, k, v, out, g, dq and dk/dv,
// then (head, time) of p; the head dim is contiguous everywhere.  kv_lens is
// (B,) int32.  mask (NULL for none) is a contiguous (B, H, Tq, Tk) int8
// keep-mask applied with keep_scale = 1/(1-rate).  Both return cudaError_t.
//
// The forward reads q/k/v/p/u/vb and writes out; lse (NULL when not
// training) receives the (B·H·Tq) f32 row logsumexps.
extern "C" int reverb_rel_pos_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* p,
    const void* u, const void* vb, const void* kv_lens, const void* mask,
    void* out, void* lse, int B, int H, int Tq, int Tk,
    const long long* strides, float scale, float keep_scale, void* stream) {
  const Geom g = make_geom(H, Tq, Tk, strides, scale, keep_scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || Tq == 0) return 0;
  const int8_t* m = (const int8_t*)mask;
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, p, u, vb, (const int*)kv_lens, m, out,
                             (float*)lse, B, g, st);
  if (dtype == 1)
    return reverb_rpa::bf16_fwd(q, k, v, p, u, vb, (const int*)kv_lens, m,
                                out, (float*)lse, B, g, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: inputs as the forward plus out (its result), g_out (the
// gradient of out) and lse; D is (B·H·Tq) f32 scratch.  dq/dk/dv are written
// in the input type through their strides; dp_rows is a contiguous
// (B·H, Tk, 64) f32 buffer and du_part/dvb_part are contiguous
// (B·H, ceil(Tq/64), 64) f32 buffers of per-q-tile column sums.
extern "C" int reverb_rel_pos_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* p,
    const void* u, const void* vb, const void* kv_lens, const void* mask,
    const void* out, const void* g_out, const void* lse, void* D, void* dq,
    void* dk, void* dv, void* dp_rows, void* du_part, void* dvb_part, int B,
    int H, int Tq, int Tk, const long long* strides, float scale,
    float keep_scale, void* stream) {
  const Geom g = make_geom(H, Tq, Tk, strides, scale, keep_scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || Tq == 0 || Tk == 0) return 0;
  const int8_t* m = (const int8_t*)mask;
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, p, u, vb, (const int*)kv_lens, m, out,
                             g_out, (const float*)lse, (float*)D, dq, dk, dv,
                             (float*)dp_rows, (float*)du_part,
                             (float*)dvb_part, B, g, st);
  if (dtype == 1) {
    const int e = launch_rowdot<__nv_bfloat16>(out, g_out, (float*)D,
                                               B * H, g, st);
    if (e != 0) return e;
    return reverb_rpa::bf16_bwd(
        q, k, v, p, u, vb, (const int*)kv_lens, m, g_out, (const float*)lse,
        (const float*)D, dq, dk, dv, (float*)dp_rows, (float*)du_part,
        (float*)dvb_part, B, g, st);
  }
  return (int)cudaErrorInvalidValue;
}
