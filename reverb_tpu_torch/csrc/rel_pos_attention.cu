// Rel-pos self-attention forward (WeNet variant, no rel_shift) for Hopper.
//
// Replaces the TPU kernel reverb_tpu/ops/flash_attention.py:_attn_kernel
// (launched by _flash_fwd).  Per (batch*head) row it computes
//
//   scores[i,j] = ((q_i+u)·k_j + (q_i+v)·p_j) / sqrt(dk),  keys j >= kv_len
//                 masked out
//   out_i       = softmax_j(scores[i,:]) · V        (f32 softmax)
//
// with the rel-pos table p (H,Tk,dk) shared by every batch row of a head.
// q+u and q+v are rounded to the input type (the TPU kernel adds them in
// the compute dtype), the probabilities are rounded to V's type before the
// second product, and both products accumulate in f32.  A row with no
// valid key (kv_len 0) comes out as 0, as in the TPU kernel.
//
// What bounds it on the H100: at the serving shape (B·H = 128, T = 512,
// dk = 64) the two products are ~13 GFLOP per layer against ~25 MB of
// q/k/v/p/out traffic — far above the card's ridge point, so it is bound
// by arithmetic.  This first version does the arithmetic with f32 FMAs
// from shared memory (no tensor cores), so it runs at a fraction of the
// bf16 tensor-core rate; wgmma is the next step.
//
// Design: the TPU kernel keeps all Tk keys of a row in VMEM and forms the
// whole (BQ, Tk) score block at once.  A Hopper block has at most 227 KB of
// shared memory, so here one block owns a 64-query tile of one (b, h) row
// and walks 64-key tiles with an online (FlashAttention-2 style) softmax:
// the (T, T) scores never leave the SM and shared memory holds only the
// current tiles.  Key tiles past kv_len are never loaded.  Each of the 128
// threads owns a 4×8 patch of the score tile (rows ty*4.., columns tx+8c)
// and the same rows × 8 head-dim columns of the output; rows are padded to
// 65 floats so the column-strided reads hit distinct banks.  q/k/v/out are
// read through (batch, head, time) strides, so the (B, T, H, dk) layout
// the projections produce needs no transpose copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BK = 64;    // keys per tile
constexpr int DK = 64;    // head dim (the only one built)
constexpr int NT = 128;   // threads per block
constexpr int LD = DK + 1;
constexpr int SMEM_BYTES = 6 * BQ * LD * (int)sizeof(float);

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

struct Str3 {
  long long b, h, t;
};

template <typename T>
__global__ void __launch_bounds__(NT) rel_pos_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ p,
    const T* __restrict__ u, const T* __restrict__ vb,
    const int* __restrict__ kv_lens, T* __restrict__ out, int H, int Tq,
    int Tk, Str3 qs, Str3 ks, Str3 vs, Str3 os, long long p_sh,
    long long p_st, float scale) {
  extern __shared__ float smem[];
  float* sQu = smem;            // BQ x LD  (q+u)
  float* sQv = sQu + BQ * LD;   // BQ x LD  (q+v)
  float* sK = sQv + BQ * LD;    // BK x LD
  float* sP = sK + BK * LD;     // BK x LD
  float* sV = sP + BK * LD;     // BK x LD
  float* sS = sV + BK * LD;     // BQ x LD  probabilities of this tile

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int kv_len = min(max(kv_lens[b], 0), Tk);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  const T* pb = p + h * p_sh;

  for (int i = tid; i < BQ * DK; i += NT) {
    const int r = i / DK, d = i % DK;
    const int t = q0 + r;
    float qu = 0.f, qv = 0.f;
    if (t < Tq) {
      const float qf = to_f<T>(qb[t * qs.t + d]);
      qu = round_to<T>(qf + to_f<T>(u[h * DK + d]));
      qv = round_to<T>(qf + to_f<T>(vb[h * DK + d]));
    }
    sQu[r * LD + d] = qu;
    sQv[r * LD + d] = qv;
  }

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
    for (int i = tid; i < BK * DK; i += NT) {
      const int r = i / DK, d = i % DK;
      const int t = k0 + r;
      float kx = 0.f, px = 0.f, vx = 0.f;
      if (t < Tk) {
        kx = to_f<T>(kb[t * ks.t + d]);
        px = to_f<T>(pb[t * p_st + d]);
        vx = to_f<T>(vbase[t * vs.t + d]);
      }
      sK[r * LD + d] = kx;
      sP[r * LD + d] = px;
      sV[r * LD + d] = vx;
    }
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
        s[r][c] = ok ? s[r][c] * scale : -INFINITY;
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
        sS[(ty * 4 + r) * LD + tx + 8 * c] = round_to<T>(e);
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

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      ob[t * os.t + tx + 8 * c] = from_f<T>(acc[r][c] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* p,
           const void* u, const void* vb, const int* kv_lens, void* out,
           int B, int H, int Tq, int Tk, Str3 qs, Str3 ks, Str3 vs, Str3 os,
           long long p_sh, long long p_st, float scale,
           cudaStream_t stream) {
  static bool attr_set = false;   // per instantiation, set on first launch
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rel_pos_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  rel_pos_attn_kernel<T><<<grid, NT, SMEM_BYTES, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)p, (const T*)u,
      (const T*)vb, kv_lens, (T*)out, H, Tq, Tk, qs, ks, vs, os, p_sh, p_st,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head dim
// is contiguous everywhere.  kv_lens is (B,) int32.  Returns cudaError_t.
extern "C" int reverb_rel_pos_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* p,
    const void* u, const void* vb, const void* kv_lens, void* out, int B,
    int H, int Tq, int Tk, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    long long o_st, long long p_sh, long long p_st, float scale,
    void* stream) {
  const Str3 qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st},
      os{o_sb, o_sh, o_st};
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || Tq == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, p, u, vb, (const int*)kv_lens, out, B, H,
                         Tq, Tk, qs, ks, vs, os, p_sh, p_st, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, u, vb, (const int*)kv_lens, out,
                                 B, H, Tq, Tk, qs, ks, vs, os, p_sh, p_st,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}
