// Row LayerNorm forward (K5) and backward (K6) for Hopper.
//
// K5 replaces the TPU kernel reverb_tpu/ops/layer_norm.py:_fwd_kernel, K6
// replaces _bwd_kernel (both launched from _launch_fwd/_launch_bwd).  Per
// row of x (N, C):
//
//   mean = E[x], var = max(E[x²] − mean², 0)   (one pass, f32)
//   rstd = rsqrt(var + eps)
//   x̂    = (x − mean)·rstd, rounded to x's type BEFORE the affine
//   y    = x̂·w + b     (w, b rounded to x's type; each op rounds, as in
//                       the plain PyTorch version)
//
// and, recomputing the row statistics instead of saving them,
//
//   dx     = rstd·(g·w − mean(g·w) − x̂·mean(g·w·x̂))   (f32, w in f32)
//   dgamma = Σ_rows g·cast(x̂),  dbeta = Σ_rows g      (f32)
//
// What bounds them on the H100: bytes.  A handful of f32 operations per
// element against reading x (and g) and writing y (dx) once: at the model's
// (4097, 1024) bf16, K5 moves 16.8 MB (5.0 µs at 3.35 TB/s) and K6 25.2 MB
// (7.5 µs), while their operations take under 1 µs at the f32 rate.  So the
// design moves each element once, in the widest accesses, with enough
// bytes in flight to cover the memory latency:
//
// - One warp per row (rows of up to 4096 bytes forward, C ≤ 1024
//   backward, which holds the model's width).  Each lane holds C/32 values
//   as NV 16-byte vectors (8 bf16 or 4 f32), neighbouring lanes on
//   neighbouring 16 bytes, so every load and store is one coalesced 512-byte
//   access per warp; the row sums are warp shuffles, with no shared memory
//   and no barrier inside the row loop.
// - A persistent grid of about one wave (SMs × the blocks the launch bounds
//   keep resident).  Each warp walks its rows and issues the loads of the
//   next row before it reduces the current one: two rows in flight a warp.
// - w and b are read once per warp and kept in registers for all its rows:
//   K5 rounds them to the input type once per block, through shared
//   memory; K6 holds w in f32.
// - K6 keeps each lane's dgamma/dbeta columns in registers across its rows,
//   combines the block's 8 warps in warp order through shared memory once at
//   the end, and writes one partial row per block; a second kernel sums the
//   partial rows per column in row order.  No atomics, fixed orders: dgamma
//   and dbeta are deterministic.
//
// Wider rows (up to C = 8192, not on the model's path) take the k-warps-per-
// row kernels: a row split over k = ceil(C / 1024) warps, each thread
// holding 8 four-element vectors, the row sums through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 8;           // four-element vectors per thread (k warps)
constexpr int MAX_THREADS = 256;
constexpr int RED_FLOATS = 8192;   // rb · C ≤ 8192
constexpr int WARPS = 8;           // warps (row slots) per warp-per-row block
constexpr int ROW_BYTES = 4096;    // widest row of the warp-per-row forward
constexpr int BWD_COLS = 1024;     // widest row of the warp-per-row backward

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 x;
  *reinterpret_cast<__nv_bfloat162*>(&x.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&x.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = x;
}

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Word k of a vector (k is a constant once the loops are unrolled, so the
// vector stays in registers).
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 16 bytes of T (one lane's vector) read as and written from f32 values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ float get(const uint4& v, int j) {
    return __uint_as_float(word(v, j));
  }
  static __device__ __forceinline__ uint4 pack(const float* o) {
    return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                      __float_as_uint(o[2]), __float_as_uint(o[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float get(const uint4& v, int j) {
    const uint32_t w = word(v, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float* o) {
    return make_uint4(pair(o[0], o[1]), pair(o[2], o[3]), pair(o[4], o[5]),
                      pair(o[6], o[7]));
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float2 warp_sum2(float a, float b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

// Sum (a, b) over the k warps holding one row.  Every thread of the block
// calls it the same number of times (k is uniform), so the barriers are safe.
__device__ __forceinline__ float2 row_sum2(float a, float b, int k,
                                           float2* red) {
  const float2 s2 = warp_sum2(a, b);
  if (k == 1) return s2;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                       // red is free again
  if ((threadIdx.x & 31) == 0) red[warp] = s2;
  __syncthreads();
  const int w0 = warp / k * k;
  float2 s = make_float2(0.f, 0.f);
  for (int w = w0; w < w0 + k; ++w) {
    s.x += red[w].x;
    s.y += red[w].y;
  }
  return s;
}

// One lane's NV vectors of row `row` of a (N, C) array: vector i holds
// elements (32·i + lane)·VEC ... +VEC; zeros past C and for row ≥ N.
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ a,
                                         long long row, int N, int C,
                                         int lane, uint4 (&v)[NV]) {
  constexpr int VEC = Vec<T>::N;
  const bool ok = row < N;
  const T* r = a + (ok ? row : 0) * C;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = (32 * i + lane) * VEC;
    v[i] = ok && e < C ? *reinterpret_cast<const uint4*>(r + e)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// K5, one warp per row: y = LN(x)·w + b
// ---------------------------------------------------------------------------

template <typename T, int NV>
__global__ void __launch_bounds__(WARPS * 32, NV <= 4 ? 2 : 1)
    ln_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y, int N,
                       int C, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ uint4 wb_raw[2 * ROW_BYTES / 16];     // w, b rounded to T
  T* wb = reinterpret_cast<T*>(wb_raw);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    wb[c] = from_f32<T>(w[c]);
    wb[C + c] = from_f32<T>(b[c]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint4 wr[NV], br[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = (32 * i + lane) * VEC;
    wr[i] = e < C ? *reinterpret_cast<const uint4*>(wb + e)
                  : make_uint4(0u, 0u, 0u, 0u);
    br[i] = e < C ? *reinterpret_cast<const uint4*>(wb + C + e)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  const long long stride = (long long)gridDim.x * WARPS;
  long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  uint4 cur[NV];
  load_row<T, NV>(x, row, N, C, lane, cur);
  for (; row < N; row += stride) {            // uniform over the warp
    uint4 nxt[NV];
    load_row<T, NV>(x, row + stride, N, C, lane, nxt);
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = Vec<T>::get(cur[i], j);
        s += v;
        ss += v * v;
      }
    const float2 tot = warp_sum2(s, ss);
    const float mean = tot.x / C;
    const float var = fmaxf(tot.y / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    T* yr = y + row * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (32 * i + lane) * VEC;
      if (e >= C) continue;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = round_to<T>(
            __fmul_rn(__fsub_rn(Vec<T>::get(cur[i], j), mean), rstd));
        const float t = round_to<T>(__fmul_rn(xh, Vec<T>::get(wr[i], j)));
        o[j] = __fadd_rn(t, Vec<T>::get(br[i], j));
      }
      *reinterpret_cast<uint4*>(yr + e) = Vec<T>::pack(o);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

// ---------------------------------------------------------------------------
// K5, k warps per row (wide rows): rb rows per block
// ---------------------------------------------------------------------------

struct Row {
  int tpr, grp, t;     // threads per row, row slot in the block, thread in row
};

__device__ __forceinline__ Row row_of(int k) {
  Row r;
  r.tpr = 32 * k;
  r.grp = threadIdx.x / r.tpr;
  r.t = threadIdx.x % r.tpr;
  return r;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) ln_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ y, int N, int C, int k,
    int rb, float eps) {
  __shared__ float2 red[8];
  const Row rw = row_of(k);
  const long long row = (long long)blockIdx.x * rb + rw.grp;
  const bool ok = row < N;
  const int n4 = C >> 2;
  const T* xr = x + (ok ? row : 0) * C;
  float v[SLOTS][4];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int idx = rw.t + i * rw.tpr;
    if (ok && idx < n4) {
      load4(xr + idx * 4, v[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s += v[i][j];
        ss += v[i][j] * v[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
    }
  }
  const float2 tot = row_sum2(s, ss, k, red);
  const float mean = tot.x / C;
  const float var = fmaxf(tot.y / C - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (!ok) return;
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int idx = rw.t + i * rw.tpr;
    if (idx >= n4) continue;
    float wv[4], bv[4], o[4];
    load4(w + idx * 4, wv);
    load4(b + idx * 4, bv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xh = round_to<T>(__fmul_rn(__fsub_rn(v[i][j], mean), rstd));
      const float t = round_to<T>(__fmul_rn(xh, round_to<T>(wv[j])));
      o[j] = __fadd_rn(t, round_to<T>(bv[j]));
    }
    store4(yr + idx * 4, o);
  }
}

// ---------------------------------------------------------------------------
// K6, one warp per row: dx per row, one dgamma/dbeta partial row per block
// ---------------------------------------------------------------------------

// Block b's warp r takes rows (b·iters + it)·WARPS + r, it < iters.  PF:
// load row it+1 before reducing row it (off where the registers would not
// hold two rows of x and g).
template <typename T, int NV, bool PF>
__global__ void __launch_bounds__(WARPS * 32, 1) ln_bwd_warp_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_b, int N, int C, int iters, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ __align__(16) float red[WARPS * BWD_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float wf[NV][VEC], dw[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = (32 * i + lane) * VEC;
#pragma unroll
    for (int q = 0; q < VEC; q += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < C) f = *reinterpret_cast<const float4*>(w + e + q);
      wf[i][q] = f.x;
      wf[i][q + 1] = f.y;
      wf[i][q + 2] = f.z;
      wf[i][q + 3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) dw[i][j] = db[i][j] = 0.f;
  }

  const long long row0 = (long long)blockIdx.x * iters * WARPS + warp;
  uint4 xc[NV], gc[NV];
  for (int it = 0; it < iters; ++it) {
    const long long row = row0 + (long long)it * WARPS;
    if (row >= N) break;                      // uniform over the warp
    if (!PF || it == 0) {
      load_row<T, NV>(x, row, N, C, lane, xc);
      load_row<T, NV>(g, row, N, C, lane, gc);
    }
    uint4 xn[NV], gn[NV];
    if (PF) {
      const long long nr = it + 1 < iters ? row + WARPS : N;
      load_row<T, NV>(x, nr, N, C, lane, xn);
      load_row<T, NV>(g, nr, N, C, lane, gn);
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = Vec<T>::get(xc[i], j);
        s += v;
        ss += v * v;
      }
    const float2 tot = warp_sum2(s, ss);
    const float mean = tot.x / C;
    const float var = fmaxf(tot.y / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    // the dx row sums, and this row's dgamma/dbeta terms (0 past C: g and
    // w are 0 there)
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (Vec<T>::get(xc[i], j) - mean) * rstd;
        const float gv = Vec<T>::get(gc[i], j);
        const float gw = gv * wf[i][j];
        a += gw;
        c += gw * xh;
        dw[i][j] += gv * round_to<T>(xh);
        db[i][j] += gv;
      }
    const float2 m = warp_sum2(a, c);
    const float m1 = m.x / C, m2 = m.y / C;
    T* dxr = dx + row * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (32 * i + lane) * VEC;
      if (e >= C) continue;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (Vec<T>::get(xc[i], j) - mean) * rstd;
        const float gw = Vec<T>::get(gc[i], j) * wf[i][j];
        o[j] = rstd * (gw - m1 - xh * m2);
      }
      *reinterpret_cast<uint4*>(dxr + e) = Vec<T>::pack(o);
    }
    if (PF) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        xc[i] = xn[i];
        gc[i] = gn[i];
      }
    }
  }

  // combine the block's warps per column, in warp order
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass) __syncthreads();               // pass 0's sums are read
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (32 * i + lane) * VEC;
      if (e >= C) continue;
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(red + warp * C + e + q) =
            pass ? make_float4(db[i][q], db[i][q + 1], db[i][q + 2],
                               db[i][q + 3])
                 : make_float4(dw[i][q], dw[i][q + 1], dw[i][q + 2],
                               dw[i][q + 3]);
    }
    __syncthreads();
    float* part = pass ? part_b : part_w;
    for (int col = threadIdx.x; col < C; col += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < WARPS; ++r) s += red[r * C + col];
      part[(long long)blockIdx.x * C + col] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K6, k warps per row (wide rows): dx per row, partials per block
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) ln_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_b, int N, int C, int k, int rb, int iters,
    float eps) {
  __shared__ float2 red[8];
  __shared__ float cols[RED_FLOATS];
  const Row rw = row_of(k);
  const int n4 = C >> 2;
  float dw[SLOTS][4], db[SLOTS][4];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dw[i][j] = db[i][j] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const long long row = ((long long)blockIdx.x * iters + it) * rb + rw.grp;
    const bool ok = row < N;
    const long long off = (ok ? row : 0) * C;
    float v[SLOTS][4], gv[SLOTS][4];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int idx = rw.t + i * rw.tpr;
      if (ok && idx < n4) {
        load4(x + off + idx * 4, v[i]);
        load4(g + off + idx * 4, gv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s += v[i][j];
          ss += v[i][j] * v[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = gv[i][j] = 0.f;
      }
    }
    const float2 tot = row_sum2(s, ss, k, red);
    const float mean = tot.x / C;
    const float var = fmaxf(tot.y / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    // x̂ in place of x (0 on rows past the end), then the dx row sums
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int idx = rw.t + i * rw.tpr;
      float wv[4] = {0.f, 0.f, 0.f, 0.f};
      if (idx < n4) load4(w + idx * 4, wv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[i][j] = ok ? (v[i][j] - mean) * rstd : 0.f;
        const float gw = gv[i][j] * wv[j];
        a += gw;
        c += gw * v[i][j];
        dw[i][j] += gv[i][j] * round_to<T>(v[i][j]);
        db[i][j] += gv[i][j];
        gv[i][j] = gw;   // keep g·w for dx
      }
    }
    const float2 m = row_sum2(a, c, k, red);
    const float m1 = m.x / C, m2 = m.y / C;
    if (ok) {
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int idx = rw.t + i * rw.tpr;
        if (idx >= n4) continue;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = rstd * (gv[i][j] - m1 - v[i][j] * m2);
        store4(dx + off + idx * 4, o);
      }
    }
  }

  // combine the block's rb row slots per column, in slot order
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int idx = rw.t + i * rw.tpr;
      if (idx >= n4) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cols[rw.grp * C + idx * 4 + j] = pass == 0 ? dw[i][j] : db[i][j];
    }
    __syncthreads();
    float* part = pass == 0 ? part_w : part_b;
    for (int col = threadIdx.x; col < C; col += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < rb; ++r) s += cols[r * C + col];
      part[(long long)blockIdx.x * C + col] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K6, last step: column sums of the (P, C) partials, in row order.  A block
// takes 32 columns; its 8 thread rows sum rows r ≡ y (mod 8) in order, then
// thread row 0 adds the 8 sums in order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) ln_colsum_kernel(
    const float* __restrict__ part_w, const float* __restrict__ part_b,
    float* __restrict__ dw, float* __restrict__ db, int P, int C) {
  __shared__ float sums[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* part = blockIdx.y == 0 ? part_w : part_b;
  float s = 0.f;
  if (col < C)
    for (int r = threadIdx.y; r < P; r += 8) s += part[(long long)r * C + col];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < C) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t += sums[r][threadIdx.x];
    (blockIdx.y == 0 ? dw : db)[col] = t;
  }
}

struct Plan {
  int k, rb, threads;
};

// The k-warps-per-row layout; for C ≤ 1024 it is k = 1, rb = WARPS, the
// warp-per-row kernels' rows per block too.
Plan plan(int C) {
  Plan p;
  p.k = (C / 4 + 32 * SLOTS - 1) / (32 * SLOTS);
  p.rb = 8 / p.k > 0 ? 8 / p.k : 1;
  p.threads = 32 * p.k * p.rb;
  return p;
}

bool shape_ok(int N, int C) {
  return N > 0 && C > 0 && C % 128 == 0 && C <= RED_FLOATS;
}

// The current device's SM count, read once per device.
int sm_count() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (cache[dev] <= 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 1;
  }
  return cache[dev];
}

template <typename T, int NV>
int fwd_warp(const void* x, const float* w, const float* b, void* y, int N,
             int C, float eps, cudaStream_t stream) {
  constexpr int resident = NV <= 4 ? 2 : 1;  // the kernel's launch bounds
  const long long want = (N + WARPS - 1) / WARPS;
  const long long wave = (long long)sm_count() * resident;
  const unsigned grid = (unsigned)(want < wave ? want : wave);
  ln_fwd_warp_kernel<T, NV><<<grid, WARPS * 32, 0, stream>>>(
      (const T*)x, w, b, (T*)y, N, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const float* w, const float* b, void* y, int N, int C,
        float eps, cudaStream_t stream) {
  const int bytes = C * (int)sizeof(T);
  if (bytes <= 512) return fwd_warp<T, 1>(x, w, b, y, N, C, eps, stream);
  if (bytes <= 1024) return fwd_warp<T, 2>(x, w, b, y, N, C, eps, stream);
  if (bytes <= 2048) return fwd_warp<T, 4>(x, w, b, y, N, C, eps, stream);
  if (bytes <= ROW_BYTES) return fwd_warp<T, 8>(x, w, b, y, N, C, eps, stream);
  const Plan p = plan(C);
  const unsigned grid = (unsigned)((N + p.rb - 1) / p.rb);
  ln_fwd_kernel<T><<<grid, p.threads, 0, stream>>>(
      (const T*)x, w, b, (T*)y, N, C, p.k, p.rb, eps);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
int bwd_warp(const void* x, const float* w, const void* g, void* dx,
             float* part_w, float* part_b, int N, int C, int blocks,
             int iters, float eps, cudaStream_t stream) {
  ln_bwd_warp_kernel<T, NV, (NV <= 4)><<<blocks, WARPS * 32, 0, stream>>>(
      (const T*)x, w, (const T*)g, (T*)dx, part_w, part_b, N, C, iters, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const float* w, const void* g, void* dx,
        float* part_w, float* part_b, float* dw, float* db, int N, int C,
        int blocks, int iters, float eps, cudaStream_t stream) {
  const int bytes = C * (int)sizeof(T);
  int e;
  if (C > BWD_COLS) {
    const Plan p = plan(C);
    ln_bwd_kernel<T><<<blocks, p.threads, 0, stream>>>(
        (const T*)x, w, (const T*)g, (T*)dx, part_w, part_b, N, C, p.k, p.rb,
        iters, eps);
    e = (int)cudaGetLastError();
  } else if (bytes <= 512) {
    e = bwd_warp<T, 1>(x, w, g, dx, part_w, part_b, N, C, blocks, iters, eps,
                       stream);
  } else if (bytes <= 1024) {
    e = bwd_warp<T, 2>(x, w, g, dx, part_w, part_b, N, C, blocks, iters, eps,
                       stream);
  } else if (bytes <= 2048) {
    e = bwd_warp<T, 4>(x, w, g, dx, part_w, part_b, N, C, blocks, iters, eps,
                       stream);
  } else {
    // only f32 rows of 512 < C ≤ 1024 come here
    if constexpr (sizeof(T) == 4)
      e = bwd_warp<T, 8>(x, w, g, dx, part_w, part_b, N, C, blocks, iters,
                         eps, stream);
    else
      e = (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  ln_colsum_kernel<<<dim3((C + 31) / 32, 2), dim3(32, 8), 0, stream>>>(
      part_w, part_b, dw, db, blocks, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per block slot of the backward for a row width C: the wrapper's
// launch plan (ops/layer_norm.py) sizes blocks · iters · rows ≥ N with it.
extern "C" int reverb_layer_norm_rows_per_block(int C) { return plan(C).rb; }

// dtype: 0 = float32, 1 = bfloat16.  x, y contiguous (N, C) with C % 128
// == 0 and C <= 8192, 16-byte aligned; w, b (C,) f32, 16-byte aligned.
// Returns cudaError_t.
extern "C" int reverb_layer_norm_fwd(int dtype, const void* x, const void* w,
                                     const void* b, void* y, int N, int C,
                                     float eps, void* stream) {
  if (!shape_ok(N, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd<float>(x, (const float*)w, (const float*)b, y, N, C, eps, st);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, (const float*)w, (const float*)b, y, N, C,
                              eps, st);
  return (int)cudaErrorInvalidValue;
}

// x, g, dx contiguous (N, C) in the input type; w (C,) f32; part_w/part_b
// (blocks, C) f32 scratch with blocks · iters · rows_per_block >= N; dw/db
// (C,) f32 outputs; all 16-byte aligned.  Returns cudaError_t.
extern "C" int reverb_layer_norm_bwd(int dtype, const void* x, const void* w,
                                     const void* g, void* dx, void* part_w,
                                     void* part_b, void* dw, void* db, int N,
                                     int C, int blocks, int iters, float eps,
                                     void* stream) {
  if (!shape_ok(N, C) || blocks <= 0 || iters <= 0 ||
      (long long)blocks * iters * plan(C).rb < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd<float>(x, (const float*)w, g, dx, (float*)part_w,
                      (float*)part_b, (float*)dw, (float*)db, N, C, blocks,
                      iters, eps, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, (const float*)w, g, dx, (float*)part_w,
                              (float*)part_b, (float*)dw, (float*)db, N, C,
                              blocks, iters, eps, st);
  return (int)cudaErrorInvalidValue;
}
