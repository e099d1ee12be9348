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
// What bounds them on the H100: a handful of FLOPs per element against
// reading x (and g) and writing y (dx) once — pure memory traffic, ~3.35
// TB/s.  The design reads each element once into registers and keeps every
// row statistic on chip, so the traffic is the minimum the op needs, plus
// one (blocks × C) f32 partial per dgamma/dbeta.
//
// Design: the TPU kernels take 256-row blocks in VMEM and carry dgamma/
// dbeta across a sequential grid.  Here a row is split over k = ceil(C /
// 1024) warps (C % 128 == 0, C ≤ 8192), each thread holding 8 four-element
// vectors of it in registers (16-byte loads, neighbouring threads on
// neighbouring addresses); row sums go through warp shuffles and, when
// k > 1, through shared memory.  A block holds rb = 8 / k rows side by
// side.  K6 blocks walk `iters` groups of rows, keep each thread's
// dgamma/dbeta columns in registers, combine their rows in shared memory in
// a fixed order and write one partial row per block; a second small kernel
// sums the partials per column in a fixed order — no atomics, so dgamma and
// dbeta are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 8;           // four-element vectors per thread
constexpr int MAX_THREADS = 256;
constexpr int RED_FLOATS = 8192;   // rb · C ≤ 8192

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

// Sum (a, b) over the k warps holding one row.  Every thread of the block
// calls it the same number of times (k is uniform), so the barriers are safe.
__device__ __forceinline__ float2 row_sum2(float a, float b, int k,
                                           float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (k == 1) return make_float2(a, b);
  const int warp = threadIdx.x >> 5;
  __syncthreads();                       // red is free again
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const int w0 = warp / k * k;
  float2 s = make_float2(0.f, 0.f);
  for (int w = w0; w < w0 + k; ++w) {
    s.x += red[w].x;
    s.y += red[w].y;
  }
  return s;
}

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

// ---------------------------------------------------------------------------
// K5: y = LN(x)·w + b, rb rows per block
// ---------------------------------------------------------------------------

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
// K6a: dx per row, dgamma/dbeta partials per block
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
// K6b: column sums of the (P, C) partials, in partial order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MAX_THREADS) ln_colsum_kernel(
    const float* __restrict__ part_w, const float* __restrict__ part_b,
    float* __restrict__ dw, float* __restrict__ db, int P, int C) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C) return;
  const float* part = blockIdx.y == 0 ? part_w : part_b;
  float s = 0.f;
  for (int r = 0; r < P; ++r) s += part[(long long)r * C + col];
  (blockIdx.y == 0 ? dw : db)[col] = s;
}

struct Plan {
  int k, rb, threads;
};

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

template <typename T>
int fwd(const void* x, const float* w, const float* b, void* y, int N, int C,
        float eps, cudaStream_t stream) {
  const Plan p = plan(C);
  const unsigned grid = (unsigned)((N + p.rb - 1) / p.rb);
  ln_fwd_kernel<T><<<grid, p.threads, 0, stream>>>(
      (const T*)x, w, b, (T*)y, N, C, p.k, p.rb, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const float* w, const void* g, void* dx,
        float* part_w, float* part_b, float* dw, float* db, int N, int C,
        int blocks, int iters, float eps, cudaStream_t stream) {
  const Plan p = plan(C);
  ln_bwd_kernel<T><<<blocks, p.threads, 0, stream>>>(
      (const T*)x, w, (const T*)g, (T*)dx, part_w, part_b, N, C, p.k, p.rb,
      iters, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + MAX_THREADS - 1) / MAX_THREADS, 2);
  ln_colsum_kernel<<<grid, MAX_THREADS, 0, stream>>>(part_w, part_b, dw, db,
                                                     blocks, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per block slot of the forward/backward for a row width C (the
// wrapper sizes the backward's partial buffers with it).
extern "C" int reverb_layer_norm_rows_per_block(int C) { return plan(C).rb; }

// dtype: 0 = float32, 1 = bfloat16.  x, y contiguous (N, C) with C % 128
// == 0 and C <= 8192, 16-byte aligned; w, b (C,) f32.  Returns cudaError_t.
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
// (C,) f32 outputs.  Returns cudaError_t.
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
