// Shared by rel_pos_attention.cu (entry points, f32 kernels, K4a) and
// rel_pos_attention_bf16.cu (the bf16 tensor-core kernels).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace reverb_rpa {

struct Str3 {
  long long b, h, t;
};

// Shapes, strides and scalars shared by the kernels.
struct Geom {
  int H, Tq, Tk;
  Str3 qs, ks, vs, os;        // q, k, v, out strides
  Str3 gs, dqs, dks;          // g (grad of out), dq, dk and dv strides
  long long p_sh, p_st;       // rel-pos table (head, time) strides
  float scale, keep_scale;    // 1/sqrt(dk), 1/(1-rate)
};

// bf16 K1: out (and lse when not NULL) of every (b, h) row.
int bf16_fwd(const void* q, const void* k, const void* v, const void* p,
             const void* u, const void* vb, const int* kv_lens,
             const int8_t* mask, void* out, float* lse, int B,
             const Geom& g, cudaStream_t stream);

// bf16 K4b + K4c, after K4a has written D.
int bf16_bwd(const void* q, const void* k, const void* v, const void* p,
             const void* u, const void* vb, const int* kv_lens,
             const int8_t* mask, const void* gr, const float* lse,
             const float* D, void* dq, void* dk, void* dv, float* dp_rows,
             float* du_part, float* dvb_part, int B, const Geom& g,
             cudaStream_t stream);

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once on each
// device that launches it: the attribute is per device, and one process
// may drive several cards (data-parallel serving's replicas).
template <typename K>
inline cudaError_t set_smem_once(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace reverb_rpa
