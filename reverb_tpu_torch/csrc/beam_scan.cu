// CTC prefix beam search on Hopper: the forward frame scan and the
// backpointer walk.
//
// beam_scan_kernel replaces the TPU kernel reverb_tpu/ops/beam_scan.py:
// _kernel (launched by beam_scan_forward).  It runs the whole sequential
// frame loop in one launch, each frame doing exactly
// reverb_tpu/decode/prefix_beam.py:_step for the unbiased search: the
// blank-run fold, the K×K2 extensions, the rolling-hash merge of a keep
// prefix into its matching extension, and the top-K over the (K, K2+1)
// candidates with ties going to the lowest flat index.  It writes one
// backpointer record per frame and the final beam state.
//
// Its biased instantiation (BIASED = true, K2b, launched by
// beam_scan_forward with ctx_tables) is the same frame with in-beam context
// biasing, as the plain `_step` with ctx_tables (JAX runs that on its
// lax.scan path, reverb_tpu/decode/prefix_beam.py:_step, no kernel): each
// beam carries its trie state ctx and bonus cum; extension cell (k, u)
// gathers next_tab[ctx[k]·V + u] and score_tab[...] from device memory (the
// (S, V) tables do not fit on chip), its pruning total gains cum[k] + bonus
// and a keep entry's gains cum[k]; the winners rebuild ctx and cum.  The
// gather's address is known at the top of the frame (the beam's state and
// the frame's token), so the two loads are issued before the fold and their
// latency hides behind it.  The records are the unbiased scan's.
//
// beam_backtrace_kernel replaces reverb_tpu/ops/beam_scan.py:_bt_kernel
// (launched by beam_backtrace) and the scatter-max that follows it there:
// it walks the records from the last frame back to the first and writes
// each hypothesis's tokens and times.
//
// What bounds them on the H100: neither bytes nor FLOPs.  Both are chains of
// T dependent steps (a frame needs the beam the frame before it left; a
// walk's next address is the value it just loaded), so the time is T times
// the latency of one step, and the design's whole aim is a short step.  A
// step runs on one warp per scheduler, which pays the full latency of
// every dependent instruction, shared-memory load and barrier.
//
// The scan (one block of five warps per utterance: the batch rows are
// independent, the frames of one row are not):
//  * the frame inputs do not depend on the beam, so they are staged in
//    dynamic shared memory as a ring of two chunks of frames, filled with
//    cp.async one chunk ahead of the scan (the two byte arrays through a
//    register), as rows of 16 columns whose pads lose every comparison, so
//    a frame's tokens are read four to a load with no bound to test; the
//    blank's log-prob of every frame of a chunk is found when the chunk
//    arrives and read with one shuffle.  No frame waits for device memory;
//  * three block barriers a frame (candidates written; merged keep entries
//    struck; winners chosen).  Every warp folds the K beams itself (lanes
//    0..K-1) into its own copy of the per-beam values, and after the
//    selection every warp rebuilds the K winners into its own copy of the
//    beam state, so neither stage needs a barrier: __syncwarp is enough.
//    A beam's scores live in registers of its lane, with log_add(s, ns)
//    carried from the frame that made them.  The per-cell values are
//    double-buffered by frame parity, since a warp may start the next frame
//    while another still rebuilds this one;
//  * a loop over beams or tokens runs 16 steps unrolled with no branch in
//    it, so its shared-memory loads go out back to back; a keep prefix's
//    matches are a bit mask, from which the last match and the index sum
//    follow;
//  * the top-K is a rank count, exact and with no sort: candidate p's rank
//    is the number of candidates that beat it (greater, or equal at a lower
//    flat index).  A thread counts 4 candidates against 32 keys, compares as
//    f32 (>= is > the next f32 below), and two shuffles sum the quarters;
//  * four warps hold the K·K2 extension cells, a fifth the K keep
//    candidates, so the two roles never diverge inside a warp; the fifth
//    also writes the records, behind the other warps' heavier next frame.
//
// The walk (one block per utterance): the records of a chunk of frames are
// copied into shared memory with cp.async, last chunk first, two chunks in
// a ring so the next arrives while K lanes walk the current one; a step is
// then a shared-memory load, not a trip to L2 or HBM.  Prefixes and times
// are zeroed, scatter-maxed and written out by the whole block from shared
// memory when (K, L) fits beside the ring, else in place in device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAXK = 16;
constexpr int MAXC = 128;        // max K*(K2+1)
constexpr int SCAN_NT = 160;     // warps 0-3: extension cells, warp 4: keeps
constexpr int SCAN_NW = SCAN_NT / 32;
constexpr int KEEP_T0 = 128;     // first keep-candidate thread
constexpr int BT_NT = 256;
constexpr int SMEM_MAX = 232448;  // opt-in limit of a block on sm_90
constexpr uint32_t MULT1 = 0x9E3779B1u, MULT2 = 0x85EBCA77u;
constexpr uint32_t SEED1 = 0x12345679u, SEED2 = 0x87654321u;

__device__ __forceinline__ float log_add(float a, float b) {
  const float mx = fmaxf(a, b), mn = fminf(a, b);
  const float out = mx + log1pf(expf(mn - mx));
  return mx <= NEG_INF ? NEG_INF : out;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bytes of one stage of the scan's input ring: logp and idx as (chunk, 16)
// rows (a frame's K2 values, then pads), ts and bacc (chunk), valid and
// hskip (chunk) bytes; 16-byte multiple
__host__ __device__ inline int scan_stage_bytes(int chunk) {
  return (chunk * (8 * MAXK + 10) + 15) / 16 * 16;
}

struct ScanIn {
  const float* logp;
  const int* idx;
  const int* ts;
  const uint8_t* valid;
  const float* bacc;
  const uint8_t* hskip;
};

// beam state that other lanes read: one copy per warp.  The scores of beam
// k stay in registers of lane k of every warp.  ctx/cum: the biased scan's
// trie state and bonus.
struct BeamState {
  int plen[MAXK], last[MAXK];
  uint2 h[MAXK];
  int ctx[MAXK];
  float cum[MAXK];
};
// per-beam values of this frame after the blank-run fold: one copy per warp
struct Fold {
  float s[MAXK], vs[MAXK], vns[MAXK], score[MAXK], vit[MAXK];
  float keep_s[MAXK], keep_ns[MAXK], keep_vs[MAXK];
  int flags[MAXK];  // 1: vit_pre_ns, 2: sbank_pre_ns
};
// per extension cell (k, j), one copy per frame parity
struct Cells {
  float mrg_s[MAXC], mrg_ns[MAXC], mrg_vs[MAXC], mrg_vns[MAXC], tot[MAXC];
  int meta[MAXC];  // midx | hasm << 8 | eq_last << 9
  int nctx[MAXC];  // the biased scan's gathered trie state and bonus
  float bonus[MAXC];
};

// v >= x  <=>  v > below(x): the next f32 under x (x finite; denormals are
// kept: the build has no flush-to-zero)
__device__ __forceinline__ float below(float x) {
  const int b = __float_as_int(x);
  return __int_as_float(x > 0.f ? b - 1
                                : (x == 0.f ? (int)0x80000001 : b + 1));
}

template <bool BIASED>
__global__ void __launch_bounds__(SCAN_NT, 1) beam_scan_kernel(
    ScanIn in, const int* __restrict__ state_in,
    const int* __restrict__ next_tab, const float* __restrict__ score_tab,
    int V, int* __restrict__ records, int* __restrict__ finals, int B, int T,
    int K, int K2, int blank, int chunk) {
  extern __shared__ int4 scan_dyn[];
  __shared__ BeamState st_all[SCAN_NW];
  __shared__ Fold fo_all[SCAN_NW];
  __shared__ Cells ce_all[2];
  __shared__ __align__(16) float vals[MAXC];   // candidates by flat index
  __shared__ float ktot[2][MAXK];
  __shared__ unsigned matched[2];
  __shared__ int sel[MAXK];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int C = K2 + 1;
  const int KK2 = K * K2;
  const int NC = K * C;
  BeamState& st = st_all[warp];
  Fold& fo = fo_all[warp];

  // the candidate this thread computes: an extension cell (warps 0-3) or a
  // keep entry (warp 4), or none
  const bool is_cell = tid < KK2;
  const bool is_keep = tid >= KEEP_T0 && tid < KEEP_T0 + K;
  const int my_k = is_cell ? tid / K2 : (is_keep ? tid - KEEP_T0 : 0);
  const int my_j = is_cell ? tid - my_k * K2 : K2;
  const int my_flat = my_k * C + my_j;
  // the candidate this thread ranks: the one at flat index tid (warps 0-3)
  const int rk_parent = tid / C, rk_col = tid - rk_parent * C;
  const int rk_code = (rk_parent << 8) | rk_col;

  // the eight (T, B, K) record arrays, then wval (T, B)
  const size_t rec_n = (size_t)T * B * K;
  int* const wval = records + 8 * rec_n;

  // beam `lane`'s scores (lanes < K of every warp): s, ns, v_s, v_ns and
  // sc = log_add(s, ns), carried from the frame that made them.  The scan
  // starts from the empty prefix, or from `state_in`: the eight (B, K)
  // arrays plen, last, h1, h2, s, ns, v_s, v_ns of an earlier scan's final
  // state (a streaming hop resumes where the last one ended)
  const bool active = lane == 0;
  float r_s = active ? 0.f : NEG_INF, r_ns = NEG_INF;
  float r_vs = active ? 0.f : NEG_INF, r_vns = NEG_INF;
  int r_last = -1;
  if (lane < MAXK) {
    st.plen[lane] = 0;
    st.last[lane] = -1;
    st.ctx[lane] = 0;      // the trie's root
    st.cum[lane] = 0.f;
    st.h[lane] = active ? make_uint2(SEED1, SEED2)
                        : make_uint2((uint32_t)lane + 7u, (uint32_t)lane + 13u);
  }
  if (state_in != nullptr && lane < K) {
    const size_t BK = (size_t)B * K, o = (size_t)b * K + lane;
    st.plen[lane] = state_in[o];
    r_last = state_in[BK + o];
    st.last[lane] = r_last;
    st.h[lane] = make_uint2((uint32_t)state_in[2 * BK + o],
                            (uint32_t)state_in[3 * BK + o]);
    r_s = __int_as_float(state_in[4 * BK + o]);
    r_ns = __int_as_float(state_in[5 * BK + o]);
    r_vs = __int_as_float(state_in[6 * BK + o]);
    r_vns = __int_as_float(state_in[7 * BK + o]);
  }
  float r_sc = log_add(r_s, r_ns);
  if (tid < MAXC) vals[tid] = -INFINITY;   // a pad loses to every candidate
  if (tid < 2) matched[tid] = 0;

  // ---- the input ring ----
  const int stage_bytes = scan_stage_bytes(chunk);
  char* const ring = reinterpret_cast<char*>(scan_dyn);
  const int n_chunks = (T + chunk - 1) / chunk;
  const size_t row0 = (size_t)b * T;
  // the pad columns of both stages, once: a log-prob that loses every max
  // and a token that equals no token
  for (int i = tid; i < 2 * chunk * MAXK; i += SCAN_NT) {
    const int st_i = i / (chunk * MAXK), e = i - st_i * chunk * MAXK;
    if ((e & (MAXK - 1)) >= K2) {
      char* sb = ring + st_i * stage_bytes;
      reinterpret_cast<float*>(sb)[e] = NEG_INF;
      reinterpret_cast<int*>(sb)[chunk * MAXK + e] = -2;
    }
  }

  auto fetch = [&](int c) {   // cp.async of chunk c's word arrays
    char* sb = ring + (c & 1) * stage_bytes;
    float* s_lp = reinterpret_cast<float*>(sb);
    int* s_ix = reinterpret_cast<int*>(sb) + chunk * MAXK;
    int* s_ts = s_ix + chunk * MAXK;
    float* s_acc = reinterpret_cast<float*>(s_ts + chunk);
    const int t0 = c * chunk;
    const int n = min(chunk, T - t0);
    const float* g_lp = in.logp + (row0 + t0) * K2;
    const int* g_ix = in.idx + (row0 + t0) * K2;
    for (int i = tid; i < n * MAXK; i += SCAN_NT) {
      const int r = i >> 4, j = i & (MAXK - 1);
      if (j < K2) {
        cp_async4(s_lp + i, g_lp + r * K2 + j);
        cp_async4(s_ix + i, g_ix + r * K2 + j);
      }
    }
    if (tid < n) {
      cp_async4(s_ts + tid, in.ts + row0 + t0 + tid);
      cp_async4(s_acc + tid, in.bacc + row0 + t0 + tid);
    }
    cp_async_commit();
  };
  // chunk c's valid / hskip byte of this thread (threads [0, chunk) and
  // [chunk, 2 chunk)), loaded now and stored a chunk later
  auto load_flag = [&](int c) -> uint8_t {
    const int t0 = c * chunk;
    const int n = min(chunk, T - t0);
    const int i = tid < chunk ? tid : tid - chunk;
    if (tid >= 2 * chunk || i >= n) return 0;
    return (tid < chunk ? in.valid : in.hskip)[row0 + t0 + i];
  };
  auto store_flag = [&](int c, uint8_t v) {
    if (tid < 2 * chunk)
      reinterpret_cast<uint8_t*>(ring + (c & 1) * stage_bytes +
                                 chunk * (8 * MAXK + 8))[tid] = v;
  };

  uint8_t pend = 0;
  if (n_chunks > 0) {
    fetch(0);
    store_flag(0, load_flag(0));
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c is on chip; every warp is done with c - 1
    const bool more = c + 1 < n_chunks;
    if (more) {
      fetch(c + 1);
      pend = load_flag(c + 1);
    }
    const char* sb = ring + (c & 1) * stage_bytes;
    const float* s_lp = reinterpret_cast<const float*>(sb);
    const int* s_ix = reinterpret_cast<const int*>(sb) + chunk * MAXK;
    const int* s_ts = s_ix + chunk * MAXK;
    const float* s_acc = reinterpret_cast<const float*>(s_ts + chunk);
    const uint8_t* s_valid = reinterpret_cast<const uint8_t*>(s_acc + chunk);
    const uint8_t* s_hskip = s_valid + chunk;
    const int t0 = c * chunk;
    const int n = min(chunk, T - t0);

    // the blank's log-prob of frame `lane` of the chunk (it does not depend
    // on the beam), in every warp: a frame reads it with one shuffle
    float pb_lane = NEG_INF;
    if (lane < n) {
#pragma unroll
      for (int j = 0; j < MAXK; j += 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(s_lp + lane * MAXK + j);
        const int4 u4 = *reinterpret_cast<const int4*>(s_ix + lane * MAXK + j);
        pb_lane = fmaxf(pb_lane, u4.x == blank ? p4.x : NEG_INF);
        pb_lane = fmaxf(pb_lane, u4.y == blank ? p4.y : NEG_INF);
        pb_lane = fmaxf(pb_lane, u4.z == blank ? p4.z : NEG_INF);
        pb_lane = fmaxf(pb_lane, u4.w == blank ? p4.w : NEG_INF);
      }
    }

    for (int tl = 0; tl < n; ++tl) {
      const int t = t0 + tl;
      const float* f_lp = s_lp + tl * MAXK;
      const int* f_ix = s_ix + tl * MAXK;
      const bool is_valid = s_valid[tl] != 0;
      const bool hs = s_hskip[tl] != 0;
      const float p_blank = __shfl_sync(0xffffffffu, pb_lane, tl);
      Cells& ce = ce_all[t & 1];
      float* const kt = ktot[t & 1];
      unsigned* const mflag = &matched[t & 1];

      // the biased cell's trie step, issued now, used after the fold
      int c_next = 0;
      float c_bonus = 0.f;
      if (BIASED && is_cell) {
        const int u = min(max(f_ix[my_j], 0), V - 1);
        const size_t a = (size_t)st.ctx[my_k] * (size_t)V + (size_t)u;
        c_next = __ldg(next_tab + a);
        c_bonus = __ldg(score_tab + a);
      }

      // ---- per beam, in every warp: fold, keep entries ----
      bool live = false;
      if (lane < K) {
        const int k = lane;
        float s = r_s, ns = r_ns, vs = r_vs, vns = r_vns, score = r_sc;
        const bool pre_sel_ns = !(vs > vns);
        if (hs) {
          const float acc = s_acc[tl];
          s = score + acc;   // log_add(s, ns) + acc
          vs = fmaxf(vs, vns) + acc;
          ns = NEG_INF;
          vns = NEG_INF;
          // log_add(s, NEG_INF): expf(NEG_INF - s) is +0 for every
          // s > NEG_INF and log1pf(+0) is +0, so the sum is s + 0
          score = s <= NEG_INF ? NEG_INF : s + 0.f;
        }
        const bool sbank_pre_ns = hs && pre_sel_ns;
        const float vit = fmaxf(vs, vns);
        const bool post_sel_ns = !(vs > vns);
        // the log-prob of this beam's last token, if the frame lists it
        // (the pads equal no token): all 16 columns, four to a load
        float p_last = NEG_INF;
#pragma unroll
        for (int j = 0; j < MAXK; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(f_lp + j);
          const int4 u4 = *reinterpret_cast<const int4*>(f_ix + j);
          p_last = fmaxf(p_last, u4.x == r_last ? p4.x : NEG_INF);
          p_last = fmaxf(p_last, u4.y == r_last ? p4.y : NEG_INF);
          p_last = fmaxf(p_last, u4.z == r_last ? p4.z : NEG_INF);
          p_last = fmaxf(p_last, u4.w == r_last ? p4.w : NEG_INF);
        }
        const bool pb_dead = p_blank <= NEG_INF;
        fo.s[k] = s;
        fo.vs[k] = vs;
        fo.vns[k] = vns;
        fo.score[k] = score;
        fo.vit[k] = vit;
        fo.keep_s[k] = pb_dead ? NEG_INF : score + p_blank;
        fo.keep_vs[k] = pb_dead ? NEG_INF : vit + p_blank;
        fo.keep_ns[k] = (p_last <= NEG_INF) ? NEG_INF : ns + p_last;
        fo.flags[k] = ((post_sel_ns || sbank_pre_ns) ? 1 : 0) |
                      (sbank_pre_ns ? 2 : 0);
        live = score > NEG_INF;
      }
      const unsigned live_mask = __ballot_sync(0xffffffffu, live);
      __syncwarp();

      // ---- per candidate: extend and merge, or the keep entry's total ----
      unsigned mbits = 0;
      if (is_cell) {
        const int k = my_k;
        const int uu = f_ix[my_j];
        const float pu = f_lp[my_j];
        const bool eq_last = uu == st.last[k];
        const float base = eq_last ? fo.s[k] : fo.score[k];
        const float v_base = eq_last ? fo.vs[k] : fo.vit[k];
        const bool dead = (base <= NEG_INF) || (uu == blank);
        const float ext_ns = dead ? NEG_INF : base + pu;
        const float ext_vns =
            (dead || v_base <= NEG_INF) ? NEG_INF : v_base + pu;
        const uint32_t inc = (uint32_t)uu + 1u;
        const uint2 hk = st.h[k];
        const uint32_t eh1 = hk.x * MULT1 + inc;
        const uint32_t eh2 = hk.y * MULT2 + inc;
        // the live keep prefixes that equal this extension: all 16 slots,
        // unrolled (a slot past K holds no live beam)
#pragma unroll
        for (int i = 0; i < MAXK; ++i) {
          const uint2 hi = st.h[i];
          if (hi.x == eh1 && hi.y == eh2) mbits |= 1u << i;
        }
        mbits = dead ? 0u : (mbits & live_mask);
        const bool hasm = mbits != 0;
        int midx = 0;
        float mrg_s = NEG_INF, mrg_kns = NEG_INF, mrg_vs = NEG_INF;
        if (hasm) {
          const int mlast = 31 - __clz(mbits);   // the last match wins
          midx = mlast;
          for (unsigned m = mbits & ~(1u << mlast); m; m &= m - 1)
            midx += __ffs(m) - 1;                // the index sum
          mrg_s = fo.keep_s[mlast];
          mrg_kns = fo.keep_ns[mlast];
          mrg_vs = fo.keep_vs[mlast];
        }
        const float mrg_ns = log_add(ext_ns, mrg_kns);
        const float tot = log_add(mrg_s, mrg_ns);
        ce.mrg_s[tid] = mrg_s;
        ce.mrg_ns[tid] = mrg_ns;
        ce.mrg_vs[tid] = mrg_vs;
        ce.mrg_vns[tid] = ext_vns;
        ce.tot[tid] = tot;   // the winner's next log_add(s, ns)
        ce.meta[tid] = midx | (hasm ? 256 : 0) | (eq_last ? 512 : 0);
        float cand = (dead && !hasm) ? NEG_INF : tot;
        if (BIASED) {   // the bonus enters the pruning total only
          cand = cand <= NEG_INF ? NEG_INF : (cand + st.cum[k]) + c_bonus;
          ce.nctx[tid] = c_next;
          ce.bonus[tid] = c_bonus;
        }
        // + 0: -0 becomes +0, so equal values have equal bits
        vals[my_flat] = cand + 0.f;
      } else if (is_keep) {
        // log_add(keep_s, keep_ns) is NEG_INF for a beam that is not live
        const float tot = log_add(fo.keep_s[my_k], fo.keep_ns[my_k]);
        kt[my_k] = tot;      // the winner's next log_add(s, ns)
        float cand = tot;
        if (BIASED) cand = tot <= NEG_INF ? NEG_INF : tot + st.cum[my_k];
        vals[my_flat] = cand + 0.f;
      }
      mbits = __reduce_or_sync(0xffffffffu, mbits);
      if (lane == 0 && mbits) atomicOr(mflag, mbits);
      __syncthreads();  // (1) candidates, cells and the mask are written

      // a keep entry that an extension took is no candidate: NEG_INF
      if (is_keep && ((*mflag >> my_k) & 1u)) vals[my_flat] = NEG_INF;
      if (tid == 0) matched[(t & 1) ^ 1] = 0;  // the next frame's mask
      __syncthreads();  // (2) the candidates are final

      // ---- exact top-K by rank: (value desc, flat index asc) ----
      // The rank of candidate p is the count of candidates c with
      // v_c > v_p, or v_c == v_p and c < p.  Thread r of warps 0-3 counts,
      // for the four candidates 4·(r >> 2) .. +3 (a tile of its warp's
      // group of 32), the keys of quarter r & 3 (32 flat indices) that beat
      // them: 36 values read for 128 comparisons.  Keys before the tile
      // count with >= (as > below(v_p)), keys after it with >; inside the
      // tile the pairs are fixed.  (No __match_any_sync for the ties: on
      // 32 different values it costs more than the whole count.)  Two
      // butterfly steps leave thread r with the sum for candidate r.
      if (warp < 4) {
        const int kq = tid & 3;
        const bool b1 = (kq & 1) != 0, b2 = (kq & 2) != 0;
        const float4 m4 =
            *reinterpret_cast<const float4*>(&vals[tid & ~3]);
        const float l0 = below(m4.x), l1 = below(m4.y), l2 = below(m4.z),
                    l3 = below(m4.w);
        // the key tiles (of 4) of this quarter that lie before the tile
        const int split = kq < warp ? 8 : (kq == warp ? (lane >> 2) : 0);
        const float* q = vals + 32 * kq;
        float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll
        for (int u = 0; u < 32; u += 4) {
          const float4 v = *reinterpret_cast<const float4*>(q + u);
          const bool ge = (u >> 2) < split;
          const float t0 = ge ? l0 : m4.x, t1 = ge ? l1 : m4.y,
                      t2 = ge ? l2 : m4.z, t3 = ge ? l3 : m4.w;
          c0 += (v.x > t0 ? 1.f : 0.f) + (v.y > t0 ? 1.f : 0.f) +
                (v.z > t0 ? 1.f : 0.f) + (v.w > t0 ? 1.f : 0.f);
          c1 += (v.x > t1 ? 1.f : 0.f) + (v.y > t1 ? 1.f : 0.f) +
                (v.z > t1 ? 1.f : 0.f) + (v.w > t1 ? 1.f : 0.f);
          c2 += (v.x > t2 ? 1.f : 0.f) + (v.y > t2 ? 1.f : 0.f) +
                (v.z > t2 ? 1.f : 0.f) + (v.w > t2 ? 1.f : 0.f);
          c3 += (v.x > t3 ? 1.f : 0.f) + (v.y > t3 ? 1.f : 0.f) +
                (v.z > t3 ? 1.f : 0.f) + (v.w > t3 ? 1.f : 0.f);
        }
        if (kq == warp) {   // equal values at lower indices of the tile
          c1 += m4.x == m4.y ? 1.f : 0.f;
          c2 += (m4.x == m4.z ? 1.f : 0.f) + (m4.y == m4.z ? 1.f : 0.f);
          c3 += (m4.x == m4.w ? 1.f : 0.f) + (m4.y == m4.w ? 1.f : 0.f) +
                (m4.z == m4.w ? 1.f : 0.f);
        }
        // candidate (r & 3)'s four quarter counts, summed into thread r
        float k0 = b1 ? c1 : c0, k1 = b1 ? c3 : c2;
        k0 += __shfl_xor_sync(0xffffffffu, b1 ? c0 : c1, 1);
        k1 += __shfl_xor_sync(0xffffffffu, b1 ? c2 : c3, 1);
        float cnt = b2 ? k1 : k0;
        cnt += __shfl_xor_sync(0xffffffffu, b2 ? k0 : k1, 2);
        const int rank = (int)cnt;
        if (tid < NC && rank < K) sel[rank] = rk_code;
      }
      __syncthreads();  // (3) the K winners are chosen

      // ---- in every warp: rebuild the K winners; the last warp emits ----
      int n_plen = 0, n_last = 0, n_ctx = 0;
      float n_cum = 0.f;
      uint2 n_h = make_uint2(0u, 0u);
      if (lane < K) {
        const int k = lane;
        const int code = sel[k];
        const int parent = code >> 8, col = code & 255;
        const bool is_ext = col < K2;
        const int uu = is_ext ? col : 0;
        const int tok = f_ix[uu];
        const int cell = parent * K2 + uu;
        const float n_s = is_ext ? ce.mrg_s[cell] : fo.keep_s[parent];
        const float n_ns = is_ext ? ce.mrg_ns[cell] : fo.keep_ns[parent];
        const float n_vs = is_ext ? ce.mrg_vs[cell] : fo.keep_vs[parent];
        const float n_vns = is_ext ? ce.mrg_vns[cell] : NEG_INF;
        const float n_sc = is_ext ? ce.tot[cell] : kt[parent];
        const int plen_parent = st.plen[parent];
        n_plen = plen_parent + (is_ext ? 1 : 0);
        n_last = is_ext ? tok : st.last[parent];
        const uint32_t inc = (uint32_t)max(tok, 0) + 1u;
        const uint2 hp = st.h[parent];
        n_h = is_ext ? make_uint2(hp.x * MULT1 + inc, hp.y * MULT2 + inc) : hp;
        if (BIASED) {
          n_ctx = is_ext ? ce.nctx[cell] : st.ctx[parent];
          n_cum = st.cum[parent] + (is_ext ? ce.bonus[cell] : 0.f);
        }

        // the records leave from the keep warp: its next frame is the
        // lightest, so the stores hide behind the other warps' work
        if (warp == SCAN_NW - 1) {
          const int meta = ce.meta[cell];
          const int m_sel = meta & 255;
          const bool hasm_sel = (meta & 256) != 0;
          const bool rep_tok = (meta & 512) != 0;
          const int ts_parent = is_ext ? (hasm_sel ? m_sel : parent) : parent;
          // a multi-match index sum can leave [0, K): read as 0, like the
          // reference's one-hot gather
          const bool ts_in = ts_parent >= 0 && ts_parent < K;
          const bool s_src_is_ns = ts_in ? (fo.flags[ts_parent] & 1) != 0
                                         : false;
          const int pflags = fo.flags[parent];
          const bool ext_src_is_ns = rep_tok ? (pflags & 2) != 0
                                             : (pflags & 1) != 0;
          const int tns = is_ext ? m_sel : parent;
          const bool tns_in = tns >= 0 && tns < K;
          const float kns_t = tns_in ? fo.keep_ns[tns] : 0.f;
          const float vns_t = tns_in ? fo.vns[tns] : 0.f;
          const int plen_t = tns_in ? st.plen[tns] : 0;
          const bool repeat_fired = kns_t > NEG_INF && vns_t > NEG_INF;
          const int keep_wpos = repeat_fired ? max(plen_t - 1, 0) : -1;
          const int ns_src_beam = is_ext ? parent : tns;
          const bool ns_src_is_ns = !is_ext || ext_src_is_ns;
          const int ns_wpos = is_ext ? plen_parent : keep_wpos;
          const int pfx_wpos = is_ext ? plen_parent : -1;

          int* o = records + ((size_t)t * B + b) * K + k;
          o[0] = is_valid ? parent : k;                  // pfx_parent
          o[rec_n] = tok;                                // pfx_tok
          o[2 * rec_n] = is_valid ? pfx_wpos : -1;       // pfx_wpos
          o[3 * rec_n] = is_valid ? ts_parent : k;       // s_src_beam
          o[4 * rec_n] = is_valid && s_src_is_ns;        // s_src_is_ns
          o[5 * rec_n] = is_valid ? ns_src_beam : k;     // ns_src_beam
          o[6 * rec_n] = !is_valid || ns_src_is_ns;      // ns_src_is_ns
          o[7 * rec_n] = is_valid ? ns_wpos : -1;        // ns_wpos
          if (k == 0) wval[(size_t)t * B + b] = s_ts[tl];
        }
        if (is_valid) {   // frames past the utterance's length change nothing
          r_s = n_s;
          r_ns = n_ns;
          r_vs = n_vs;
          r_vns = n_vns;
          r_sc = n_sc;
          r_last = n_last;
        }
      }
      __syncwarp();  // this warp's reads of its old state are done
      if (lane < K && is_valid) {
        if (BIASED) {
          st.ctx[lane] = n_ctx;
          st.cum[lane] = n_cum;
        }
        st.plen[lane] = n_plen;
        st.last[lane] = n_last;
        st.h[lane] = n_h;
      }
      __syncwarp();
    }
    if (more) store_flag(c + 1, pend);
  }

  // the final state, in the layout of state_in
  if (warp == 0 && lane < K) {
    const size_t BK = (size_t)B * K, o = (size_t)b * K + lane;
    finals[o] = st.plen[lane];
    finals[BK + o] = st.last[lane];
    finals[2 * BK + o] = (int)st.h[lane].x;
    finals[3 * BK + o] = (int)st.h[lane].y;
    finals[4 * BK + o] = __float_as_int(r_s);
    finals[5 * BK + o] = __float_as_int(r_ns);
    finals[6 * BK + o] = __float_as_int(r_vs);
    finals[7 * BK + o] = __float_as_int(r_vns);
    if (BIASED) {
      finals[8 * BK + o] = st.ctx[lane];
      finals[9 * BK + o] = __float_as_int(st.cum[lane]);
    }
  }
}

// ints of one stage of the walk's record ring: eight (chunk, 16) arrays
// (rows padded to 16 so any index masked with 15 stays inside its row) and
// wval (chunk)
__host__ __device__ inline int bt_stage_ints(int chunk) {
  return 8 * chunk * MAXK + chunk;
}

struct Records {
  const int* rec[8];  // pfx_parent, pfx_tok, pfx_wpos, s_src_beam,
                      // s_src_is_ns, ns_src_beam, ns_src_is_ns, ns_wpos
  const int* wval;
};

// One walker's steps over the n frames of a staged chunk, last frame first.
// The outputs never overlap the ring (__restrict__), so a step's loads need
// not wait for the scatter-max of the step before it: the dependent chain
// of a step is one shared-memory load.
__device__ __forceinline__ void walk_chunk(
    const int* __restrict__ sb, int n, int CH16, int L,
    int* __restrict__ my_pre, int* __restrict__ my_tim, int& cur_p,
    int& cur_tb, bool& cur_ns) {
  int p = cur_p, tb = cur_tb;
  bool is_ns = cur_ns;
  for (int r = n - 1; r >= 0; --r) {
    const int* row = sb + r * MAXK;
    const int ip = p & (MAXK - 1), it = tb & (MAXK - 1);
    const int nxt_p = row[ip];
    const int tok = row[CH16 + ip];
    const int p_pos = row[2 * CH16 + ip];
    const int s_beam = row[3 * CH16 + it];
    const int s_isns = row[4 * CH16 + it];
    const int ns_beam = row[5 * CH16 + it];
    const int ns_isns = row[6 * CH16 + it];
    const int wpos = row[7 * CH16 + it];
    if (p_pos >= 0 && p_pos < L) my_pre[p_pos] = max(my_pre[p_pos], tok);
    if (is_ns && wpos >= 0 && wpos < L)
      my_tim[wpos] = max(my_tim[wpos], sb[8 * CH16 + r]);
    p = nxt_p;
    tb = is_ns ? ns_beam : s_beam;
    is_ns = (is_ns ? ns_isns : s_isns) != 0;
  }
  cur_p = p;
  cur_tb = tb;
  cur_ns = is_ns;
}

template <bool OUT_SMEM>
__global__ void __launch_bounds__(BT_NT) beam_backtrace_kernel(
    Records em, const int* __restrict__ order,
    const uint8_t* __restrict__ sel_ns, int* __restrict__ prefixes,
    int* __restrict__ times, int B, int T, int K, int L, int chunk) {
  extern __shared__ int4 bt_dyn[];
  int* const ring = reinterpret_cast<int*>(bt_dyn);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int stage_ints = bt_stage_ints(chunk);
  const int CH16 = chunk * MAXK;
  const int KL = K * L;
  int* const g_pre = prefixes + (size_t)b * KL;
  int* const g_tim = times + (size_t)b * KL;
  int* const pre = OUT_SMEM ? ring + 2 * stage_ints : g_pre;
  int* const tim = OUT_SMEM ? pre + KL : g_tim;

  auto fetch = [&](int c) {   // cp.async of chunk c's records
    int* sb = ring + (c & 1) * stage_ints;
    const int t0 = c * chunk;
    const int n = min(chunk, T - t0);
    const int kk = tid & (MAXK - 1);
    if (kk < K) {
      for (int r = tid >> 4; r < n; r += BT_NT / MAXK) {
        const size_t g = ((size_t)(t0 + r) * B + b) * K + kk;
#pragma unroll
        for (int a = 0; a < 8; ++a)
          cp_async4(sb + a * CH16 + r * MAXK + kk, em.rec[a] + g);
      }
    }
    if (tid < n)
      cp_async4(sb + 8 * CH16 + tid, em.wval + (size_t)(t0 + tid) * B + b);
    cp_async_commit();
  };

  const int n_chunks = (T + chunk - 1) / chunk;
  if (n_chunks > 0) fetch(n_chunks - 1);
  for (int i = tid; i < KL; i += BT_NT) {
    pre[i] = 0;
    tim[i] = 0;
  }

  const bool walker = tid < K;
  int cur_p = 0, cur_tb = 0;
  bool cur_ns = false;
  if (walker) {
    cur_p = cur_tb = order[b * K + tid];
    cur_ns = sel_ns[b * K + tid] != 0;
  }
  int* const my_pre = pre + tid * L;   // walkers only
  int* const my_tim = tim + tid * L;

  for (int c = n_chunks - 1; c >= 0; --c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c is on chip (and the outputs are zeroed);
                      // the walkers are done with chunk c + 1
    if (c > 0) fetch(c - 1);
    if (walker)
      walk_chunk(ring + (c & 1) * stage_ints, min(chunk, T - c * chunk), CH16,
                 L, my_pre, my_tim, cur_p, cur_tb, cur_ns);
  }
  if (OUT_SMEM) {
    __syncthreads();
    for (int i = tid; i < KL; i += BT_NT) {
      g_pre[i] = pre[i];
      g_tim[i] = tim[i];
    }
  }
}

template <bool OUT_SMEM>
cudaError_t launch_backtrace(const Records& em, const int* order,
                             const uint8_t* sel_ns, int* prefixes, int* times,
                             int B, int T, int K, int L, int chunk, int smem,
                             cudaStream_t stream) {
  if (smem > 48 * 1024) {   // above the default limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        beam_backtrace_kernel<OUT_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  beam_backtrace_kernel<OUT_SMEM><<<B, BT_NT, smem, stream>>>(
      em, order, sel_ns, prefixes, times, B, T, K, L, chunk);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared-memory bytes of the scan for chunks of `chunk` frames: the
// wrapper's launch plan must agree.
extern "C" int reverb_beam_scan_smem_bytes(int chunk) {
  return 2 * scan_stage_bytes(chunk);
}

// The same for the walk; out_on_chip adds the (2, K, L) outputs.
extern "C" int reverb_beam_backtrace_smem_bytes(int chunk, int K, int L,
                                                int out_on_chip) {
  return 4 * (2 * bt_stage_ints(chunk) + (out_on_chip ? 2 * K * L : 0));
}

// Layouts: logp/idx (B,T,K2) f32/i32; ts/bacc (B,T) i32/f32; valid/hskip
// (B,T) bool; records: the eight emit arrays (T,B,K) i32 one after another,
// then wval (T,B) i32; state_in (NULL: the empty prefix) and finals: the
// eight (B,K) arrays plen, last, h1, h2 (i32; the hashes' uint32 bits), s,
// ns, v_s, v_ns (f32) one after another.  next_tab/score_tab NULL: the
// unbiased scan (K2); else K2b, the scan biased by a context graph's (S, V)
// tables, next_tab i32 (the goto of state s on token u) and score_tab f32
// (its bonus), from the empty prefix (state_in NULL), with finals (10, B, K):
// the eight arrays, then ctx (i32) and cum (f32).  chunk: frames per stage
// of the input ring (1..32).  Returns cudaError_t.
extern "C" int reverb_beam_scan_forward(
    const void* logp, const void* idx, const void* ts, const void* valid,
    const void* bacc, const void* hskip, const void* state_in,
    const void* next_tab, const void* score_tab, void* records, void* finals,
    int B, int T, int K, int K2, int blank_id, int chunk, int S, int V,
    void* stream) {
  const bool biased = next_tab != nullptr;
  if (K < 1 || K > MAXK || K2 < 1 || K2 > MAXK || K * (K2 + 1) > MAXC ||
      chunk < 1 || chunk > 32 || T < 0 ||
      biased != (score_tab != nullptr) ||
      (biased && (state_in != nullptr || S < 1 || V < 1)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = 2 * scan_stage_bytes(chunk);   // at most 9 KB
  const ScanIn in{(const float*)logp,    (const int*)idx,
                  (const int*)ts,        (const uint8_t*)valid,
                  (const float*)bacc,    (const uint8_t*)hskip};
  if (biased)
    beam_scan_kernel<true><<<B, SCAN_NT, smem, (cudaStream_t)stream>>>(
        in, nullptr, (const int*)next_tab, (const float*)score_tab, V,
        (int*)records, (int*)finals, B, T, K, K2, blank_id, chunk);
  else
    beam_scan_kernel<false><<<B, SCAN_NT, smem, (cudaStream_t)stream>>>(
        in, (const int*)state_in, nullptr, nullptr, 0, (int*)records,
        (int*)finals, B, T, K, K2, blank_id, chunk);
  return (int)cudaGetLastError();
}

// The eight emit arrays (T,B,K) and wval (T,B) as nine pointers; order (B,K)
// i32, sel_ns (B,K) bool → prefixes/times (B,K,L) i32.  chunk: frames per
// stage of the record ring; out_on_chip: the outputs are built in shared
// memory (smem_bytes must then hold them beside the ring).
extern "C" int reverb_beam_backtrace(
    const void* pfx_parent, const void* pfx_tok, const void* pfx_wpos,
    const void* s_src_beam, const void* s_src_is_ns, const void* ns_src_beam,
    const void* ns_src_is_ns, const void* ns_wpos, const void* wval,
    const void* order, const void* sel_ns, void* prefixes, void* times, int B,
    int T, int K, int L, int chunk, int smem_bytes, int out_on_chip,
    void* stream) {
  if (K < 1 || K > MAXK || chunk < 1 || chunk > BT_NT || T < 0 || L < 0 ||
      smem_bytes > SMEM_MAX ||
      smem_bytes != reverb_beam_backtrace_smem_bytes(chunk, K, L, out_on_chip))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Records em{{(const int*)pfx_parent, (const int*)pfx_tok,
                    (const int*)pfx_wpos, (const int*)s_src_beam,
                    (const int*)s_src_is_ns, (const int*)ns_src_beam,
                    (const int*)ns_src_is_ns, (const int*)ns_wpos},
                   (const int*)wval};
  const cudaError_t e =
      out_on_chip
          ? launch_backtrace<true>(em, (const int*)order,
                                   (const uint8_t*)sel_ns, (int*)prefixes,
                                   (int*)times, B, T, K, L, chunk, smem_bytes,
                                   (cudaStream_t)stream)
          : launch_backtrace<false>(em, (const int*)order,
                                    (const uint8_t*)sel_ns, (int*)prefixes,
                                    (int*)times, B, T, K, L, chunk, smem_bytes,
                                    (cudaStream_t)stream);
  return (int)e;
}
