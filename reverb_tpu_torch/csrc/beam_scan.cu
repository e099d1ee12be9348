// CTC prefix beam search on Hopper: the forward frame scan and the
// backpointer walk.
//
// beam_scan_forward replaces the TPU kernel reverb_tpu/ops/beam_scan.py:
// _kernel (launched by beam_scan_forward).  It runs the whole sequential
// frame loop in one launch, each frame doing exactly
// reverb_tpu/decode/prefix_beam.py:_step for the unbiased search: the
// blank-run fold, the K×K2 extensions, the rolling-hash merge of a keep
// prefix into its matching extension, and the top-K over the (K, K2+1)
// candidates with ties going to the lowest flat index.  It writes one
// backpointer record per frame and the final beam state.
//
// beam_backtrace replaces reverb_tpu/ops/beam_scan.py:_bt_kernel (launched
// by beam_backtrace) and the scatter-max that follows it there: it walks
// the records from the last frame back to the first and writes each
// hypothesis's tokens and times.
//
// What bounds them on the H100: not bytes nor FLOPs — the scan is a chain
// of T dependent frame updates over ~110 candidates, so it is bound by
// latency (shared-memory round trips and block barriers per frame).  A
// plain PyTorch loop pays ~100 kernel launches per frame instead.  The
// design keeps the whole beam state (ten K-vectors) in shared memory for
// the life of the launch, gives each utterance its own block (the batch
// rows are independent), and spends one thread per candidate so a frame
// costs a handful of barriers.  The top-K is a rank count: each candidate
// counts the candidates that beat it (greater value, or equal value and
// lower index), which is exact and needs no sort.  The backtrace gives each
// (utterance, beam) pair one thread; since a thread owns its whole output
// row, the scatter-max needs no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;          // threads: >= K*(K2+1)
constexpr int MAXK = 16;
constexpr int MAXC = 128;        // max K*(K2+1)
constexpr uint32_t MULT1 = 0x9E3779B1u, MULT2 = 0x85EBCA77u;
constexpr uint32_t SEED1 = 0x12345679u, SEED2 = 0x87654321u;

__device__ __forceinline__ float log_add(float a, float b) {
  const float mx = fmaxf(a, b), mn = fminf(a, b);
  const float out = mx + log1pf(expf(mn - mx));
  return mx <= NEG_INF ? NEG_INF : out;
}

struct Emits {
  int *pfx_parent, *pfx_tok, *pfx_wpos, *s_src_beam, *s_src_is_ns,
      *ns_src_beam, *ns_src_is_ns, *ns_wpos, *wval;
};

__global__ void __launch_bounds__(NT) beam_scan_kernel(
    const float* __restrict__ logp, const int* __restrict__ idx,
    const int* __restrict__ ts, const uint8_t* __restrict__ valid,
    const float* __restrict__ bacc, const uint8_t* __restrict__ hskip,
    Emits em, float* fin_s, float* fin_ns, float* fin_vs, float* fin_vns,
    int* fin_plen, int B, int T, int K, int K2, int blank) {
  // beam state (persists across frames)
  __shared__ int st_plen[MAXK], st_last[MAXK];
  __shared__ uint32_t st_h1[MAXK], st_h2[MAXK];
  __shared__ float st_s[MAXK], st_ns[MAXK], st_vs[MAXK], st_vns[MAXK];
  // this frame's inputs
  __shared__ float f_lp[MAXK];
  __shared__ int f_ix[MAXK];
  // per-beam values after the blank-run fold
  __shared__ float b_s[MAXK], b_vs[MAXK], b_vns[MAXK];
  __shared__ float b_score[MAXK], b_vit[MAXK];
  __shared__ float b_keep_s[MAXK], b_keep_ns[MAXK], b_keep_vs[MAXK];
  __shared__ int b_vit_pre_ns[MAXK], b_sbank_pre_ns[MAXK], b_live[MAXK];
  __shared__ int b_matched[MAXK];
  // per extension cell (k, j)
  __shared__ float c_mrg_s[MAXC], c_mrg_ns[MAXC], c_mrg_vs[MAXC],
      c_mrg_vns[MAXC];
  __shared__ int c_midx[MAXC], c_hasm[MAXC], c_eqlast[MAXC];
  __shared__ float cand[MAXC];
  __shared__ int sel[MAXK];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = K2 + 1;
  const int KK2 = K * K2;
  const int NC = K * C;

  if (tid < K) {
    const bool active = tid == 0;
    st_plen[tid] = 0;
    st_last[tid] = -1;
    st_h1[tid] = active ? SEED1 : (uint32_t)tid + 7u;
    st_h2[tid] = active ? SEED2 : (uint32_t)tid + 13u;
    st_s[tid] = active ? 0.f : NEG_INF;
    st_ns[tid] = NEG_INF;
    st_vs[tid] = active ? 0.f : NEG_INF;
    st_vns[tid] = NEG_INF;
  }

  for (int t = 0; t < T; ++t) {
    const long long bt = (long long)b * T + t;
    const bool is_valid = valid[bt] != 0;
    const bool hs = hskip[bt] != 0;
    const float acc = bacc[bt];
    if (tid < K2) {
      f_lp[tid] = logp[bt * K2 + tid];
      f_ix[tid] = idx[bt * K2 + tid];
    }
    if (tid < K) b_matched[tid] = 0;
    __syncthreads();

    // ---- per beam: fold, keep entries ----
    if (tid < K) {
      const int k = tid;
      float s = st_s[k], ns = st_ns[k], vs = st_vs[k], vns = st_vns[k];
      const bool pre_sel_ns = !(vs > vns);
      if (hs) {
        s = log_add(s, ns) + acc;
        vs = fmaxf(vs, vns) + acc;
        ns = NEG_INF;
        vns = NEG_INF;
      }
      const bool sbank_pre_ns = hs && pre_sel_ns;
      const float vit = fmaxf(vs, vns);
      const float score = log_add(s, ns);
      const bool post_sel_ns = !(vs > vns);
      float p_blank = (f_ix[0] == blank) ? f_lp[0] : NEG_INF;
      float p_last = (f_ix[0] == st_last[k]) ? f_lp[0] : NEG_INF;
      for (int j = 1; j < K2; ++j) {
        p_blank = fmaxf(p_blank, (f_ix[j] == blank) ? f_lp[j] : NEG_INF);
        p_last = fmaxf(p_last, (f_ix[j] == st_last[k]) ? f_lp[j] : NEG_INF);
      }
      const bool pb_dead = p_blank <= NEG_INF;
      b_s[k] = s;
      b_vs[k] = vs;
      b_vns[k] = vns;
      b_score[k] = score;
      b_vit[k] = vit;
      b_keep_s[k] = pb_dead ? NEG_INF : score + p_blank;
      b_keep_vs[k] = pb_dead ? NEG_INF : vit + p_blank;
      b_keep_ns[k] = (p_last <= NEG_INF) ? NEG_INF : ns + p_last;
      b_vit_pre_ns[k] = post_sel_ns || sbank_pre_ns;
      b_sbank_pre_ns[k] = sbank_pre_ns;
      b_live[k] = score > NEG_INF;
    }
    __syncthreads();

    // ---- per extension cell: extend, merge with its keep prefix ----
    if (tid < KK2) {
      const int k = tid / K2, j = tid % K2;
      const int uu = f_ix[j];
      const float pu = f_lp[j];
      const bool eq_last = uu == st_last[k];
      const float base = eq_last ? b_s[k] : b_score[k];
      const float v_base = eq_last ? b_vs[k] : b_vit[k];
      const bool dead = (base <= NEG_INF) || (uu == blank);
      const float ext_ns = dead ? NEG_INF : base + pu;
      const float ext_vns = (dead || v_base <= NEG_INF) ? NEG_INF : v_base + pu;
      const uint32_t inc = (uint32_t)uu + 1u;
      const uint32_t eh1 = st_h1[k] * MULT1 + inc;
      const uint32_t eh2 = st_h2[k] * MULT2 + inc;
      int hasm = 0, midx = 0;
      float mrg_s = NEG_INF, mrg_kns = NEG_INF, mrg_vs = NEG_INF;
      for (int i = 0; i < K; ++i) {
        if (st_h1[i] == eh1 && st_h2[i] == eh2 && !dead && b_live[i]) {
          hasm = 1;
          midx += i;
          mrg_s = b_keep_s[i];
          mrg_kns = b_keep_ns[i];
          mrg_vs = b_keep_vs[i];
          b_matched[i] = 1;
        }
      }
      const float mrg_ns = log_add(ext_ns, mrg_kns);
      float total = log_add(mrg_s, mrg_ns);
      if (dead && !hasm) total = NEG_INF;
      c_mrg_s[tid] = mrg_s;
      c_mrg_ns[tid] = mrg_ns;
      c_mrg_vs[tid] = mrg_vs;
      c_mrg_vns[tid] = ext_vns;
      c_midx[tid] = midx;
      c_hasm[tid] = hasm;
      c_eqlast[tid] = eq_last;
      cand[k * C + j] = total;
    }
    __syncthreads();
    if (tid < K) {
      cand[tid * C + K2] = (b_matched[tid] || !b_live[tid])
                               ? NEG_INF
                               : log_add(b_keep_s[tid], b_keep_ns[tid]);
    }
    __syncthreads();

    // ---- exact top-K by rank: (value desc, flat index asc) ----
    if (tid < NC) {
      const float v = cand[tid];
      int rank = 0;
      for (int c = 0; c < NC; ++c) {
        const float w = cand[c];
        rank += (w > v) || (w == v && c < tid);
      }
      if (rank < K) sel[rank] = tid;
    }
    __syncthreads();

    // ---- rebuild the K winners, emit backpointers ----
    int n_plen = 0, n_last = 0;
    uint32_t n_h1 = 0, n_h2 = 0;
    float n_s = 0.f, n_ns = 0.f, n_vs = 0.f, n_vns = 0.f;
    if (tid < K) {
      const int k = tid;
      const int c = sel[k];
      const int col = c % C;
      const bool is_ext = col < K2;
      const int parent = c / C;
      const int uu = is_ext ? col : 0;
      const int tok = f_ix[uu];
      const int cell = parent * K2 + uu;
      n_s = is_ext ? c_mrg_s[cell] : b_keep_s[parent];
      n_ns = is_ext ? c_mrg_ns[cell] : b_keep_ns[parent];
      n_vs = is_ext ? c_mrg_vs[cell] : b_keep_vs[parent];
      n_vns = is_ext ? c_mrg_vns[cell] : NEG_INF;
      const int plen_parent = st_plen[parent];
      n_plen = plen_parent + (is_ext ? 1 : 0);
      n_last = is_ext ? tok : st_last[parent];
      const uint32_t inc = (uint32_t)max(tok, 0) + 1u;
      n_h1 = is_ext ? st_h1[parent] * MULT1 + inc : st_h1[parent];
      n_h2 = is_ext ? st_h2[parent] * MULT2 + inc : st_h2[parent];

      const int m_sel = c_midx[cell];
      const bool hasm_sel = c_hasm[cell] != 0;
      const int ts_parent = is_ext ? (hasm_sel ? m_sel : parent) : parent;
      // a multi-match index sum can leave [0, K): read as 0, like the
      // reference's one-hot gather
      const bool ts_in = ts_parent >= 0 && ts_parent < K;
      const bool s_src_is_ns = ts_in ? b_vit_pre_ns[ts_parent] != 0 : false;
      const bool rep_tok = c_eqlast[cell] != 0;
      const bool ext_src_is_ns = rep_tok ? b_sbank_pre_ns[parent] != 0
                                         : b_vit_pre_ns[parent] != 0;
      const int tns = is_ext ? m_sel : parent;
      const bool tns_in = tns >= 0 && tns < K;
      const float kns_t = tns_in ? b_keep_ns[tns] : 0.f;
      const float vns_t = tns_in ? b_vns[tns] : 0.f;
      const int plen_t = tns_in ? st_plen[tns] : 0;
      const bool repeat_fired = kns_t > NEG_INF && vns_t > NEG_INF;
      const int keep_wpos = repeat_fired ? max(plen_t - 1, 0) : -1;
      const int ns_src_beam = is_ext ? parent : tns;
      const bool ns_src_is_ns = !is_ext || ext_src_is_ns;
      const int ns_wpos = is_ext ? plen_parent : keep_wpos;
      const int pfx_wpos = is_ext ? plen_parent : -1;

      const long long o = ((long long)t * B + b) * K + k;
      em.pfx_parent[o] = is_valid ? parent : k;
      em.pfx_tok[o] = tok;
      em.pfx_wpos[o] = is_valid ? pfx_wpos : -1;
      em.s_src_beam[o] = is_valid ? ts_parent : k;
      em.s_src_is_ns[o] = is_valid && s_src_is_ns;
      em.ns_src_beam[o] = is_valid ? ns_src_beam : k;
      em.ns_src_is_ns[o] = !is_valid || ns_src_is_ns;
      em.ns_wpos[o] = is_valid ? ns_wpos : -1;
      if (k == 0) em.wval[(long long)t * B + b] = ts[bt];
    }
    __syncthreads();   // every read of the old state is done
    if (tid < K && is_valid) {
      st_plen[tid] = n_plen;
      st_last[tid] = n_last;
      st_h1[tid] = n_h1;
      st_h2[tid] = n_h2;
      st_s[tid] = n_s;
      st_ns[tid] = n_ns;
      st_vs[tid] = n_vs;
      st_vns[tid] = n_vns;
    }
    __syncthreads();
  }

  if (tid < K) {
    const int o = b * K + tid;
    fin_s[o] = st_s[tid];
    fin_ns[o] = st_ns[tid];
    fin_vs[o] = st_vs[tid];
    fin_vns[o] = st_vns[tid];
    fin_plen[o] = st_plen[tid];
  }
}

__global__ void beam_backtrace_kernel(Emits em, const int* __restrict__ order,
                                      const uint8_t* __restrict__ sel_ns,
                                      int* prefixes, int* times, int B, int T,
                                      int K, int L) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= B * K) return;
  const int b = g / K;
  int* pre = prefixes + (long long)g * L;
  int* tim = times + (long long)g * L;
  for (int i = 0; i < L; ++i) {
    pre[i] = 0;
    tim[i] = 0;
  }
  int cur_p = order[g], cur_tb = order[g];
  bool cur_ns = sel_ns[g] != 0;
  for (int t = T - 1; t >= 0; --t) {
    const long long row = ((long long)t * B + b) * K;
    const int p_pos = em.pfx_wpos[row + cur_p];
    if (p_pos >= 0 && p_pos < L)
      pre[p_pos] = max(pre[p_pos], em.pfx_tok[row + cur_p]);
    const int nxt_p = em.pfx_parent[row + cur_p];
    int nxt_tb;
    bool nxt_ns;
    if (cur_ns) {
      const int wpos = em.ns_wpos[row + cur_tb];
      if (wpos >= 0 && wpos < L)
        tim[wpos] = max(tim[wpos], em.wval[(long long)t * B + b]);
      nxt_tb = em.ns_src_beam[row + cur_tb];
      nxt_ns = em.ns_src_is_ns[row + cur_tb] != 0;
    } else {
      nxt_tb = em.s_src_beam[row + cur_tb];
      nxt_ns = em.s_src_is_ns[row + cur_tb] != 0;
    }
    cur_p = nxt_p;
    cur_tb = nxt_tb;
    cur_ns = nxt_ns;
  }
}

}  // namespace

// Layouts: logp/idx (B,T,K2) f32/i32; ts/bacc (B,T) i32/f32; valid/hskip
// (B,T) bool; the eight emit arrays (T,B,K) i32; wval (T,B) i32; finals
// (B,K).  Returns cudaError_t.
extern "C" int reverb_beam_scan_forward(
    const void* logp, const void* idx, const void* ts, const void* valid,
    const void* bacc, const void* hskip, void* pfx_parent, void* pfx_tok,
    void* pfx_wpos, void* s_src_beam, void* s_src_is_ns, void* ns_src_beam,
    void* ns_src_is_ns, void* ns_wpos, void* wval, void* fin_s, void* fin_ns,
    void* fin_vs, void* fin_vns, void* fin_plen, int B, int T, int K, int K2,
    int blank_id, void* stream) {
  if (K < 1 || K > MAXK || K2 < 1 || K2 > MAXK || K * (K2 + 1) > MAXC)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Emits em{(int*)pfx_parent, (int*)pfx_tok, (int*)pfx_wpos,
           (int*)s_src_beam, (int*)s_src_is_ns, (int*)ns_src_beam,
           (int*)ns_src_is_ns, (int*)ns_wpos, (int*)wval};
  beam_scan_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const float*)logp, (const int*)idx, (const int*)ts,
      (const uint8_t*)valid, (const float*)bacc, (const uint8_t*)hskip, em,
      (float*)fin_s, (float*)fin_ns, (float*)fin_vs, (float*)fin_vns,
      (int*)fin_plen, B, T, K, K2, blank_id);
  return (int)cudaGetLastError();
}

// order (B,K) i32, sel_ns (B,K) bool → prefixes/times (B,K,L) i32.
extern "C" int reverb_beam_backtrace(
    const void* pfx_parent, const void* pfx_tok, const void* pfx_wpos,
    const void* s_src_beam, const void* s_src_is_ns, const void* ns_src_beam,
    const void* ns_src_is_ns, const void* ns_wpos, const void* wval,
    const void* order, const void* sel_ns, void* prefixes, void* times, int B,
    int T, int K, int L, void* stream) {
  if (B * K == 0) return 0;
  Emits em{(int*)pfx_parent, (int*)pfx_tok, (int*)pfx_wpos,
           (int*)s_src_beam, (int*)s_src_is_ns, (int*)ns_src_beam,
           (int*)ns_src_is_ns, (int*)ns_wpos, (int*)wval};
  const int threads = 64;
  const int blocks = (B * K + threads - 1) / threads;
  beam_backtrace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      em, (const int*)order, (const uint8_t*)sel_ns, (int*)prefixes,
      (int*)times, B, T, K, L);
  return (int)cudaGetLastError();
}
