"""Batched CTC prefix beam search over per-frame top-k candidates.

Counterpart of reverb_tpu/decode/prefix_beam.py (the search, unbiased and
with in-beam context biasing, its top-k and dense entry points).  Same
state, same backpointer records, same tie rules:

 * prefixes are identified by a pair of uint32 rolling hashes; a keep prefix
   that equals an extension of another beam is merged into that extension;
 * the state is O(K) per utterance; each frame emits (K,) backpointers and
   the (K, L) token/time matrices are rebuilt after the scan;
 * `blank_skip_threshold` folds runs of blank-dominated frames into their
   successor exactly (`_compress_blanks`).

`_step` and `_backtrace` below are the plain PyTorch versions of kernels K2
(K2b with context biasing) and K3 (ops/beam_scan.py); they work on a
(B, ...) batch of utterances.  Context biasing (a `decode/context_graph.
ContextGraph`) adds two carried values per beam, its trie state `ctx` and
its cumulative bonus `cum`: an extension's bonus enters the pruning totals
only, and the final order is by score + cum, while the reported score takes
the finalize backoff −node_score[ctx] instead of cum.
uint32 arithmetic is not available for CPU tensors, so the hashes live in
int64 masked to 32 bits.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.ops.topk import topk_lastdim

NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_MULT1 = 0x9E3779B1
_MULT2 = 0x85EBCA77
_SEED1 = 0x12345679
_SEED2 = 0x87654321

STATE_KEYS = ('plen', 'last', 'h1', 'h2', 's', 'ns', 'v_s', 'v_ns')
# the biased search's two extra per-beam values: trie state, bonus
CTX_KEYS = ('ctx', 'cum')
EMIT_KEYS = ('pfx_parent', 'pfx_tok', 'pfx_wpos', 's_src_beam',
             's_src_is_ns', 'ns_src_beam', 'ns_src_is_ns', 'ns_wpos')


def _log_add(a, b):
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    out = mx + torch.log1p(torch.exp(mn - mx))
    return torch.where(mx <= NEG_INF, torch.full_like(out, NEG_INF), out)


def _mul32(h, mult: int):
    """(h · mult) mod 2³² for 0 ≤ h < 2³² held in int64: the multiplier is
    split in 16-bit halves so no partial product reaches the sign bit."""
    lo = h * (mult & 0xFFFF)
    hi = ((h * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _child_hash(h1, h2, u):
    uu = u.to(torch.int64) + 1
    return ((_mul32(h1, _MULT1) + uu) & _MASK32,
            (_mul32(h2, _MULT2) + uu) & _MASK32)


def _take(v, idx):
    """v[b, idx[b, k]] for (B, N) v and (B, K) idx; out-of-range indices read
    0 (the reference's one-hot gather)."""
    n = v.shape[1]
    ok = (idx >= 0) & (idx < n)
    g = torch.gather(v, 1, idx.clamp(0, n - 1).to(torch.int64))
    return torch.where(ok, g, torch.zeros_like(g))


def _init_state(B: int, K: int, device, biased: bool = False) -> dict:
    """The empty prefix in beam 0; with `biased` the trie state (root, 0)
    and bonus (0) of every beam too."""
    ix = torch.arange(K, device=device, dtype=torch.int64)
    active = (ix == 0)[None, :].expand(B, K)
    f32 = torch.float32
    neg = torch.full((B, K), NEG_INF, dtype=f32, device=device)
    zero = torch.zeros((B, K), dtype=f32, device=device)
    ctx = {'ctx': torch.zeros((B, K), dtype=torch.int32, device=device),
           'cum': zero.clone()} if biased else {}
    return {**ctx, 
        'plen': torch.zeros((B, K), dtype=torch.int32, device=device),
        'last': torch.full((B, K), -1, dtype=torch.int32, device=device),
        # dead beams get distinct sentinel hashes so they never merge
        'h1': torch.where(active, _SEED1, ix + 7),
        'h2': torch.where(active, _SEED2, ix + 13),
        's': torch.where(active, zero, neg),
        'ns': neg.clone(),
        'v_s': torch.where(active, zero, neg),
        'v_ns': neg.clone(),
    }


def _step(state: dict, topk_logp, topk_idx, t, valid, blank_acc, has_skip,
          K: int, blank_id: int, ctx_tables=None):
    """One frame for a batch of utterances.  topk_logp/topk_idx (B, K2);
    t/valid/blank_acc/has_skip (B,).  `ctx_tables` None, or (next_tab
    (S, V) i32, score_tab (S, V) f32) of a context graph, with ctx/cum in
    the state.  Returns (new_state, emits (B, K))."""
    B, K2 = topk_logp.shape
    dev = topk_logp.device
    C = K2 + 1
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    beam_ix = torch.arange(K, dtype=torch.int32, device=dev)[None, :].expand(
        B, K)
    validk = valid[:, None].expand(B, K)
    hskipk = has_skip[:, None].expand(B, K)
    s, ns, v_s, v_ns = state['s'], state['ns'], state['v_s'], state['v_ns']
    plen, last, h1, h2 = state['plen'], state['last'], state['h1'], state['h2']

    # fold a preceding run of skipped blank-dominated frames
    pre_sel_ns = ~(v_s > v_ns)
    col_s = _log_add(s, ns) + blank_acc[:, None]
    col_v_s = torch.maximum(v_s, v_ns) + blank_acc[:, None]
    s = torch.where(hskipk, col_s, s)
    ns = torch.where(hskipk, neg, ns)
    v_s = torch.where(hskipk, col_v_s, v_s)
    v_ns = torch.where(hskipk, neg, v_ns)
    s_bank_pre_is_ns = hskipk & pre_sel_ns

    viterbi = torch.maximum(v_s, v_ns)
    score = _log_add(s, ns)
    post_sel_ns = ~(v_s > v_ns)
    vit_pre_is_ns = post_sel_ns | s_bank_pre_is_ns

    # keep entries: blank / repeated-last updates
    is_blank_col = topk_idx == blank_id
    p_blank = torch.where(is_blank_col, topk_logp, neg).amax(-1)      # (B,)
    eq_last = last[:, :, None] == topk_idx[:, None, :]                # (B,K,K2)
    p_last = torch.where(eq_last, topk_logp[:, None, :], neg).amax(-1)
    pb_dead = (p_blank <= NEG_INF)[:, None]
    keep_s = torch.where(pb_dead, neg, score + p_blank[:, None])
    keep_v_s = torch.where(pb_dead, neg, viterbi + p_blank[:, None])
    keep_ns = torch.where(p_last <= NEG_INF, neg, ns + p_last)
    # a keep entry's viterbi ns-score stays -inf (reference typo semantics,
    # see reverb_tpu/decode/prefix_beam.py:_step)
    keep_v_ns = torch.full_like(keep_s, NEG_INF)

    # extend entries (K beams × K2 tokens)
    u = topk_idx[:, None, :].expand(B, K, K2)
    pu = topk_logp[:, None, :]
    u_is_blank = u == blank_id
    u_eq_last = eq_last
    base = torch.where(u_eq_last, s[:, :, None], score[:, :, None])
    ext_ns = base + pu
    ext_v_base = torch.where(u_eq_last, v_s[:, :, None], viterbi[:, :, None])
    ext_v_ns = ext_v_base + pu
    dead = (base <= NEG_INF) | u_is_blank
    ext_ns = torch.where(dead, neg, ext_ns)
    ext_v_ns = torch.where(dead | (ext_v_base <= NEG_INF), neg, ext_v_ns)
    eh1, eh2 = _child_hash(h1[:, :, None], h2[:, :, None], u)

    # merge each keep entry into its (unique) matching extend entry
    live_keep = score > NEG_INF
    mi = ((h1[:, :, None, None] == eh1[:, None]) &
          (h2[:, :, None, None] == eh2[:, None]) &
          ~dead[:, None] & live_keep[:, :, None, None])     # (B, i, K, K2)
    has_m = mi.any(1)
    i_ix = torch.arange(K, device=dev, dtype=torch.int32)[None, :, None, None]
    m_idx = (mi.to(torch.int32) * i_ix).sum(1, dtype=torch.int32)
    # the last matching keep row wins (the reference's loop order)
    m_last = torch.where(mi, i_ix, -1).amax(1)
    m_gather = m_last.clamp(min=0).reshape(B, K * K2).to(torch.int64)

    def _mrg(v):
        g = torch.gather(v, 1, m_gather).reshape(B, K, K2)
        return torch.where(has_m, g, neg)
    mrg_s, mrg_keep_ns, mrg_v_s = _mrg(keep_s), _mrg(keep_ns), _mrg(keep_v_s)
    matched_to_ext = mi.flatten(2).any(-1)
    mrg_ns = _log_add(ext_ns, mrg_keep_ns)
    mrg_v_ns = ext_v_ns
    ext_total = _log_add(mrg_s, mrg_ns)
    ext_total = torch.where(dead & ~has_m, neg, ext_total)
    keep_total = torch.where(matched_to_ext | ~live_keep, neg,
                             _log_add(keep_s, keep_ns))

    # context biasing: the bonus enters the PRUNING totals only; a keep
    # entry carries its state and bonus unchanged (the trie state is a
    # function of the prefix, so a merged keep+extend entry gets the same
    # state from either path)
    if ctx_tables is not None:
        next_tab, score_tab = ctx_tables
        cum = state['cum']
        addr = (state['ctx'].to(torch.int64)[:, :, None] * next_tab.shape[1]
                + u.to(torch.int64))
        ctx_ext = next_tab.reshape(-1)[addr]                # (B, K, K2)
        bonus_ext = score_tab.reshape(-1)[addr]
        ext_prune = torch.where(ext_total <= NEG_INF, neg,
                                (ext_total + cum[:, :, None]) + bonus_ext)
        keep_prune = torch.where(keep_total <= NEG_INF, neg, keep_total + cum)
    else:
        ext_prune, keep_prune = ext_total, keep_total

    # second beam prune: flat row-major top-K over (K, K2+1), ties to the
    # lowest flat index
    cand = torch.cat([ext_prune, keep_prune[:, :, None]], 2).reshape(B, -1)
    top_idx = topk_lastdim(cand, K)[1].to(torch.int32)
    col = top_idx % C
    is_ext = col < K2
    parent = top_idx // C
    uu = torch.where(is_ext, col, torch.zeros_like(col))
    tok = _take(topk_idx, uu)
    cell = parent * K2 + uu

    def flat(a):
        return _take(a.reshape(B, K * K2), cell)

    new_s = torch.where(is_ext, flat(mrg_s), _take(keep_s, parent))
    new_ns = torch.where(is_ext, flat(mrg_ns), _take(keep_ns, parent))
    new_v_s = torch.where(is_ext, flat(mrg_v_s), _take(keep_v_s, parent))
    new_v_ns = torch.where(is_ext, flat(mrg_v_ns), _take(keep_v_ns, parent))

    plen_parent = _take(plen, parent)
    new_plen = plen_parent + is_ext.to(torch.int32)
    new_last = torch.where(is_ext, tok, _take(last, parent))
    ph1, ph2 = _take(h1, parent), _take(h2, parent)
    ch1, ch2 = _child_hash(ph1, ph2, tok.clamp(min=0))
    new_h1 = torch.where(is_ext, ch1, ph1)
    new_h2 = torch.where(is_ext, ch2, ph2)

    # backpointer emits
    m_sel = flat(m_idx)
    hasm_sel = flat(has_m)
    ts_parent = torch.where(is_ext, torch.where(hasm_sel, m_sel, parent),
                            parent)
    s_src_is_ns = _take(vit_pre_is_ns, ts_parent)
    rep_tok = flat(u_eq_last)
    ext_src_is_ns = ((rep_tok & _take(s_bank_pre_is_ns, parent)) |
                     (~rep_tok & _take(vit_pre_is_ns, parent)))
    tns_parent = torch.where(is_ext, m_sel, parent)
    repeat_fired = ((_take(keep_ns, tns_parent) > NEG_INF) &
                    (_take(v_ns, tns_parent) > NEG_INF))
    keep_wpos = torch.where(repeat_fired,
                            (_take(plen, tns_parent) - 1).clamp(min=0),
                            torch.full_like(parent, -1))
    ext_win = is_ext
    ns_src_beam = torch.where(ext_win, parent, tns_parent)
    ns_src_is_ns = ~ext_win | ext_src_is_ns
    ns_wpos = torch.where(ext_win, plen_parent, keep_wpos)
    pfx_wpos = torch.where(is_ext, plen_parent, torch.full_like(parent, -1))

    new_state = {'plen': new_plen, 'last': new_last, 'h1': new_h1,
                 'h2': new_h2, 's': new_s, 'ns': new_ns, 'v_s': new_v_s,
                 'v_ns': new_v_ns}
    if ctx_tables is not None:
        new_state['ctx'] = torch.where(is_ext, flat(ctx_ext),
                                       _take(state['ctx'], parent))
        new_state['cum'] = _take(state['cum'], parent) + torch.where(
            is_ext, flat(bonus_ext), torch.zeros_like(cum))
    # frozen steps (past the utterance's length) are true no-ops
    merged = {n: torch.where(validk, v, state[n])
              for n, v in new_state.items()}
    minus1 = torch.full_like(parent, -1)
    emit = {
        'pfx_parent': torch.where(validk, parent, beam_ix),
        'pfx_tok': tok,
        'pfx_wpos': torch.where(validk, pfx_wpos, minus1),
        's_src_beam': torch.where(validk, ts_parent, beam_ix),
        's_src_is_ns': validk & s_src_is_ns,
        'ns_src_beam': torch.where(validk, ns_src_beam, beam_ix),
        'ns_src_is_ns': ~validk | ns_src_is_ns,
        'ns_wpos': torch.where(validk, ns_wpos, minus1),
    }
    emit = {n: v.to(torch.int32) for n, v in emit.items()}
    emit['wval'] = t.to(torch.int32)
    return merged, emit


def _backtrace(emits: dict, order, final_sel_ns, L: int):
    """Rebuild (B, K, L) prefixes and times from the (T, B, K) backpointers
    by a reverse walk and a scatter-max (zero-initialized).  `order` (B, K)
    selects and orders the final beams; final_sel_ns (B, K) their bank."""
    T, B, K = emits['pfx_parent'].shape
    dev = order.device
    cur_p = order.to(torch.int64)
    cur_tb = cur_p
    cur_ns = final_sel_ns.to(torch.bool)
    p_pos, p_tok, wpos = [], [], []
    for t in range(T - 1, -1, -1):
        def at(name, idx):
            return torch.gather(emits[name][t].to(torch.int64), 1, idx)
        p_pos.append(at('pfx_wpos', cur_p))
        p_tok.append(at('pfx_tok', cur_p))
        nxt_p = at('pfx_parent', cur_p)
        wpos.append(torch.where(cur_ns, at('ns_wpos', cur_tb), -1))
        nxt_tb = torch.where(cur_ns, at('ns_src_beam', cur_tb),
                             at('s_src_beam', cur_tb))
        nxt_ns = torch.where(cur_ns, at('ns_src_is_ns', cur_tb),
                             at('s_src_is_ns', cur_tb)) != 0
        cur_p, cur_tb, cur_ns = nxt_p, nxt_tb, nxt_ns
    p_pos = torch.stack(p_pos[::-1], 2)                    # (B, K, T)
    p_tok = torch.stack(p_tok[::-1], 2)
    wpos = torch.stack(wpos[::-1], 2)
    wval = emits['wval'].to(torch.int64).t()[:, None, :].expand(B, K, T)

    def scatter_max(pos, val):
        # -1 (and out-of-range) positions go to a spill column, dropped
        pos = torch.where((pos >= 0) & (pos < L), pos, L)
        out = torch.zeros((B, K, L + 1), dtype=torch.int64, device=dev)
        out = out.scatter_reduce(2, pos, val, 'amax', include_self=True)
        return out[:, :, :L].to(torch.int32)
    return scatter_max(p_pos, p_tok), scatter_max(wpos, wval)


def _search_batched(topk_logp, topk_idx, num_t, K: int, blank_id: int,
                    L: int, ts=None, blank_acc=None, has_skip=None,
                    tail_acc=None, ctx_tables=None):
    """Batched search over (B, T, K2) inputs through kernels K2 (K2b with
    `ctx_tables`) and K3, or their plain versions for CPU tensors.
    `ts`/`blank_acc`/`has_skip` are (B, T) from `_compress_blanks`, or None
    for the dense path; `ctx_tables` None or (next_tab, score_tab,
    node_score) of `_graph_tables`.
    Returns (prefixes (B,K,L), plens (B,K), scores (B,K), times (B,K,L))."""
    from reverb_tpu_torch.ops.beam_scan import (beam_backtrace,
                                                beam_scan_forward)
    B, T, _ = topk_logp.shape
    dev = topk_logp.device
    valid = (torch.arange(T, device=dev)[None, :]
             < num_t.to(dev)[:, None])
    if ts is None:
        ts = torch.arange(T, dtype=torch.int32,
                          device=dev)[None].expand(B, T).contiguous()
        blank_acc = torch.zeros((B, T), dtype=torch.float32, device=dev)
        has_skip = torch.zeros((B, T), dtype=torch.bool, device=dev)
    tail = (torch.zeros((B,), dtype=torch.float32, device=dev)
            if tail_acc is None else tail_acc)
    biased = {} if ctx_tables is None else {'ctx_tables': ctx_tables[:2]}
    final, em = beam_scan_forward(topk_logp, topk_idx, ts, valid, blank_acc,
                                  has_skip, K, blank_id, **biased)
    total = _log_add(final['s'], final['ns']) + tail[:, None]
    if ctx_tables is not None:
        # the reference's final rule (search.py:227-233): order by acoustic
        # + accumulated bonus, report acoustic − node_score[ctx] (the
        # finalize backoff)
        order = torch.argsort(-(total + final['cum']), dim=-1, stable=True)
        total = total - ctx_tables[2][final['ctx'].to(torch.int64)]
    else:
        order = torch.argsort(-total, dim=-1, stable=True)
    sel_ns = torch.gather(~(final['v_s'] > final['v_ns']), 1, order)
    prefixes, times = beam_backtrace(em, order.to(torch.int32), sel_ns, L)
    plens = torch.gather(final['plen'], 1, order)
    return prefixes, plens, torch.gather(total, 1, order), times


def _compress_blanks(p_blank, ctc_lens, threshold: float, keep_cap: int):
    """Keep frames with p(blank) ≤ threshold; fold each skipped run's blank
    log-mass into the next kept frame.  p_blank: (B, T) log p(blank).
    Returns (ts, n_keep, blank_acc, has_skip, tail_acc), static length
    keep_cap."""
    B, T = p_blank.shape
    dev = p_blank.device
    in_range = (torch.arange(T, device=dev)[None, :]
                < ctc_lens.to(dev)[:, None])
    log_th = torch.log(torch.tensor(threshold, dtype=torch.float32))
    keep = (p_blank <= log_th.to(dev)) & in_range
    skipped_mass = torch.where(~keep & in_range, p_blank,
                               torch.zeros_like(p_blank))
    csum = torch.cumsum(skipped_mass, dim=1)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    ts = order[:, :keep_cap]
    n_keep = keep.sum(1)
    c_at = torch.gather(csum, 1, ts) - torch.gather(skipped_mass, 1, ts)
    prev_c = torch.cat([torch.zeros((B, 1), dtype=torch.float32, device=dev),
                        c_at[:, :-1]], 1)
    blank_acc = c_at - prev_c
    has_skip = blank_acc < 0.0
    total_skip = csum[:, -1]
    n_keep_c = torch.clamp(n_keep, max=keep_cap)
    last_c = torch.where(
        n_keep_c > 0,
        torch.gather(c_at, 1, (n_keep_c - 1).clamp(min=0)[:, None])[:, 0],
        torch.zeros_like(total_skip))
    tail_acc = total_skip - last_c
    return ts.to(torch.int32), n_keep_c.to(torch.int32), blank_acc, \
        has_skip, tail_acc


def ctc_prefix_beam_search_device_topk(topk_logp, topk_idx, blank_logp,
                                       ctc_lens, beam_size: int,
                                       blank_id: int = 0, max_tokens: int = 0,
                                       blank_skip_threshold: float = 0.0,
                                       keep_cap: int = 0, ctx_tables=None):
    """Batched search from per-frame top-k (models.ctc.ctc_topk_logprobs).
    topk_logp (B,T,K2) f32, topk_idx (B,T,K2) i32, blank_logp (B,T);
    ctx_tables None or `_graph_tables` of a context graph.
    Returns (prefixes (B,K,L), plens (B,K), scores (B,K), times (B,K,L))."""
    T = topk_logp.shape[1]
    L = max_tokens or T
    topk_logp = topk_logp.to(torch.float32).contiguous()
    topk_idx = topk_idx.to(torch.int32).contiguous()
    if blank_skip_threshold > 0.0:
        cap = keep_cap or T
        # a prefix grows by at most one token per kept frame
        L = min(L, cap)
        ts, n_keep, blank_acc, has_skip, tail_acc = _compress_blanks(
            blank_logp.to(torch.float32), ctc_lens, blank_skip_threshold,
            cap)
        gidx = ts.to(torch.int64)[..., None].expand(-1, -1,
                                                    topk_logp.shape[2])
        g_logp = torch.gather(topk_logp, 1, gidx)
        g_idx = torch.gather(topk_idx, 1, gidx)
        # scan-length bucketing: run the half-length scan when every row's
        # kept-frame count fits (frames past n_keep are frozen either way)
        half = cap // 2
        Tb = cap
        if half >= 16 and int(n_keep.max()) <= half:
            Tb = half
        return _search_batched(
            g_logp[:, :Tb].contiguous(), g_idx[:, :Tb].contiguous(),
            torch.clamp(n_keep, max=Tb), beam_size, blank_id, L,
            ts[:, :Tb].contiguous(), blank_acc[:, :Tb].contiguous(),
            has_skip[:, :Tb].contiguous(), tail_acc, ctx_tables)
    return _search_batched(topk_logp, topk_idx, ctc_lens, beam_size,
                           blank_id, L, ctx_tables=ctx_tables)


def _graph_tables(context_graph, vocab_size: int, device):
    """(next_tab (S, V) i32, score_tab (S, V) f32, node_score (S,) f32) of
    a ContextGraph on `device`, built once and cached on the graph."""
    if context_graph is None:
        return None
    key = f'_device_tables_{vocab_size}_{torch.device(device)}'
    cached = getattr(context_graph, key, None)
    if cached is None:
        cached = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in context_graph.device_tables(vocab_size))
        setattr(context_graph, key, cached)
    return cached


def ctc_prefix_beam_search_raw(ctc_probs, ctc_lens, beam_size: int,
                               blank_id: int = 0,
                               blank_skip_threshold: float = 0.0,
                               context_graph=None):
    """`ctc_prefix_beam_search_topk_raw` over a dense (B, T, V) log-prob
    table: each frame's top beam_size tokens (ties to the lowest index) and
    p(blank) feed `ctc_prefix_beam_search_device_topk` with L = T."""
    ctc_probs = ctc_probs.to(torch.float32)
    keep_cap = (ctc_probs.shape[1] // 2) if blank_skip_threshold > 0 else 0
    topk_logp, topk_idx = topk_lastdim(ctc_probs, beam_size)
    out = ctc_prefix_beam_search_device_topk(
        topk_logp, topk_idx, ctc_probs[:, :, blank_id], ctc_lens, beam_size,
        blank_id, 0, blank_skip_threshold, keep_cap,
        _graph_tables(context_graph, ctc_probs.shape[-1], ctc_probs.device))
    return _pack_results(*out), out


def ctc_prefix_beam_search_topk_raw(topk_logp, topk_idx, blank_logp,
                                    ctc_lens, beam_size: int,
                                    blank_id: int = 0,
                                    blank_skip_threshold: float = 0.0,
                                    context_graph=None, vocab_size: int = 0):
    """The search with no cap on the hypothesis length (L = T, or the keep
    cap under blank-skip): the packed DecodeResults and the raw device tuple
    (prefixes, plens, scores, times), which the rescorer takes as it is.
    Context biasing (`context_graph`) needs the vocabulary size."""
    keep_cap = (topk_logp.shape[1] // 2) if blank_skip_threshold > 0 else 0
    ctx_tables = None
    if context_graph is not None:
        if vocab_size <= 0:
            raise ValueError('context biasing needs vocab_size')
        ctx_tables = _graph_tables(context_graph, vocab_size,
                                   topk_logp.device)
    out = ctc_prefix_beam_search_device_topk(
        topk_logp, topk_idx, blank_logp, ctc_lens, beam_size, blank_id, 0,
        blank_skip_threshold, keep_cap, ctx_tables)
    return _pack_results(*out), out


def _pack_results(prefixes, plens, scores, times) -> List[DecodeResult]:
    """Host packing of the beam buffers into DecodeResults with nbest."""
    prefixes, plens, scores, times = (
        x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        for x in (prefixes, plens, scores, times))
    results = []
    for b in range(prefixes.shape[0]):
        nbest, nbest_scores, nbest_times = [], [], []
        for k in range(prefixes.shape[1]):
            if scores[b, k] <= float(NEG_INF) / 2:
                continue
            n = int(plens[b, k])
            nbest.append(prefixes[b, k, :n].tolist())
            nbest_scores.append(float(scores[b, k]))
            nbest_times.append(times[b, k, :n].tolist())
        if not nbest:
            nbest, nbest_scores, nbest_times = [[]], [0.0], [[]]
        results.append(DecodeResult(
            tokens=nbest[0], score=nbest_scores[0], times=nbest_times[0],
            nbest=nbest, nbest_scores=nbest_scores, nbest_times=nbest_times))
    return results

