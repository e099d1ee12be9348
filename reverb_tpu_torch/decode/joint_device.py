"""Joint time-synchronous CTC+attention one-pass decoding, batched on the
device.

Counterpart of reverb_tpu/decode/joint_device.py (`_joint_search_one`,
`joint_decoding_device`); the reference vmaps one utterance's `lax.scan`
over the batch, here every tensor carries the batch and the scan is a
per-frame loop.  Per frame and utterance:

 * frames whose argmax is blank with p(blank) ≥ blank_threshold are
   dropped up front (a stable compaction: the kept frames first, in order);
 * the pre-beam takes the frame's top P = pre_beam_ratio·K tokens;
 * each beam's (p_nb, p_b) CTC DP, with a prefix pruned last frame brought
   back from the carried hash → dp table of the previous frame's expansion
   set (the prefix beam's rolling hash, decode/prefix_beam.py);
 * joint score = ctc_w·ctc + (1 − ctc_w)·att + length_bonus·len, and the
   top K of the K stay entries and K·P extensions;
 * one batched decoder step for the K selected beams, whose (V,)
   next-token log-probs make the next frame's attention scores a gather.

Timestamps follow the reference's device path (its docstring names where it
differs from the host loop of decode/joint.py).  Every top-k breaks ties to
the lowest index (ops/topk.py).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from reverb_tpu_torch.decode.prefix_beam import (_SEED1, _SEED2, NEG_INF,
                                                 _child_hash, _log_add)
from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.ops.topk import topk_lastdim


def _frame_order(probs, lens, blank: int, log_thr: float):
    """(B, T) frame indices to scan, kept frames first in order and -1
    after them, and the (B,) kept counts."""
    B, T, _ = probs.shape
    dev = probs.device
    keep = torch.arange(T, device=dev)[None, :] < lens[:, None]
    if log_thr < 0.0:
        skip = ((torch.argmax(probs, dim=-1) == blank)
                & (probs[:, :, blank] >= log_thr))
        keep = keep & ~skip
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    n_valid = keep.sum(1)
    ts = torch.where(torch.arange(T, device=dev)[None, :] < n_valid[:, None],
                     order, -1)
    return ts, n_valid


class _JointSearch:
    """The batched search state of B utterances × K beams."""

    def __init__(self, model, encoder_outs, encoder_lens, V: int, K: int,
                 P: int, Lc: int, cat_embs):
        cfg = model.cfg
        B, T, _ = encoder_outs.shape
        dev = encoder_outs.device
        self.B, self.K, self.P, self.V, self.Lc = B, K, P, V, Lc
        self.blank = cfg.blank_id
        self.dec = model.decoder.left_decoder
        self.mem_kv = self.dec.cross_kv(encoder_outs)
        self.mem_mask = (torch.arange(T, device=dev)[None, :]
                         < encoder_lens[:, None])[:, None, :]
        self.cat = cat_embs if cfg.lsl_dec else None
        if self.cat is not None and self.cat.dim() == 2:
            self.cat = self.cat.repeat_interleave(K, 0)
        self.beam_ix = torch.arange(K, device=dev)[None, :].expand(B, K)
        self.row0 = torch.arange(B, device=dev)[:, None] * K
        i64, f32 = torch.int64, torch.float32
        alive = self.beam_ix == 0
        M = K + K * P
        neg = torch.full((B, K), NEG_INF, dtype=f32, device=dev)
        self.c = {
            'lens': torch.zeros((B, K), dtype=i64, device=dev),
            'buf': torch.zeros((B, K, Lc + 2), dtype=i64, device=dev),
            'h1': torch.where(alive, _SEED1, self.beam_ix + 7),
            'h2': torch.where(alive, _SEED2, self.beam_ix + 13),
            'dp': torch.stack([neg, torch.where(alive, 0.0, neg)], -1),
            'att_sum': torch.zeros((B, K), dtype=f32, device=dev),
            'times_s': torch.zeros((B, K, Lc), dtype=i64, device=dev),
            'times_e': torch.zeros((B, K, Lc), dtype=i64, device=dev),
            'conf_c': torch.full((B, K, Lc), NEG_INF, dtype=f32, device=dev),
            'conf_a': torch.full((B, K, Lc), NEG_INF, dtype=f32, device=dev),
            'child_start': torch.full((B, K, V), -1, dtype=i64, device=dev),
            'child_cmax': torch.full((B, K, V), NEG_INF, dtype=f32,
                                     device=dev),
            'prev_h1': torch.zeros((B, M), dtype=i64, device=dev),
            'prev_h2': torch.zeros((B, M), dtype=i64, device=dev),
            'prev_dp': torch.full((B, M, 2), NEG_INF, dtype=f32, device=dev),
            'prev_valid': torch.zeros((B, M), dtype=torch.bool, device=dev),
            'alive': alive,
            'scores': torch.where(alive, 0.0, -math.inf),
        }
        self.c['buf'][:, :, 0] = cfg.sos
        self.cache = self.dec.init_cache(B * K, Lc + 2, encoder_outs.dtype,
                                         dev)
        self.c['nsc'] = self._decoder_rows(self.c['buf'], self.c['lens'])

    def _decoder_rows(self, buf, lens):
        """The decoder at position lens of every beam (its last token):
        (B, K, V) next-token log-probs; writes the beams' k‖v rows."""
        B, K = self.B, self.K
        tok = torch.gather(buf, 2, lens[:, :, None])[:, :, 0]
        logp, self.cache = self.dec.forward_step(
            tok.reshape(-1), lens.reshape(-1), self.cache, self.mem_kv,
            self.mem_mask, K, self.cat)
        return logp.reshape(B, K, -1)

    def step(self, p, tt, ctc_w: float, penalty: float):
        """One frame: p (B, V) its log-probs, tt (B,) its index (-1: this
        utterance has no frame left, its state stays as it is)."""
        B, K, P, Lc = self.B, self.K, self.P, self.Lc
        c = self.c
        f32 = torch.float32
        neg = torch.tensor(NEG_INF, dtype=f32, device=p.device)
        blank = self.blank
        dec_w = 1.0 - ctc_w
        lens, buf, h1, h2 = c['lens'], c['buf'], c['h1'], c['h2']
        dp, att_sum, nsc, alive = c['dp'], c['att_sum'], c['nsc'], c['alive']
        t1 = tt[:, None]
        pblank = p[:, blank]
        cv, ci = topk_lastdim(p, P)                               # (B, P)
        blank_in = (ci == blank).any(1)[:, None]                  # (B, 1)
        last = torch.gather(buf, 2, lens[:, :, None])[:, :, 0]    # (B, K)
        p_last = torch.gather(p, 1, last)
        p_prev = _log_add(dp[..., 0], dp[..., 1])

        # ---- stay entries (the hyp itself) ----
        is_rep = ci[:, None, :] == last[:, :, None]               # (B, K, P)
        last_in = is_rep.any(-1)
        stay_pb = torch.where(blank_in, pblank[:, None] + p_prev, neg)
        stay_nb_self = torch.where(last_in, p_last + dp[..., 0], neg)
        stay_has_rep = last_in & alive

        # ---- extension entries (K, P) ----
        is_blank_c = (ci == blank)[:, None, :]
        ext_nb = torch.where(is_rep, dp[..., 1:2], p_prev[..., None]) \
            + cv[:, None, :]
        cik = ci[:, None, :].expand(B, K, P)
        ch1, ch2 = _child_hash(h1[..., None], h2[..., None], cik)
        # already a beam member?  (l_plus in hyps)
        eqb = ((ch1[..., None] == h1[:, None, None, :])
               & (ch2[..., None] == h2[:, None, None, :])
               & alive[:, None, None, :])                         # (B,K,P,K)
        in_beam = eqb.any(-1)
        # resurrection from last frame's expansion table
        eqp = ((ch1[..., None] == c['prev_h1'][:, None, None, :])
               & (ch2[..., None] == c['prev_h2'][:, None, None, :])
               & c['prev_valid'][:, None, None, :])               # (B,K,P,M)
        in_prev = eqp.any(-1)
        miss = torch.where(in_prev, 0.0, neg)
        pdp = c['prev_dp'][:, None, None]
        prev_nb = torch.where(eqp, pdp[..., 0], -0.0).sum(-1) + miss
        prev_pb = torch.where(eqp, pdp[..., 1], -0.0).sum(-1) + miss
        resurrect = ~in_beam & in_prev
        ext_nb = torch.where(resurrect,
                             _log_add(ext_nb, cv[:, None, :] + prev_nb),
                             ext_nb)
        ext_pb = torch.where(resurrect,
                             pblank[:, None, None] + _log_add(prev_nb,
                                                              prev_pb),
                             neg)
        ext_live = alive[..., None] & ~is_blank_c

        # ---- merge extensions that equal a CURRENT beam member ----
        merge = eqb & ext_live[..., None]                         # (B,K,P,K)
        stay_ext_nb = torch.where(merge, ext_nb[..., None],
                                  neg).amax(dim=(1, 2))           # (B, K)
        stay_has_ext = stay_ext_nb > NEG_INF / 2
        pc_of_ext = torch.where(merge, cv[:, None, :, None],
                                neg).amax(dim=(1, 2))
        stay_nb = _log_add(stay_nb_self, stay_ext_nb)
        stay_in_dict = (blank_in | stay_has_rep | stay_has_ext) & alive
        stay_in_newhyps = (blank_in | stay_has_ext) & alive
        ext_live = ext_live & ~in_beam

        # ---- per-beam time/conf mutations this frame ----
        lpos = torch.clamp(lens - 1, min=0)[..., None]
        mut = ((stay_has_rep | stay_has_ext) & (lens > 0))[..., None]
        te = c['times_e']
        te = te.scatter(2, lpos, torch.where(mut, t1[..., None] + 1,
                                             torch.gather(te, 2, lpos)))
        cc = c['conf_c']
        cc_at = torch.gather(cc, 2, lpos)[..., 0]
        new_cmax = torch.maximum(cc_at, torch.maximum(
            torch.where(stay_has_rep & (lens > 0), p_last, neg),
            torch.where(stay_has_ext & (lens > 0), pc_of_ext, neg)))
        cc = cc.scatter(2, lpos, torch.where(mut[..., 0], new_cmax,
                                             cc_at)[..., None])

        # ---- child history tables (proposal-time) ----
        cs, cm = c['child_start'], c['child_cmax']
        old_start = torch.gather(cs, 2, cik)
        cs = cs.scatter(2, cik, torch.where(
            ext_live, torch.where(old_start >= 0, old_start, t1[..., None]),
            old_start))
        old_cm = torch.gather(cm, 2, cik)
        cm = cm.scatter(2, cik, torch.where(
            ext_live, torch.maximum(old_cm, cv[:, None, :]), old_cm))

        # ---- scoring ----
        nsc_c = torch.gather(nsc, 2, cik)                         # (B, K, P)
        stay_score = (ctc_w * _log_add(stay_nb, stay_pb)
                      + torch.where(lens > 0, dec_w * att_sum, 0.0)
                      + penalty * lens)
        stay_score = torch.where(stay_in_newhyps, stay_score, -math.inf)
        ext_score = (ctc_w * _log_add(ext_nb, ext_pb)
                     + dec_w * (att_sum[..., None] + nsc_c)
                     + penalty * (lens[..., None] + 1))
        ext_score = torch.where(ext_live, ext_score, -math.inf)
        all_scores = torch.cat([stay_score, ext_score.reshape(B, K * P)], 1)
        sel_score, sel = topk_lastdim(all_scores, K)
        is_ext = sel >= K
        par = torch.where(is_ext, (sel - K) // P, sel)            # (B, K)
        cpos = torch.where(is_ext, (sel - K) % P, 0)
        ctok = torch.gather(ci, 1, cpos)
        cval = torch.gather(cv, 1, cpos)
        cell = par * P + cpos

        def g(x):
            idx = par.reshape(B, K, *([1] * (x.dim() - 2)))
            return torch.gather(x, 1, idx.expand(B, K, *x.shape[2:]))

        def at_cell(x):
            return torch.gather(x.reshape(B, K * P), 1, cell)

        def put(x, pos, val):
            return x.scatter(2, pos[..., None], torch.where(
                is_ext, val, torch.gather(x, 2, pos[..., None])[..., 0]
            )[..., None])

        new_alive = sel_score > -math.inf
        new_lens = g(lens) + is_ext.to(torch.int64)
        new_buf = put(g(buf), torch.clamp(new_lens, max=Lc + 1), ctok)
        ph1, ph2 = g(h1), g(h2)
        eh1, eh2 = _child_hash(ph1, ph2, ctok)
        # dead slots keep distinct sentinel hashes so they never merge
        new_h1 = torch.where(new_alive, torch.where(is_ext, eh1, ph1),
                             self.beam_ix + 7)
        new_h2 = torch.where(new_alive, torch.where(is_ext, eh2, ph2),
                             self.beam_ix + 13)
        sel_nb = torch.where(is_ext, at_cell(ext_nb), g(stay_nb))
        sel_pb = torch.where(is_ext, at_cell(ext_pb), g(stay_pb))
        new_att = g(att_sum) + torch.where(is_ext, at_cell(nsc_c), 0.0)

        wpos = torch.clamp(torch.clamp(new_lens - 1, min=0), max=Lc - 1)
        gcs, gcm = g(cs), g(cm)
        child_s = torch.gather(gcs, 2, ctok[..., None])[..., 0]
        new_ts = put(g(c['times_s']), wpos,
                     torch.where(child_s >= 0, child_s, t1))
        new_te = put(g(te), wpos, (t1 + 1).expand(B, K))
        new_cc = put(g(cc), wpos, torch.maximum(
            torch.gather(gcm, 2, ctok[..., None])[..., 0], cval))
        new_ca = put(g(c['conf_a']), wpos, at_cell(nsc_c))
        # extensions start with a fresh (childless) history row
        new_cs = torch.where(is_ext[..., None], -1, gcs)
        new_cm = torch.where(is_ext[..., None], neg, gcm)

        rows = (self.row0 + par).reshape(-1)
        self.cache = self.cache.index_select(1, rows)
        new_nsc = self._decoder_rows(new_buf, new_lens)
        new_nsc = torch.where(new_alive[..., None], new_nsc, g(nsc))

        new = {
            'lens': new_lens, 'buf': new_buf, 'h1': new_h1, 'h2': new_h2,
            'dp': torch.stack([sel_nb, sel_pb], -1), 'att_sum': new_att,
            'nsc': new_nsc, 'times_s': new_ts, 'times_e': new_te,
            'conf_c': new_cc, 'conf_a': new_ca, 'child_start': new_cs,
            'child_cmax': new_cm,
            # the previous-expansion table of the next frame's resurrection
            'prev_h1': torch.cat([h1, ch1.reshape(B, -1)], 1),
            'prev_h2': torch.cat([h2, ch2.reshape(B, -1)], 1),
            'prev_dp': torch.cat(
                [torch.stack([stay_nb, stay_pb], -1),
                 torch.stack([ext_nb, ext_pb], -1).reshape(B, K * P, 2)], 1),
            'prev_valid': torch.cat([stay_in_dict, ext_live.reshape(B, -1)],
                                    1),
            'alive': new_alive, 'scores': sel_score,
        }
        # an utterance with no frame left keeps its state; its rows of the
        # decoder cache are not read again, so they are left as they are
        valid = tt >= 0
        for name, v in new.items():
            m = valid.reshape(B, *([1] * (v.dim() - 1)))
            self.c[name] = torch.where(m, v, c[name])


def joint_search_batch(model, encoder_outs, encoder_lens, ctc_probs, K: int,
                       P: int, ctc_w: float, penalty: float, log_thr: float,
                       Lc: int, cat_embs=None):
    """Returns (tokens (B, K, Lc), lens, scores (B, K), times_s, times_e,
    conf_c, conf_a (B, K, Lc)), each utterance's beams best first."""
    V = ctc_probs.shape[-1]
    lens = encoder_lens.to(encoder_outs.device)
    ts, n_valid = _frame_order(ctc_probs, lens, model.cfg.blank_id, log_thr)
    search = _JointSearch(model, encoder_outs, lens, V, K, P, Lc, cat_embs)
    rows = torch.arange(ts.shape[0], device=ts.device)
    for t in range(int(n_valid.max()) if ts.shape[0] else 0):
        tt = ts[:, t]
        search.step(ctc_probs[rows, tt.clamp(min=0)], tt, ctc_w, penalty)
    c = search.c
    return (c['buf'][:, :, 1:Lc + 1], c['lens'], c['scores'], c['times_s'],
            c['times_e'], c['conf_c'], c['conf_a'])


def joint_decoding_device(model, encoder_outs, encoder_lens, ctc_probs,
                          ctc_weight: float = 0.5, beam_size: int = 4,
                          pre_beam_ratio: float = 1.5,
                          length_bonus: float = 0.5,
                          blank_threshold: float = 1.0, cat_embs=None
                          ) -> List[DecodeResult]:
    """Per-utterance time-sync search for the whole batch: encoder_outs
    (B, T, D), encoder_lens (B,), ctc_probs (B, T, V) log-probs."""
    V = ctc_probs.shape[-1]
    P = min(int(pre_beam_ratio * beam_size), V)
    log_thr = math.log(blank_threshold) if blank_threshold < 1.0 else 0.0
    Lc = ctc_probs.shape[1]
    with torch.inference_mode():
        out = joint_search_batch(
            model, encoder_outs, torch.as_tensor(encoder_lens),
            ctc_probs.to(torch.float32), beam_size, P, float(ctc_weight),
            float(length_bonus), log_thr, Lc, cat_embs)
    toks, lens, scores, ts, _, cc, ca = (x.cpu().numpy() for x in out)
    conf = np.maximum(cc, ca)
    results = []
    for b in range(toks.shape[0]):
        n = int(lens[b, 0])
        results.append(DecodeResult(
            tokens=toks[b, 0, :n].tolist(), score=float(scores[b, 0]),
            times=ts[b, 0, :n].tolist(),
            tokens_confidence=[math.exp(x) if x > NEG_INF / 2 else 0.0
                               for x in conf[b, 0, :n]]))
    return results
