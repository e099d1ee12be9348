"""Attention rescoring of CTC prefix-beam nbest lists, whole batch at once.

Counterpart of reverb_tpu/decode/rescoring.py (`_rescore_flat`,
`_rescore_device_all`, and `attention_rescoring` fed by the beam's device
buffers, which `decode.api.decode` takes for hypotheses longer than its
`max_hyp_len`).  The (B, N) nbest grid is flattened to B·N decoder
rows, grouped by utterance so each group shares its utterance's
cross-attention K/V.  The decoder's log-softmax is deferred: only the
hypothesis tokens' logits and one f32 logsumexp per position are taken, so
no (rows, L, V) f32 log-prob tensor is built.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.utils.common import reverse_sequence


def _bucket(n: int, step: int = 16) -> int:
    """n rounded up to the next multiple of `step` (at least `step`): the
    padded hypothesis length of the uncapped rescoring pass."""
    return max(step, -(-n // step) * step)


def _rescore_flat(model, hyps_pad, hyps_lens, encoder_outs,
                  reverse_weight: float, cat_embs, enc_lens, group: int):
    """hyps_pad (M, Lmax) WITHOUT sos, rows grouped by utterance
    (M = B·group); encoder_outs (B, T, D); enc_lens (B,) valid frames.
    Returns (att (M,), r_att (M,), tok_logp (M, Lmax))."""
    cfg = model.cfg
    M, Lmax = hyps_pad.shape
    B, T, _ = encoder_outs.shape
    dev = hyps_pad.device
    f32 = torch.float32
    idx = torch.arange(Lmax, device=dev)
    valid = idx[None, :] < hyps_lens[:, None]                 # (M, Lmax)
    sos_col = torch.full((M, 1), cfg.sos, dtype=hyps_pad.dtype, device=dev)
    body = torch.where(valid, hyps_pad, torch.full_like(hyps_pad, cfg.eos))
    hyps_in = torch.cat([sos_col, body], 1)                   # (M, L+1)
    lens_in = hyps_lens + 1
    enc_mask = (torch.arange(T, device=dev)[None, :]
                < enc_lens.reshape(B)[:, None])[:, None, :]
    r_body = reverse_sequence(hyps_in[:, 1:], lens_in - 1, cfg.eos)
    r_hyps = torch.cat([hyps_in[:, :1], r_body], 1)
    dec_cat = cat_embs if cfg.lsl_dec else None
    l_x, r_x = model.decoder(encoder_outs, enc_mask, hyps_in, lens_in, r_hyps,
                             reverse_weight, dec_cat, mem_group=group)

    tok = torch.where(valid, hyps_pad, torch.zeros_like(hyps_pad)).to(
        torch.int64)
    lens64 = hyps_lens.to(torch.int64)[:, None]
    rows = torch.arange(M, device=dev)[:, None]

    def scores(x, pos):
        """Per-token log-probs (token j read at position pos[:, j]) and the
        eos log-prob."""
        lse = torch.logsumexp(x.to(f32), dim=-1)               # (M, L+1)
        val = x[rows, pos, tok].to(f32)
        logp = torch.where(valid, val - torch.gather(lse[:, :Lmax], 1, pos),
                           torch.zeros_like(val))
        eos_val = torch.gather(x[:, :, cfg.eos], 1, lens64)[:, 0].to(f32)
        eos_logp = eos_val - torch.gather(lse, 1, lens64)[:, 0]
        return logp, logp.sum(1) + eos_logp

    pos = idx[None, :].expand(M, Lmax)
    tok_logp, att = scores(l_x, pos)
    if r_x is not None:
        # the right decoder scores the reversed sequence: token j of a hyp
        # sits at position len-1-j of the reversed stream
        rpos = torch.where(valid, hyps_lens[:, None] - 1 - idx[None, :],
                           torch.zeros_like(pos)).to(torch.int64)
        r_tok_logp, r_att = scores(r_x, rpos)
        tok_logp = torch.where(
            valid,
            torch.log(torch.clamp(
                (torch.exp(tok_logp) + torch.exp(r_tok_logp)) / 2,
                min=1e-30)),
            torch.zeros_like(tok_logp))
    else:
        r_att = torch.zeros_like(att)
    return att, r_att, tok_logp


def _rescore_device_all(model, hyps_pad, hyps_lens, encoder_outs,
                        reverse_weight: float, cat_embs=None, enc_lens=None):
    """Whole-batch rescoring: hyps_pad (B,N,L), hyps_lens (B,N),
    encoder_outs (B,T,D), enc_lens (B,) → (att, r_att (B,N),
    tok_logp (B,N,L))."""
    B, N, Lmax = hyps_pad.shape
    att, r_att, tok_logp = _rescore_flat(
        model, hyps_pad.reshape(B * N, Lmax), hyps_lens.reshape(B * N),
        encoder_outs, reverse_weight, cat_embs, enc_lens, group=N)
    return (att.reshape(B, N), r_att.reshape(B, N),
            tok_logp.reshape(B, N, Lmax))


def attention_rescoring(model, ctc_prefix_results: List[DecodeResult],
                        encoder_outs, encoder_lens, device_nbest,
                        ctc_weight: float = 0.0, reverse_weight: float = 0.0,
                        cat_embs=None) -> List[DecodeResult]:
    """Rescore every utterance's nbest in one batched decoder pass, fed by
    the beam's device tuple `device_nbest` (prefixes (B,K,L), plens, scores,
    times) whose packed form is `ctc_prefix_results`.  The beam keeps its
    rows sorted by score with the sentinel rows last, so row k of the tuple
    is entry k of the packed nbest.  Returns DecodeResults that also carry
    the nbest re-ranked by the combined score."""
    from reverb_tpu_torch.decode.prefix_beam import NEG_INF
    n_max = max((len(p.nbest) for p in ctc_prefix_results), default=0)
    l_max = max((len(h) for p in ctc_prefix_results for h in p.nbest),
                default=0)
    if l_max == 0 or n_max == 0:
        return [DecodeResult(tokens=[], times=[], tokens_confidence=[])
                for _ in ctc_prefix_results]
    prefixes, plens, scores, _ = device_nbest
    Lb = min(_bucket(l_max), prefixes.shape[2])
    valid = scores > NEG_INF / 2
    lens = torch.where(valid, torch.clamp(plens, max=Lb),
                       torch.zeros_like(plens)).to(torch.int32)
    att, r_att, tok_logp = _rescore_device_all(
        model, prefixes[:, :, :Lb].to(torch.int32).contiguous(), lens,
        encoder_outs, reverse_weight, cat_embs,
        encoder_lens.to(torch.int32))
    score = att * (1.0 - reverse_weight) + r_att * reverse_weight \
        if reverse_weight > 0.0 else att
    conf = torch.exp(score / (lens + 1).to(torch.float32))
    total = torch.where(valid, score + scores.to(torch.float32) * ctc_weight,
                        torch.full_like(score, -math.inf))
    best = torch.argmax(total, dim=1)
    tc_best = torch.gather(
        tok_logp, 1, best[:, None, None].expand(-1, 1, Lb))[:, 0]
    conf_best = torch.gather(conf, 1, best[:, None])[:, 0]
    total, best, conf_best, tc_best = (
        x.cpu().numpy() for x in (total, best, conf_best, tc_best))
    return _pack_rescored(ctc_prefix_results, total.astype(np.float64), best,
                          conf_best.astype(np.float64), tc_best)


def _pack_rescored(ctc_prefix_results, total, best, conf_best, tc_best
                   ) -> List[DecodeResult]:
    """Host packing of the rescoring reduction.  Row i of `total` is nbest
    entry i of the utterance."""
    results = []
    for b, pre in enumerate(ctc_prefix_results):
        nvalid = len(pre.nbest)
        if nvalid == 0 or max((len(h) for h in pre.nbest), default=0) == 0:
            results.append(DecodeResult(tokens=[], times=[],
                                        tokens_confidence=[]))
            continue
        k = int(best[b])
        n = len(pre.nbest[k])
        tc = [math.exp(float(x)) for x in tc_best[b, :n]]
        # the hypotheses the beam produced, re-ranked by combined score
        order = [i for i in np.argsort(-total[b]) if i < nvalid]
        results.append(DecodeResult(
            tokens=pre.nbest[k], score=float(total[b, k]),
            confidence=float(conf_best[b]),
            times=pre.nbest_times[k], tokens_confidence=tc,
            nbest=[pre.nbest[i] for i in order],
            nbest_scores=[float(total[b, i]) for i in order],
            nbest_times=[pre.nbest_times[i] for i in order]))
    return results
