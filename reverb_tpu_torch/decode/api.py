"""Decode orchestration for the serving mode set: one encoder pass → CTC
top-k → prefix beam (kernels K2/K3) → whole-batch attention rescoring.

Counterpart of reverb_tpu/decode/api.py restricted to
{ctc_prefix_beam_search, attention_rescoring}: `encode_and_ctc_topk`,
`_beam_rescore_tail` (length-bucketed rescoring, 32/64/128) and the host
packing of `_decode_fused`.  Everything stays on the device until the one
fetch before packing.  When that fetch shows a hypothesis longer than
`max_hyp_len`, `decode` takes the reference's generic tail instead
(`_decode_uncapped`): the beam once more with no cap on the length, then
`rescoring.attention_rescoring` on its device buffers; the encoder does not
run again.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from reverb_tpu_torch.decode import prefix_beam as pb
from reverb_tpu_torch.decode import rescoring as rs
from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.models.ctc import ctc_topk_logprobs

MODES = ('ctc_prefix_beam_search', 'attention_rescoring')


def encode_and_ctc_topk(model, feats, feats_lens, cat_embs, k: int,
                        blank_penalty: float = 0.0):
    """Encoder + per-frame CTC top-k (deferred normalization)."""
    encoder_out, encoder_mask = model.forward_encoder(feats, feats_lens,
                                                      cat_embs)
    encoder_lens = encoder_mask[:, 0, :].sum(-1).to(torch.int32)
    topk_logp, topk_idx, blank_logp = ctc_topk_logprobs(
        model.ctc, encoder_out, k, blank_penalty, model.cfg.blank_id)
    return encoder_out, encoder_lens, topk_logp, topk_idx, blank_logp


def _beam_rescore_tail(model, tk_logp, tk_idx, blank_lp, encoder_out,
                       encoder_lens, beam_size: int, ctc_weight: float,
                       reverse_weight: float, blank_skip_threshold: float,
                       max_hyp_len: int, cat_embs, rescore: bool = True):
    """Prefix beam → length-bucketed whole-batch attention rescoring."""
    keep_cap = (tk_logp.shape[1] // 2) if blank_skip_threshold > 0 else 0
    prefixes, plens, ctc_scores, times = \
        pb.ctc_prefix_beam_search_device_topk(
            tk_logp, tk_idx, blank_lp, encoder_lens, beam_size,
            model.cfg.blank_id, max_hyp_len, blank_skip_threshold, keep_cap)
    beam = (prefixes, plens, ctc_scores, times)
    if not rescore:
        return beam, None
    cap_L = prefixes.shape[2]
    lens_c = torch.clamp(plens, max=cap_L).to(torch.int32)
    # rescoring cost follows the padded hyp length: run the smallest bucket
    # that holds this batch's longest hyp
    buckets = [b for b in (32, 64, 128) if b < cap_L] + [cap_L]
    lmax = int(lens_c.max())
    Lb = next(b for b in buckets if lmax <= b)
    att, r_att, tok_logp = rs._rescore_device_all(
        model, prefixes[:, :, :Lb].contiguous(), lens_c, encoder_out,
        reverse_weight, cat_embs, encoder_lens)
    tok_logp = torch.nn.functional.pad(tok_logp, (0, cap_L - Lb))
    score = att * (1 - reverse_weight) + r_att * reverse_weight \
        if reverse_weight > 0 else att
    confidence = torch.exp(score / (lens_c + 1).to(torch.float32))
    valid_row = ctc_scores > pb.NEG_INF / 2
    total = torch.where(valid_row, score + ctc_scores * ctc_weight,
                        torch.full_like(score, -math.inf))
    best = torch.argmax(total, dim=1)

    def take(x):
        idx = best[:, None] if x.dim() == 2 else best[:, None, None].expand(
            -1, 1, x.shape[2])
        return torch.gather(x, 1, idx)[:, 0]
    return beam, (best, take(total), take(confidence), take(tok_logp),
                  take(times))


def _decode_uncapped(model, methods, tk_logp, tk_idx, blank_lp, encoder_out,
                     encoder_lens, beam_size: int, ctc_weight: float,
                     reverse_weight: float, blank_skip_threshold: float,
                     cat_embs) -> Dict[str, List[DecodeResult]]:
    """The decode tail with no cap on the hypothesis length, on the encoder
    output and CTC top-k the caller already holds: the beam again (kernels
    K2/K3 a second time) with L = T, or the keep cap under blank-skip, then
    rescoring at the 16-bucket of the longest hypothesis, with the rescored
    nbest filled in."""
    with torch.inference_mode():
        prefix_results, beam_raw = pb.ctc_prefix_beam_search_topk_raw(
            tk_logp, tk_idx, blank_lp, encoder_lens, beam_size,
            model.cfg.blank_id, blank_skip_threshold)
        results: Dict[str, List[DecodeResult]] = {}
        if 'ctc_prefix_beam_search' in methods:
            results['ctc_prefix_beam_search'] = prefix_results
        if 'attention_rescoring' in methods:
            results['attention_rescoring'] = rs.attention_rescoring(
                model, prefix_results, encoder_out, encoder_lens, beam_raw,
                ctc_weight, reverse_weight, cat_embs)
    return results


def decode(model, methods: List[str], feats, feats_lens,
           beam_size: int = 10, ctc_weight: float = 0.0,
           reverse_weight: float = 0.0, blank_penalty: float = 0.0,
           cat_embs=None, blank_skip_threshold: float = 0.0,
           max_hyp_len: int = 256) -> Dict[str, List[DecodeResult]]:
    """Decode a batch of feature chunks (B, T, F) with methods ⊆ MODES."""
    for m in methods:
        if m not in MODES:
            raise NotImplementedError(
                f'decode mode {m!r} is not ported (ported: {MODES})')
    if model.cfg.apply_non_blank_embedding:
        raise NotImplementedError('apply_non_blank_embedding is not ported')
    dev = next(model.parameters()).device
    feats = torch.as_tensor(feats).to(dev)
    feats_lens = torch.as_tensor(feats_lens).to(dev)
    cat = None if cat_embs is None else torch.as_tensor(cat_embs).to(dev)
    with torch.inference_mode():
        encoder_out, encoder_lens, tk_logp, tk_idx, blank_lp = \
            encode_and_ctc_topk(model, feats, feats_lens, cat, beam_size,
                                blank_penalty)
        beam, resc = _beam_rescore_tail(
            model, tk_logp, tk_idx, blank_lp, encoder_out, encoder_lens,
            beam_size, ctc_weight, reverse_weight, blank_skip_threshold,
            max_hyp_len, cat, rescore='attention_rescoring' in methods)
    prefixes, plens, ctc_scores, times = (x.cpu().numpy() for x in beam)
    if plens.max(initial=0) > max_hyp_len:
        # a hypothesis outgrew the (B, K, max_hyp_len) buffers
        return _decode_uncapped(
            model, methods, tk_logp, tk_idx, blank_lp, encoder_out,
            encoder_lens, beam_size, ctc_weight, reverse_weight,
            blank_skip_threshold, cat)
    results: Dict[str, List[DecodeResult]] = {}
    if 'ctc_prefix_beam_search' in methods:
        results['ctc_prefix_beam_search'] = pb._pack_results(
            prefixes, plens, ctc_scores, times)
    if resc is None:
        return results
    best, total, conf, tok_logp, best_times = (x.cpu().numpy() for x in resc)
    out = []
    for b in range(prefixes.shape[0]):
        k = int(best[b])
        n = int(plens[b, k])
        if not np.isfinite(total[b]) or plens[b].max() == 0:
            out.append(DecodeResult(tokens=[], times=[],
                                    tokens_confidence=[]))
            continue
        out.append(DecodeResult(
            tokens=prefixes[b, k, :n].tolist(), score=float(total[b]),
            confidence=float(conf[b]), times=best_times[b, :n].tolist(),
            tokens_confidence=[math.exp(float(x)) for x in tok_logp[b, :n]]))
    results['attention_rescoring'] = out
    return results
