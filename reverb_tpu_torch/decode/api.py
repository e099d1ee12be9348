"""Decode orchestration: one encoder pass feeding every requested mode.

Counterpart of reverb_tpu/decode/api.py (`ALL_MODES`, `encode_and_ctc`,
`encode_and_ctc_topk`, `_beam_rescore_tail`, the host packing of
`_decode_fused`, and the generic dispatch of `decode`).

The serving mode set ⊆ {ctc_prefix_beam_search, attention_rescoring}
(without apply_non_blank_embedding) takes the fused route, as the
reference's fused='post': encoder → CTC top-k → prefix beam (kernels K2/K3)
→ length-bucketed whole-batch rescoring, everything on the device until the
one fetch before packing.  When that fetch shows a hypothesis longer than
`max_hyp_len`, `decode` takes the reference's generic tail instead
(`_decode_uncapped`): the beam once more with no cap on the length, then
`rescoring.attention_rescoring` on its device buffers; the encoder does not
run again.

Every other set takes the generic route, in the reference's order and with
its reuse of the prefix nbest for rescoring.  A `context_graph` biases the
prefix beam in-beam on both routes (kernel K2b in place of K2), as the
reference's search does.  Modes that walk the whole
distribution (joint_decoding, hlg_*, the non-blank filter of
apply_non_blank_embedding) get the dense (B, T, V) log-prob table; the
others get the per-frame top-k (k = beam_size when a prefix mode is in the
set, else 1).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from reverb_tpu_torch.decode import prefix_beam as pb
from reverb_tpu_torch.decode import rescoring as rs
from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.models.ctc import ctc_logprobs, ctc_topk_logprobs

ALL_MODES = ('attention', 'ctc_greedy_search', 'ctc_prefix_beam_search',
             'attention_rescoring', 'joint_decoding',
             'onmt_attention_decoding', 'hlg_onebest', 'hlg_rescore')
MODES = ('ctc_prefix_beam_search', 'attention_rescoring')   # fused route


def encode_and_ctc(model, feats, feats_lens, cat_embs,
                   blank_penalty: float = 0.0, decoding_chunk_size: int = -1):
    """Encoder + the dense (B, T, V) f32 CTC log-prob table."""
    encoder_out, encoder_mask = model.forward_encoder(
        feats, feats_lens, cat_embs, decoding_chunk_size=decoding_chunk_size)
    encoder_lens = encoder_mask[:, 0, :].sum(-1).to(torch.int32)
    return encoder_out, encoder_lens, ctc_logprobs(
        model.ctc, encoder_out, blank_penalty, model.cfg.blank_id)


def encode_and_ctc_topk(model, feats, feats_lens, cat_embs, k: int,
                        blank_penalty: float = 0.0,
                        decoding_chunk_size: int = -1):
    """Encoder + per-frame CTC top-k (deferred normalization)."""
    encoder_out, encoder_mask = model.forward_encoder(
        feats, feats_lens, cat_embs, decoding_chunk_size=decoding_chunk_size)
    encoder_lens = encoder_mask[:, 0, :].sum(-1).to(torch.int32)
    topk_logp, topk_idx, blank_logp = ctc_topk_logprobs(
        model.ctc, encoder_out, k, blank_penalty, model.cfg.blank_id)
    return encoder_out, encoder_lens, topk_logp, topk_idx, blank_logp


def _beam_rescore_tail(model, tk_logp, tk_idx, blank_lp, encoder_out,
                       encoder_lens, beam_size: int, ctc_weight: float,
                       reverse_weight: float, blank_skip_threshold: float,
                       max_hyp_len: int, cat_embs, rescore: bool = True,
                       context_graph=None):
    """Prefix beam → length-bucketed whole-batch attention rescoring."""
    keep_cap = (tk_logp.shape[1] // 2) if blank_skip_threshold > 0 else 0
    prefixes, plens, ctc_scores, times = \
        pb.ctc_prefix_beam_search_device_topk(
            tk_logp, tk_idx, blank_lp, encoder_lens, beam_size,
            model.cfg.blank_id, max_hyp_len, blank_skip_threshold, keep_cap,
            pb._graph_tables(context_graph, model.cfg.vocab_size,
                             tk_logp.device))
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
                     cat_embs, context_graph=None
                     ) -> Dict[str, List[DecodeResult]]:
    """The decode tail with no cap on the hypothesis length, on the encoder
    output and CTC top-k the caller already holds: the beam again (kernels
    K2/K3 a second time) with L = T, or the keep cap under blank-skip, then
    rescoring at the 16-bucket of the longest hypothesis, with the rescored
    nbest filled in."""
    with torch.inference_mode():
        prefix_results, beam_raw = pb.ctc_prefix_beam_search_topk_raw(
            tk_logp, tk_idx, blank_lp, encoder_lens, beam_size,
            model.cfg.blank_id, blank_skip_threshold, context_graph,
            model.cfg.vocab_size)
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
           max_hyp_len: int = 256, length_penalty: float = 0.0,
           decoding_chunk_size: int = -1, num_decoding_left_chunks: int = -1,
           hlg_graph=None, hlg_lm_scale: float = 0.0,
           hlg_decoder_scale: float = 0.0,
           hlg_r_decoder_scale: float = 0.0, context_graph=None
           ) -> Dict[str, List[DecodeResult]]:
    """Decode a batch of feature chunks (B, T, F) with methods ⊆
    ALL_MODES.  `length_penalty` is the attention mode's and the joint
    search's length bonus; the hlg modes need `hlg_graph` (decode/hlg.Fst);
    `context_graph` (decode/context_graph.ContextGraph) biases the prefix
    beam of ctc_prefix_beam_search and attention_rescoring.
    `decoding_chunk_size` goes to the encoder (a chunk mask on a
    use_dynamic_chunk model); `num_decoding_left_chunks` is accepted and,
    as in reverb_tpu/decode/api.py (whose encode programs never pass it
    on), not used."""
    for m in methods:
        if m not in ALL_MODES:
            raise ValueError(f'unknown decode mode {m!r} ({ALL_MODES})')
    dev = next(model.parameters()).device
    feats = torch.as_tensor(feats).to(dev)
    feats_lens = torch.as_tensor(feats_lens).to(dev)
    cat = None if cat_embs is None else torch.as_tensor(cat_embs).to(dev)
    if set(methods) <= set(MODES) and not model.cfg.apply_non_blank_embedding:
        return _decode_fused(model, methods, feats, feats_lens, beam_size,
                             ctc_weight, reverse_weight, blank_penalty, cat,
                             blank_skip_threshold, max_hyp_len,
                             decoding_chunk_size, context_graph)
    with torch.inference_mode():
        return _decode_generic(
            model, methods, feats, feats_lens, beam_size, ctc_weight,
            reverse_weight, blank_penalty, length_penalty, cat,
            blank_skip_threshold, hlg_graph, hlg_lm_scale,
            hlg_decoder_scale, hlg_r_decoder_scale, decoding_chunk_size,
            context_graph)


def _decode_fused(model, methods, feats, feats_lens, beam_size: int,
                  ctc_weight: float, reverse_weight: float,
                  blank_penalty: float, cat, blank_skip_threshold: float,
                  max_hyp_len: int, decoding_chunk_size: int = -1,
                  context_graph=None) -> Dict[str, List[DecodeResult]]:
    """The serving mode set: one device pass, one fetch, host packing."""
    with torch.inference_mode():
        encoder_out, encoder_lens, tk_logp, tk_idx, blank_lp = \
            encode_and_ctc_topk(model, feats, feats_lens, cat, beam_size,
                                blank_penalty, decoding_chunk_size)
        beam, resc = _beam_rescore_tail(
            model, tk_logp, tk_idx, blank_lp, encoder_out, encoder_lens,
            beam_size, ctc_weight, reverse_weight, blank_skip_threshold,
            max_hyp_len, cat, rescore='attention_rescoring' in methods,
            context_graph=context_graph)
    prefixes, plens, ctc_scores, times = (x.cpu().numpy() for x in beam)
    if plens.max(initial=0) > max_hyp_len:
        # a hypothesis outgrew the (B, K, max_hyp_len) buffers
        return _decode_uncapped(
            model, methods, tk_logp, tk_idx, blank_lp, encoder_out,
            encoder_lens, beam_size, ctc_weight, reverse_weight,
            blank_skip_threshold, cat, context_graph)
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


def _decode_generic(model, methods, feats, feats_lens, beam_size: int,
                    ctc_weight: float, reverse_weight: float,
                    blank_penalty: float, length_penalty: float, cat,
                    blank_skip_threshold: float, hlg_graph,
                    hlg_lm_scale: float, hlg_decoder_scale: float,
                    hlg_r_decoder_scale: float, decoding_chunk_size: int = -1,
                    context_graph=None) -> Dict[str, List[DecodeResult]]:
    """Every other mode set: one encoder pass, then each mode in the
    reference's order."""
    from reverb_tpu_torch.decode.attention_beam import attention_beam_search
    from reverb_tpu_torch.decode.greedy import (ctc_greedy_from_top1,
                                                ctc_greedy_search)
    cfg = model.cfg
    need_prefix = ('ctc_prefix_beam_search' in methods
                   or 'attention_rescoring' in methods)
    need_full = ('joint_decoding' in methods or 'hlg_onebest' in methods
                 or 'hlg_rescore' in methods
                 or cfg.apply_non_blank_embedding)
    ctc_probs = None
    if need_full:
        encoder_out, encoder_lens, ctc_probs = encode_and_ctc(
            model, feats, feats_lens, cat, blank_penalty,
            decoding_chunk_size)
    else:
        encoder_out, encoder_lens, tk_logp, tk_idx, blank_lp = \
            encode_and_ctc_topk(model, feats, feats_lens, cat,
                                beam_size if need_prefix else 1,
                                blank_penalty, decoding_chunk_size)
    results: Dict[str, List[DecodeResult]] = {}
    if 'attention' in methods:
        results['attention'] = attention_beam_search(
            model, encoder_out, encoder_lens, beam_size, length_penalty,
            cat_embs=cat)
    if 'ctc_greedy_search' in methods:
        results['ctc_greedy_search'] = (
            ctc_greedy_search(ctc_probs, encoder_lens, cfg.blank_id)
            if ctc_probs is not None else
            ctc_greedy_from_top1(tk_idx[:, :, 0], encoder_lens,
                                 cfg.blank_id))
    if need_prefix:
        if ctc_probs is not None:
            prefix_results, beam_raw = pb.ctc_prefix_beam_search_raw(
                ctc_probs, encoder_lens, beam_size, cfg.blank_id,
                blank_skip_threshold, context_graph)
        else:
            prefix_results, beam_raw = pb.ctc_prefix_beam_search_topk_raw(
                tk_logp, tk_idx, blank_lp, encoder_lens, beam_size,
                cfg.blank_id, blank_skip_threshold, context_graph,
                cfg.vocab_size)
        if 'ctc_prefix_beam_search' in methods:
            results['ctc_prefix_beam_search'] = prefix_results
    if 'attention_rescoring' in methods:
        resc_out, resc_lens = encoder_out, encoder_lens
        if cfg.apply_non_blank_embedding:
            # the rescorer sees only the non-blank frames
            from reverb_tpu_torch.models.asr_model import \
                filter_blank_embedding
            T = encoder_out.shape[1]
            mask = (torch.arange(T, device=encoder_out.device)[None, :]
                    < encoder_lens[:, None])[:, None, :]
            resc_out, resc_mask = filter_blank_embedding(
                cfg, ctc_probs, encoder_out, mask)
            resc_lens = resc_mask[:, 0, :].sum(-1)
        results['attention_rescoring'] = rs.attention_rescoring(
            model, prefix_results, resc_out, resc_lens, beam_raw,
            ctc_weight, reverse_weight, cat)
    if 'onmt_attention_decoding' in methods:
        from reverb_tpu_torch.decode.onmt_beam import onmt_attention_decoding
        results['onmt_attention_decoding'] = onmt_attention_decoding(
            model, encoder_out, encoder_lens, beam_size, cat_embs=cat)
    if 'joint_decoding' in methods:
        from reverb_tpu_torch.decode.joint import joint_decoding
        results['joint_decoding'] = joint_decoding(
            model, encoder_out, encoder_lens, ctc_probs,
            ctc_weight=ctc_weight if ctc_weight else 0.5,
            beam_size=beam_size, length_bonus=length_penalty, cat_embs=cat)
    if 'hlg_onebest' in methods or 'hlg_rescore' in methods:
        if hlg_graph is None:
            raise ValueError('the hlg modes need hlg_graph (decode/hlg.Fst)')
        from reverb_tpu_torch.decode.hlg import hlg_onebest, hlg_rescore
        if 'hlg_onebest' in methods:
            results['hlg_onebest'] = hlg_onebest(
                ctc_probs, encoder_lens, hlg_graph, cfg.blank_id)
        if 'hlg_rescore' in methods:
            results['hlg_rescore'] = hlg_rescore(
                model, ctc_probs, encoder_lens, encoder_out, encoder_lens,
                hlg_graph, cfg.blank_id, lm_scale=hlg_lm_scale,
                decoder_scale=hlg_decoder_scale,
                r_decoder_scale=hlg_r_decoder_scale, cat_embs=cat)
    return results
