"""ONMT-style attention decoding with GNMT global scoring.

Counterpart of reverb_tpu/decode/onmt_beam.py (`gnmt_length_penalty`,
`gnmt_coverage_penalty`, `onmt_beam_search_device`,
`onmt_attention_decoding`): the attention beam of decode/attention_beam.py
with each row's finish length (generated tokens including eos, recorded at
its first eos) and, when a coverage penalty is on, the running sum of its
cross-attention (mean over layers and heads) while it is alive.  The final
score is cum / lp(finish length) − cp(coverage).  An LSL decoder without
cat_embs takes the verbatim [1, 0].
"""

from __future__ import annotations

from typing import List

import torch

from reverb_tpu_torch.decode.attention_beam import (MAX_STEPS, BeamRows,
                                                    _pack)
from reverb_tpu_torch.decode.results import DecodeResult


def gnmt_length_penalty(length, alpha: float, kind: str):
    """The length normalizer of `length` (a tensor)."""
    length = length.to(torch.float32)
    if kind == 'avg':
        return torch.pow(torch.clamp(length, min=1.0), alpha)
    if kind == 'wu':
        return torch.pow((5.0 + length) / 6.0, alpha)
    if kind in (None, 'none'):
        return torch.ones_like(length)
    raise ValueError(f'unknown length penalty {kind!r}')


def gnmt_coverage_penalty(cov, beta: float, kind: str):
    """The coverage penalty of cov (..., T), the accumulated attention."""
    if kind in (None, 'none') or beta == 0.0:
        return torch.zeros(cov.shape[:-1], dtype=torch.float32,
                           device=cov.device)
    if kind == 'wu':
        pen = -torch.log(torch.clamp(cov, max=1.0) + 1e-20).sum(-1)
    elif kind == 'summary':
        pen = torch.clamp(cov, min=1.0).sum(-1) - cov.shape[-1]
    else:
        raise ValueError(f'unknown coverage penalty {kind!r}')
    return beta * pen


def onmt_beam_search_device(model, encoder_out, encoder_lens,
                            beam_size: int, cat_embs=None,
                            alpha: float = 1.0, beta: float = 0.0,
                            length_penalty: str = 'avg',
                            coverage_penalty: str = 'none'):
    """Returns (hyps (B, min(T, MAX_STEPS)), scores (B,)): each
    utterance's best row under the GNMT global score."""
    need_attn = coverage_penalty not in (None, 'none') and beta != 0.0
    max_steps = min(encoder_out.shape[1], MAX_STEPS)
    if model.cfg.lsl_dec and cat_embs is None:
        cat_embs = torch.tensor([1.0, 0.0], device=encoder_out.device)
    rows = BeamRows(model, encoder_out, encoder_lens, beam_size, max_steps,
                    cat_embs)
    R = rows.B * rows.N
    dev = encoder_out.device
    fin_len = torch.full((R,), max_steps, dtype=torch.int64, device=dev)
    cov = torch.zeros((R, encoder_out.shape[1]), dtype=torch.float32,
                      device=dev)
    for i in range(max_steps):
        if rows.all_ended(i):
            break
        logp, attn = rows.decoder_step(i, need_attn)
        src_row, was_ended = rows.advance(i, logp)
        if attn is not None:
            # coverage accumulates only while the hypothesis is alive
            cov = cov[src_row] + torch.where(was_ended[:, None], 0.0,
                                             attn[src_row])
        fin_len = torch.where(~was_ended & rows.end_flag, i + 1,
                              fin_len[src_row])
    final = (rows.scores / gnmt_length_penalty(fin_len, alpha,
                                               length_penalty)
             - gnmt_coverage_penalty(cov, beta, coverage_penalty))
    return rows.best(final.reshape(rows.B, rows.N))


def onmt_attention_decoding(model, encoder_out, encoder_lens,
                            beam_size: int = 5, cat_embs=None,
                            alpha: float = 1.0, beta: float = 0.0,
                            length_penalty: str = 'avg',
                            coverage_penalty: str = 'none'
                            ) -> List[DecodeResult]:
    with torch.inference_mode():
        hyps, scores = onmt_beam_search_device(
            model, encoder_out, encoder_lens, beam_size, cat_embs,
            alpha, beta, length_penalty, coverage_penalty)
    return _pack(hyps, scores, model.cfg.eos)
