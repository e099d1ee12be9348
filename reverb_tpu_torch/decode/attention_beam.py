"""Batched attention (decoder-only) beam search.

Counterpart of reverb_tpu/decode/attention_beam.py
(`attention_beam_search_device`, `attention_beam_search`): a beam of N
rows per utterance over the decoder's incremental step, finished rows
frozen (their first candidate scores 0, the rest NEG_INF, every prediction
eos), the N·N candidates of an utterance pruned to N, and the final pick by
score / max(len, 1) ** length_penalty, where len counts the row's
non-eos tokens.

The reference scans a static `max_steps = min(T, 446)` steps.  Once every
row has ended a step changes nothing (each row keeps its score and its
place, and writes eos where eos already stands), so the loop here stops
there; it checks every `_CHECK_EVERY` steps, which bounds the host syncs.
Every top-k breaks ties to the lowest index (ops/topk.py), as
`jax.lax.top_k` does.
"""

from __future__ import annotations

from typing import List

import torch

from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.ops.topk import topk_lastdim

NEG_INF = -1e30
MAX_STEPS = 446
_CHECK_EVERY = 16


class BeamRows:
    """The search state shared by the attention and onmt beams: B
    utterances × N rows, a (B·N, max_steps + 1) token buffer opened by sos,
    the decoder's k‖v cache, and the cross-attention K/V of the encoder
    output shared by each utterance's rows."""

    def __init__(self, model, encoder_out, encoder_lens, beam_size: int,
                 max_steps: int, cat_embs):
        cfg = model.cfg
        B, T, _ = encoder_out.shape
        dev = encoder_out.device
        N = beam_size
        self.B, self.N, self.eos = B, N, cfg.eos
        self.dec = model.decoder.left_decoder
        self.mem_kv = self.dec.cross_kv(encoder_out)
        self.mask = (torch.arange(T, device=dev)[None, :]
                     < encoder_lens.to(dev)[:, None])[:, None, :]
        self.cat = None
        if cat_embs is not None and cfg.lsl_dec:
            self.cat = (cat_embs if cat_embs.dim() == 1
                        else cat_embs.repeat_interleave(N, 0))
        self.buf = torch.full((B * N, max_steps + 1), cfg.eos,
                              dtype=torch.int64, device=dev)
        self.buf[:, 0] = cfg.sos
        self.scores = torch.tensor([0.0] + [NEG_INF] * (N - 1),
                                   device=dev).repeat(B)
        self.end_flag = torch.zeros(B * N, dtype=torch.bool, device=dev)
        self.cache = self.dec.init_cache(B * N, max_steps + 1,
                                         encoder_out.dtype, dev)
        self.offset = torch.arange(B, device=dev)[:, None] * N

    def decoder_step(self, i: int, return_src_attn: bool = False):
        """The decoder at position i of every row (the token written last)."""
        steps = torch.full((self.B * self.N,), i, dtype=torch.int64,
                           device=self.buf.device)
        out = self.dec.forward_step(self.buf[:, i], steps, self.cache,
                                    self.mem_kv, self.mask, self.N, self.cat,
                                    return_src_attn)
        self.cache = out[1]
        return out[0], (out[2] if return_src_attn else None)

    def advance(self, i: int, logp):
        """Prune the rows' N·N candidates to N, reorder the rows and write
        the predictions at position i + 1.  Returns (src_row (B·N,),
        was_ended (B·N,)): each new row's origin and whether it had ended."""
        B, N = self.B, self.N
        top_logp, top_idx = topk_lastdim(logp, N)
        first = torch.arange(N, device=logp.device)[None, :] == 0
        ended = self.end_flag[:, None]
        top_logp = torch.where(
            ended, torch.where(first, 0.0, NEG_INF), top_logp)
        top_idx = torch.where(ended, self.eos, top_idx)
        cand = (self.scores[:, None] + top_logp).reshape(B, N * N)
        new_scores, off = topk_lastdim(cand, N)
        src_row = (off // N + self.offset).reshape(-1)
        pred = torch.gather(top_idx.reshape(B, N * N), 1, off).reshape(-1)
        was_ended = self.end_flag[src_row]
        self.buf = self.buf[src_row]
        self.buf[:, i + 1] = pred
        self.cache = self.cache[:, src_row]
        self.scores = new_scores.reshape(-1)
        self.end_flag = pred == self.eos
        return src_row, was_ended

    def all_ended(self, i: int) -> bool:
        """Every `_CHECK_EVERY` steps: whether every row has ended."""
        return i % _CHECK_EVERY == 0 and bool(self.end_flag.all())

    def best(self, final):
        """(hyps (B, max_steps) without sos, scores (B,)) of the row with the
        highest `final` (B, N) score in each utterance (the first on ties)."""
        best = torch.argmax(final, dim=1)
        hyps = self.buf[best + self.offset[:, 0]][:, 1:]
        return hyps, torch.gather(final, 1, best[:, None])[:, 0]


def attention_beam_search_device(model, encoder_out, encoder_lens,
                                 beam_size: int, cat_embs=None,
                                 length_penalty: float = 0.0):
    """encoder_out (B, T, D), encoder_lens (B,) → (hyps (B, max_steps),
    scores (B,)), max_steps = min(T, MAX_STEPS)."""
    max_steps = min(encoder_out.shape[1], MAX_STEPS)
    rows = BeamRows(model, encoder_out, encoder_lens, beam_size, max_steps,
                    cat_embs)
    for i in range(max_steps):
        if rows.all_ended(i):
            break
        logp, _ = rows.decoder_step(i)
        rows.advance(i, logp)
    B, N = rows.B, rows.N
    lengths = (rows.buf != rows.eos).sum(1).reshape(B, N).to(torch.float32)
    # pow(len, 0) == 1: plain scores when there is no penalty
    final = rows.scores.reshape(B, N) / torch.pow(
        torch.clamp(lengths, min=1.0), length_penalty)
    return rows.best(final)


def _pack(hyps, scores, eos: int) -> List[DecodeResult]:
    hyps, scores = hyps.cpu().numpy(), scores.cpu().numpy()
    return [DecodeResult(tokens=[int(t) for t in hyps[b] if int(t) != eos],
                         score=float(scores[b]))
            for b in range(hyps.shape[0])]


def attention_beam_search(model, encoder_out, encoder_lens,
                          beam_size: int = 10, length_penalty: float = 0.0,
                          cat_embs=None) -> List[DecodeResult]:
    with torch.inference_mode():
        hyps, scores = attention_beam_search_device(
            model, encoder_out, encoder_lens, beam_size, cat_embs,
            length_penalty)
    return _pack(hyps, scores, model.cfg.eos)
