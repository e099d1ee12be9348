"""Paraformer NAR decode: greedy and batch beam over the one-pass decoder
output, CIF-peak timestamps, and result beautify.

Counterpart of reverb_tpu/decode/paraformer_search.py
(`paraformer_greedy_search`, `paraformer_beam_search` with
`_batch_beam_search_device`, `gen_timestamps_from_peak`,
`paraformer_beautify_result`; reference asr/wenet/paraformer/search.py).
The argmax, the per-step top-k of the beam and the beam's frame loop run
on the device; only the (B, U) winners and the CIF peaks come to the host.
The beam keeps the reference's quirks: per-step indices are emitted
without reordering the beam history, finished rows emit `eos` in place of
the flattened k·V index, and the final ids are taken modulo V (Python's
sign, as `jnp.mod`).  Its top-k breaks ties to the lower index
(ops/topk.py), as `jax.lax.top_k`.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.ops.topk import topk_lastdim

# ------------------------------ text beautify ------------------------------
#
# Behavioral parity with asr/wenet/paraformer/search.py:10-110, re-expressed
# as a unit-class predicate pair + an explicit token-class dispatch loop (the
# reference interleaves everything in one stateful loop of is_all_* calls).
# Reference quirks deliberately kept, pinned by
# test_timestamps_and_beautify_parity:
#   - the whole-list language checks compare each *cleaned whole token*
#     lexicographically against the CJK range (digits and '@' count as CJK),
#     while the mixed-stream per-token check walks the token's *characters*;
#   - a unit that cleans to '' is neither CJK nor Latin;
#   - a '@@' BPE run keeps accumulating across CJK/other tokens and a
#     trailing unterminated run is dropped.

_DROPPED_TOKENS = frozenset(('<sos>', '<eos>', '<blank>'))
_CLEAN_SUBSTRINGS = (' ', '</s>', '<s>', '<unk>', '<OOV>')

# token classes for the mixed-stream dispatch
_CJK, _LATIN, _BPE_PIECE, _OTHER = range(4)


def _cleaned(unit: str) -> str:
    for junk in _CLEAN_SUBSTRINGS:
        unit = unit.replace(junk, '')
    return unit


def _unit_is_cjk(s: str) -> bool:
    # lexicographic whole-string compare; digits and '@' included (quirk)
    return bool(s) and ('一' <= s <= '鿿' or '0' <= s <= '9' or s == '@')


def _unit_is_alpha(s: str) -> bool:
    if s == "'":
        return True
    return s.isalpha() and not _unit_is_cjk(s)


def _all_cjk(units) -> bool:
    """True when every cleaned unit is CJK-ish.  `units` may be a token list
    (whole-token compare) or a single token (per-character walk)."""
    return bool(units) and all(_unit_is_cjk(_cleaned(u)) for u in units)


def _all_alpha(units) -> bool:
    return bool(units) and all(_unit_is_alpha(_cleaned(u)) for u in units)


def _mixed_token_class(token: str) -> int:
    # reference order: per-char CJK test wins over the '@@' piece test, so
    # a token like '@@' (chars all CJK-ish) is CJK, not a BPE piece
    if _all_cjk(token):
        return _CJK
    if '@@' in token:
        return _BPE_PIECE
    if _all_alpha(token):
        return _LATIN
    return _OTHER


def paraformer_beautify_result(tokens: List[str]) -> str:
    """search.py:57-110 behavior — language-aware token joining.

    All-CJK streams concatenate (spaces stripped per token); all-Latin
    streams join '@@' BPE words with single spaces; mixed streams space
    Latin words apart but glue a CJK token directly after a Latin word."""
    kept = [t for t in tokens if t not in _DROPPED_TOKENS]

    if _all_cjk(kept):
        return ''.join(t.replace(' ', '') for t in kept).strip()

    if _all_alpha(kept):
        words, piece = [], ''
        for tok in kept:
            if '@@' in tok:
                piece += tok.replace('@@', '')
            else:
                words.append(piece + tok)
                piece = ''
        return ' '.join(words).strip()

    out: List[str] = []
    piece = ''
    latin_space_pending = False  # last emission was a Latin word + ' '
    for tok in kept:
        cls = _mixed_token_class(tok)
        if cls == _BPE_PIECE:
            piece += tok.replace('@@', '')
        elif cls == _LATIN:
            out.append(piece + tok)
            out.append(' ')
            piece = ''
        elif cls == _CJK:
            if latin_space_pending:
                out.pop()  # glue CJK directly after the Latin word
            out.append(tok)
        else:
            out.append(tok)
        latin_space_pending = cls == _LATIN
    return ''.join(out).strip()


# ------------------------------ timestamps ------------------------------

_CIF_START_END_THRESHOLD = 5   # frames of tail gap that earn a new segment
_CIF_MAX_TOKEN_DURATION = 14   # frames; longer intervals are clamped
_CIF_FORCE_TIME_SHIFT = -0.5   # fire frame → acoustic onset correction


def gen_timestamps_from_peak(cif_peaks: List[float], num_frames: int,
                             frame_rate: float = 0.02) -> List[List[float]]:
    """CIF fire frames → per-token [start, end] seconds.

    Behavioral parity with search.py:113-135: each token spans fire[i] to
    fire[i+1] clamped to MAX_TOKEN_DURATION; a long silent tail becomes its
    own final segment split at the midpoint, a short one extends the last
    token to the end of audio."""
    fires = [float(p) + _CIF_FORCE_TIME_SHIFT for p in cif_peaks]
    starts = list(fires[:-1])
    ends = [b if b - a <= _CIF_MAX_TOKEN_DURATION
            else a + _CIF_MAX_TOKEN_DURATION
            for a, b in zip(fires[:-1], fires[1:])]
    if num_frames - fires[-1] > _CIF_START_END_THRESHOLD:
        mid = (num_frames + fires[-1]) * 0.5
        ends[-1] = mid
        starts.append(mid)
        ends.append(float(num_frames))
    else:
        ends[-1] = float(num_frames)
    return [[s * frame_rate, e * frame_rate] for s, e in zip(starts, ends)]


# ------------------------------ greedy ------------------------------


def paraformer_greedy_search(decoder_out, decoder_out_lens,
                             cif_peaks=None) -> List[DecodeResult]:
    """Per-position top-1 with token confidences; times = the tp frames
    whose CIF peak crosses 1 − 1e-4, one per token (asserted).
    decoder_out (B, U, V) log-probs, decoder_out_lens (B,), cif_peaks
    (B, T_tp) or None."""
    lp = decoder_out.to(torch.float32)
    top_index = torch.argmax(lp, -1)
    top_prob = torch.gather(lp, -1, top_index[..., None])[..., 0]
    top_index = top_index.cpu().numpy()
    top_prob = top_prob.cpu().numpy()
    lens = torch.as_tensor(decoder_out_lens).cpu().numpy().astype(np.int64)
    results: List[DecodeResult] = []
    for b in range(top_index.shape[0]):
        n = int(lens[b])
        conf = float(np.sum(top_prob[b, :n], dtype=np.float64))
        results.append(DecodeResult(
            tokens=top_index[b, :n].tolist(),
            tokens_confidence=[math.exp(float(x)) for x in top_prob[b, :n]],
            confidence=math.exp(conf / n) if n > 0 else 0.0))
    if cif_peaks is not None:
        peaks = torch.as_tensor(cif_peaks).cpu().numpy()
        for b in range(peaks.shape[0]):
            result = results[b]
            times = []
            for i, peak in enumerate(peaks[b]):
                if len(times) >= len(result.tokens):
                    break
                if peak > 1 - 1e-4:
                    times.append(i)
            result.times = times
            if len(times) != len(result.tokens):
                raise AssertionError((len(times), len(result.tokens)))
    return results


# ------------------------------ beam ------------------------------


def _mask_finished_scores(score, flag):
    """Finished rows (flag (B, 1)) keep column 0 at 0 and every other
    column at −inf."""
    first = torch.arange(score.shape[-1], device=score.device)[None, :] == 0
    score = torch.where(flag & ~first, -math.inf, score)
    return torch.where(flag & first, 0.0, score)


def _batch_beam_search(log_post, masks_pad, beam_size: int, eos: int):
    """log_post (B, T, V) position-wise log-probs; masks_pad (B, T) True on
    PADDED positions.  Returns (indices (B, K, T) int32 modulo V,
    log_prob (B, K))."""
    B, T, V = log_post.shape
    K = beam_size
    log_prob, index = topk_lastdim(log_post[:, 0, :], K)
    end_flag = masks_pad[:, 0:1]
    log_prob = _mask_finished_scores(log_prob, end_flag)
    indices = [torch.where(end_flag, eos, index)]
    for t in range(1, T):
        scores = _mask_finished_scores(log_post[:, t], end_flag)
        cand = (log_prob[:, :, None] + scores[:, None, :]).reshape(B, K * V)
        log_prob, index = topk_lastdim(cand, K)
        indices.append(torch.where(end_flag, eos, index))
        end_flag = masks_pad[:, t:t + 1]
    out = torch.stack(indices, 2)                             # (B, K, T)
    return torch.remainder(out, V).to(torch.int32), log_prob


def paraformer_beam_search(decoder_out, decoder_out_lens,
                           beam_size: int = 10,
                           eos: int = -1) -> List[DecodeResult]:
    """The top beam of each utterance, cut to its length."""
    lens = torch.as_tensor(decoder_out_lens).to(decoder_out.device)
    T = decoder_out.shape[1]
    masks_pad = (torch.arange(T, device=decoder_out.device)[None, :]
                 >= lens[:, None])
    log_post = torch.log_softmax(decoder_out.to(torch.float32), -1)
    indices, _ = _batch_beam_search(log_post, masks_pad, beam_size, eos)
    best = indices[:, 0, :].cpu().numpy()
    lens = lens.cpu().numpy()
    return [DecodeResult(best[b, :int(lens[b])].tolist())
            for b in range(best.shape[0])]
