"""Token→word merge, timestamp assignment and CTM/TXT formatting (host-side).

The port's own copy of reverb_tpu/decode/align.py.  Behavioral parity targets:
  - ctc_align / adjust_model_time_offset  asr/wenet/bin/ctc_align.py:24-138
    (BPE pieces merged at '▁' boundaries; start/end from CTC spike frames
     with the 100 ms gap heuristic and midpoint interpolation; fixed-latency
     adjustment clamped to not overlap the previous word)
  - hyps_to_ctm / hyps_to_txt             asr/wenet/cli/utils.py:4-21

This is pure string/tuple post-processing on a handful of words per chunk —
host python is the right place for it; output bytes must match the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional

SPACE_SYMBOL = '▁'  # '▁'
_GAP_MS = 100


def _is_special_token(word: str) -> bool:
    o, c = word.find('<'), word.find('>')
    return o != -1 and c != -1 and o < c


def _is_empty(word: str) -> bool:
    return word == '' or word == SPACE_SYMBOL


def ctc_align(tokens: List[int], times: List[int],
              confidences: Optional[List[float]], id_to_token,
              frame_shift_ms: float, time_shift_ms: float) -> List[Dict]:
    """Merge BPE tokens into words with millisecond timestamps.

    id_to_token: callable token id → token string (e.g. tokenizer.id2tok).
    Returns list of dicts {word, start_time_ms, end_time_ms, confidence}.
    """
    assert len(tokens) == len(times), (len(tokens), len(times))
    path: List[Dict] = []
    word = ''
    unit_ids: List[int] = []
    start_ms = -1
    unit_start = -1
    n = len(tokens)

    def _end_ms(i: int) -> float:
        end = times[i] * frame_shift_ms
        if i < n - 1:
            if (times[i + 1] - times[i]) * frame_shift_ms < _GAP_MS:
                end = (times[i + 1] + times[i]) // 2 * frame_shift_ms
        return end

    for i in range(n):
        tok = id_to_token(tokens[i])
        nxt = id_to_token(tokens[i + 1]) if i + 1 < n else SPACE_SYMBOL
        if tok.startswith(SPACE_SYMBOL):
            word += tok[len(SPACE_SYMBOL):]
        else:
            word += tok
        unit_ids.append(tokens[i])

        if start_ms == -1:
            start_ms = max(times[i] * frame_shift_ms - _GAP_MS, 0)
            if i > 0 and (times[i] - times[i - 1]) * frame_shift_ms < _GAP_MS:
                start_ms = (times[i - 1] + times[i]) // 2 * frame_shift_ms
            unit_start = i

        def _conf(lo, hi):
            if confidences:
                return max(confidences[lo:hi])
            return 0

        if not _is_empty(word) and _is_special_token(word):
            end_ms = _end_ms(i)
            path.append({'word': word, 'unit_id': unit_ids[0],
                         'start_time_ms': start_ms + time_shift_ms,
                         'end_time_ms': end_ms + time_shift_ms,
                         'confidence': _conf(unit_start, i + 1),
                         'unit_ids': list(unit_ids)})
            start_ms, unit_start, unit_ids, word = -1, 0, [], ''
            continue

        if nxt.find(SPACE_SYMBOL) != -1 or _is_special_token(nxt):
            end_ms = _end_ms(i)
            if not _is_empty(word):
                path.append({'word': word, 'unit_id': -1,
                             'start_time_ms': start_ms + time_shift_ms,
                             'end_time_ms': end_ms + time_shift_ms,
                             'confidence': _conf(unit_start, i + 1),
                             'unit_ids': list(unit_ids)})
            start_ms, unit_start, unit_ids, word = -1, 0, [], ''
    return path


def adjust_model_time_offset(words: List[Dict], adjustment_ms: float
                             ) -> List[Dict]:
    """Shift words earlier by up to adjustment_ms without overlapping the
    previous word (ctc_align.py:116-138)."""
    if adjustment_ms == 0:
        return words
    out = []
    for i, w in enumerate(words):
        if i == 0:
            adj = min(adjustment_ms, w['start_time_ms'])
        else:
            prev_end = out[i - 1]['end_time_ms']
            adj = min(adjustment_ms, max(w['start_time_ms'] - prev_end, 0))
        w = dict(w)
        w['start_time_ms'] -= adj
        w['end_time_ms'] -= adj
        out.append(w)
    return out


def hyps_to_ctm(audio_name: str, words: List[Dict]) -> List[str]:
    """CTM rows: `file 0 start dur word conf` (cli/utils.py:4-13)."""
    rows = []
    for w in words:
        start = w['start_time_ms'] / 1000.0
        dur = w['end_time_ms'] / 1000.0 - start
        rows.append(f"{audio_name} 0 {start:.2f} {dur:.2f} {w['word']} "
                    f"{w['confidence']:.2f}")
    return rows


def hyps_to_txt(words: List[Dict]) -> List[str]:
    return [w['word'] for w in words]
