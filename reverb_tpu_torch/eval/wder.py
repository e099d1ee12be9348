"""Word-level Diarization Error Rate (WDER) — a copy of
reverb_tpu/eval/wder.py.

The reference reports WDER for the combined ASR+diarization workload
(README.md:28-32, diarization/README.md:79-89) but delegates the computation
to Rev's external scoring suite.  This is a self-contained implementation of
the metric as defined by Shafey et al. 2019 ("Joint Speech Recognition and
Speaker Diarization via Sequence Transduction"):

    WDER = (S_is + C_is) / (S + C)

where S/C are substituted/correct words in the word alignment between the
reference and hypothesis transcripts, and the `_is` subsets are those whose
hypothesis speaker label does not map to the reference speaker under the
best global speaker permutation (exact Hungarian for ≤9 speakers via
permutation search, greedy beyond).

Inputs are STM-style word lists: (word, speaker) sequences in time order —
exactly what diar/assign.py produces and what reference STMs carry.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Dict, List, Sequence, Tuple

from reverb_tpu_torch.eval.wer import align_words


def _best_speaker_mapping(pair_counts: Counter,
                          ref_speakers: Sequence[str],
                          hyp_speakers: Sequence[str]) -> Dict[str, str]:
    """hyp→ref speaker map maximizing matched word count."""
    ref_speakers = sorted(set(ref_speakers))
    hyp_speakers = sorted(set(hyp_speakers))
    if not ref_speakers or not hyp_speakers:
        return {}
    if len(hyp_speakers) <= 9 and len(ref_speakers) <= 9:
        # exact: try all injective assignments of hyp→ref (pad ref with None)
        best, best_map = -1, {}
        slots = list(ref_speakers) + [None] * max(
            0, len(hyp_speakers) - len(ref_speakers))
        for perm in itertools.permutations(slots, len(hyp_speakers)):
            score = sum(pair_counts.get((r, h), 0)
                        for h, r in zip(hyp_speakers, perm) if r is not None)
            if score > best:
                best, best_map = score, {
                    h: r for h, r in zip(hyp_speakers, perm)
                    if r is not None}
        return best_map
    # greedy fallback for large speaker counts
    pairs = sorted(pair_counts.items(), key=lambda kv: -kv[1])
    used_r, used_h, mapping = set(), set(), {}
    for (r, h), _ in pairs:
        if r not in used_r and h not in used_h:
            mapping[h] = r
            used_r.add(r)
            used_h.add(h)
    return mapping


def wder(ref_words: List[Tuple[str, str]],
         hyp_words: List[Tuple[str, str]]) -> Dict[str, float]:
    """ref_words/hyp_words: time-ordered (word, speaker) pairs.

    Returns {'wder', 'total', 'sub_is', 'cor_is', 'sub', 'cor'}.
    """
    ref_txt = [w for w, _ in ref_words]
    hyp_txt = [w for w, _ in hyp_words]
    _, _, _, ops = align_words(ref_txt, hyp_txt)

    # walk the alignment collecting (ref_spk, hyp_spk) pairs on sub/ok ops
    aligned = []
    ri = hi = 0
    for op, _, _ in ops:
        if op == 'ok' or op == 'sub':
            aligned.append((op, ref_words[ri][1], hyp_words[hi][1]))
            ri += 1
            hi += 1
        elif op == 'del':
            ri += 1
        else:
            hi += 1
    pair_counts = Counter((r, h) for _, r, h in aligned)
    mapping = _best_speaker_mapping(pair_counts,
                                    [r for _, r, _ in aligned],
                                    [h for _, _, h in aligned])
    sub = cor = sub_is = cor_is = 0
    for op, r, h in aligned:
        wrong = mapping.get(h) != r
        if op == 'sub':
            sub += 1
            sub_is += wrong
        else:
            cor += 1
            cor_is += wrong
    denom = max(sub + cor, 1)
    return {'wder': (sub_is + cor_is) / denom, 'total': sub + cor,
            'sub': sub, 'cor': cor, 'sub_is': sub_is, 'cor_is': cor_is}


def read_stm_words(path) -> List[Tuple[str, str]]:
    """STM rows `file chan speaker start end [flags] word...` → (word, spk)
    pairs in start-time order (diar/assign.py output format)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6 or line.startswith(';;'):
                continue
            spk = parts[2]
            start = float(parts[3])
            words = parts[5:] if not parts[5].startswith('<') else parts[6:]
            rows.append((start, spk, words))
    rows.sort(key=lambda r: r[0])
    return [(w, spk) for _, spk, words in rows for w in words]


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description='compute WDER from STM files')
    p.add_argument('ref_stm')
    p.add_argument('hyp_stm')
    args = p.parse_args(argv)
    m = wder(read_stm_words(args.ref_stm), read_stm_words(args.hyp_stm))
    print('WDER %.4f  (%d/%d words wrong-speaker; sub %d cor %d)'
          % (m['wder'], m['sub_is'] + m['cor_is'], m['total'], m['sub'],
             m['cor']))


if __name__ == '__main__':
    main()
