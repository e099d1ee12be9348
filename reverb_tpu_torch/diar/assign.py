"""CTM words × RTTM speaker segments → STM (a copy of
reverb_tpu/diar/assign.py; host Python).

Parity: diarization/assign_words2speakers.py:24-87 — per word: single
overlapping segment wins; multiple overlaps → majority-overlap speaker; no
overlap → nearest segment.  (Interval lookup via sorted lists + bisect; no
intervaltree dependency.)
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Tuple

from reverb_tpu_torch.diar.pipeline import Segment, load_rttm


class IntervalIndex:
    def __init__(self, segments: List[Segment]):
        self.segments = sorted(segments, key=lambda s: s.start)
        self.starts = [s.start for s in self.segments]

    def overlapping(self, start: float, end: float) -> List[Segment]:
        # all segments with s.start < end and s.end > start
        hi = bisect.bisect_left(self.starts, end)
        return [s for s in self.segments[:hi] if s.end > start]


def speaker_for_segment(start: float, dur: float, index: IntervalIndex
                        ) -> str:
    end = start + dur
    hits = index.overlapping(start, end)
    if len(hits) == 1:
        return hits[0].speaker
    if not hits:
        best = None
        best_d = None
        for s in index.segments:
            d = max(s.start - end, start - s.end, 0.0)
            if best_d is None or d < best_d:
                best_d, best = d, s
        return best.speaker if best else ''
    overlap = defaultdict(float)
    for s in hits:
        overlap[s.speaker] += min(end, s.end) - max(start, s.start)
    return max(overlap, key=overlap.get)


def read_ctm(path) -> List[Tuple[str, str, float, float, str, str]]:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                rows.append((parts[0], parts[1], float(parts[2]),
                             float(parts[3]), parts[4], parts[5]))
    return rows


def assign_words_to_speakers(rttm_path, ctm_path, out_stm_path):
    import os
    rttm = load_rttm(rttm_path)
    assert len(rttm) <= 1, list(rttm)
    if rttm:
        uri, segments = next(iter(rttm.items()))
    else:
        # empty diarization (silence / no speech found): every word gets a
        # single unknown speaker rather than crashing the pipeline
        uri = os.path.splitext(os.path.basename(str(ctm_path)))[0]
        segments = []
    index = IntervalIndex(segments)
    with open(out_stm_path, 'w') as f:
        for _, _chan, start, dur, token, _conf in read_ctm(ctm_path):
            spk = (speaker_for_segment(start, dur, index) if segments
                   else 'SPEAKER_UNK')
            f.write(f'{uri} 1 {spk} {start:.3f} {start + dur:.3f} {token}\n')


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        'Assign words to speakers from a diarization RTTM + CTM transcript')
    p.add_argument('diarization_rttm')
    p.add_argument('ctm_transcription')
    p.add_argument('output_stm_transcription')
    args = p.parse_args(argv)
    assign_words_to_speakers(args.diarization_rttm, args.ctm_transcription,
                             args.output_stm_transcription)


if __name__ == '__main__':
    main()
