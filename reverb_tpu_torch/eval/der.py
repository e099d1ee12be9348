"""Diarization Error Rate (hermetic md-eval analogue): a copy of
reverb_tpu/eval/der.py but for the speaker mapping (`_assignment`).

The reference scores diarization with WDER only (its README quality table;
diarization/assign_words2speakers.py feeds fstalign) — DER is the standard
community metric (NIST md-eval / pyannote.metrics) and the diar bench
reports both.  Semantics follow md-eval:

  DER = (missed speech + false alarm + speaker confusion) / total ref speech

scored per time unit with overlapping speech counted per-speaker
(a 2-speaker overlap contributes 2 units of reference), an optimal
one-to-one reference↔hypothesis speaker mapping (Hungarian on overlap
time), and an optional no-score collar of ±collar seconds around every
reference segment boundary.

Implementation: a uniform grid at `resolution` seconds (default 10 ms —
md-eval's own time quantum).  Exact to the grid.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def _grid_matrix(segs, speakers, t_end: float, res: float):
    import numpy as np
    T = int(round(t_end / res)) + 1
    idx = {s: i for i, s in enumerate(speakers)}
    m = np.zeros((T, len(speakers)), bool)
    for (a, b, s) in segs:
        fa, fb = int(round(a / res)), int(round(b / res))
        m[fa:fb, idx[s]] = True
    return m


def _assignment(cost):
    """Max-overlap one-to-one mapping, cost[i, j] = overlap(ref i, hyp j):
    the Hungarian method (scipy), exact at any size.  The JAX package
    enumerates P(larger, smaller) permutations where min(R, H) <= 10 (a
    14 × 8 matrix runs for minutes) and goes greedy beyond; where it is
    exact the two reach the same total overlap, and the DER depends on
    nothing else."""
    from scipy.optimize import linear_sum_assignment
    if min(cost.shape) == 0:
        return []
    rows, cols = linear_sum_assignment(cost, maximize=True)
    return [(int(i), int(j)) for i, j in zip(rows, cols)]


def der(ref: Sequence[Tuple[float, float, str]],
        hyp: Sequence[Tuple[float, float, str]],
        collar: float = 0.25, resolution: float = 0.01) -> Dict[str, float]:
    """ref/hyp: (start_s, end_s, speaker) triples.  Returns
    {'der','miss','false_alarm','confusion','total_s'} (rates are fractions
    of total reference speech; total_s is scored reference speech
    seconds)."""
    import numpy as np
    if not ref:
        return {'der': 0.0 if not hyp else float('inf'), 'miss': 0.0,
                'false_alarm': 0.0, 'confusion': 0.0, 'total_s': 0.0}
    t_end = max([b for (_, b, _) in ref] + [b for (_, b, _) in hyp] + [0.0])
    r_spk = sorted({s for (_, _, s) in ref})
    h_spk = sorted({s for (_, _, s) in hyp})
    R = _grid_matrix(ref, r_spk, t_end, resolution)
    H = (_grid_matrix(hyp, h_spk, t_end, resolution) if hyp
         else np.zeros((R.shape[0], 0), bool))

    score = np.ones((R.shape[0],), bool)
    if collar > 0:
        c = int(round(collar / resolution))
        for (a, b, _) in ref:
            fa, fb = int(round(a / resolution)), int(round(b / resolution))
            score[max(fa - c, 0):fa + c] = False
            score[max(fb - c, 0):fb + c] = False
    R = R[score]
    H = H[score]

    # optimal mapping on overlap time inside the scored region
    cost = (R[:, :, None] & H[:, None, :]).sum(0).astype(np.float64)
    pairs = _assignment(cost)
    correct = np.zeros((R.shape[0],), np.int64)
    for i, j in pairs:
        correct += (R[:, i] & H[:, j])

    n_ref = R.sum(1).astype(np.int64)
    n_hyp = H.sum(1).astype(np.int64)
    miss = np.maximum(n_ref - n_hyp, 0).sum()
    fa = np.maximum(n_hyp - n_ref, 0).sum()
    conf = (np.minimum(n_ref, n_hyp) - correct).clip(min=0).sum()
    total = n_ref.sum()
    if total == 0:
        z = float('inf') if (fa or conf) else 0.0
        return {'der': z, 'miss': 0.0, 'false_alarm': z, 'confusion': 0.0,
                'total_s': 0.0}
    return {
        'der': float((miss + fa + conf) / total),
        'miss': float(miss / total),
        'false_alarm': float(fa / total),
        'confusion': float(conf / total),
        'total_s': float(total * resolution),
    }
