"""CTC forced alignment (Viterbi) and peak timestamps.

Counterpart of reverb_tpu/decode/ctc_utils.py (reference
asr/wenet/utils/ctc_utils.py): `force_align` is the Viterbi over the
blank-interleaved label graph, `gen_ctc_peak_time` and
`gen_timestamps_from_peak` turn an alignment into token times.

The Viterbi runs on the log-probs' device as tensor ops over the S = 2L + 1
states, one step a frame (the JAX package runs the same recurrence as a
`lax.scan`, no Pallas kernel); each step keeps its back-pointers, and the
walk back over them runs on the host after one copy.  Ties between staying,
moving one state and skipping one go to the first of the three, as
`jnp.argmax` breaks them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

NEG_INF = -1e30


def force_align(ctc_probs, y, blank_id: int = 0) -> List[int]:
    """The framewise label alignment of (T, V) log-probs (a tensor on the
    device the Viterbi should run on, or an array) against labels y (L,)."""
    ctc_probs = torch.as_tensor(ctc_probs)
    T = ctc_probs.shape[0]
    dev = ctc_probs.device
    y = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    L = y.shape[0]
    S = 2 * L + 1
    y_ins = torch.full((S,), blank_id, dtype=torch.int64, device=dev)
    y_ins[1::2] = y
    s_idx = torch.arange(S, device=dev)
    neg = torch.full((S,), NEG_INF, dtype=torch.float32, device=dev)
    # a skip (from two states back) enters only a label that differs from
    # the label two states back
    same = torch.cat([torch.ones(2, dtype=torch.bool, device=dev),
                      y_ins[2:] == y_ins[:-2]])
    no_skip = ((s_idx % 2) == 0) | same
    emit = ctc_probs.to(torch.float32)[:, y_ins]                  # (T, S)
    alpha = torch.where(s_idx == 0, emit[0], neg)
    if L > 0:
        alpha = torch.where(s_idx == 1, emit[0], alpha)
    backptrs = []
    for t in range(1, T):
        from1 = torch.cat([neg[:1], alpha[:-1]])
        from2 = torch.where(no_skip, neg, torch.cat([neg[:2], alpha[:-2]]))
        stacked = torch.stack([alpha, from1, from2])
        best = torch.argmax(stacked, 0)      # the first maximum wins
        alpha = torch.amax(stacked, 0) + emit[t]
        backptrs.append(s_idx - best)
    end1 = 2 * L
    end2 = max(2 * L - 1, 0)
    fa = alpha.cpu().numpy()
    state = end1 if fa[end1] >= fa[end2] else end2
    bps = (torch.stack(backptrs).cpu().numpy() if backptrs
           else np.zeros((0, S), np.int64))
    states = np.zeros((T,), np.int64)
    for t in range(T - 1, 0, -1):
        states[t] = state
        state = int(bps[t - 1, state])
    if T:
        states[0] = state
    y_ins = y_ins.cpu().numpy()
    return [int(y_ins[s]) for s in states]


def gen_ctc_peak_time(alignment: List[int], blank_id: int = 0) -> List[int]:
    """Frame indices where a new non-blank token is emitted."""
    times = []
    prev = None
    for t, tok in enumerate(alignment):
        if tok != blank_id and tok != prev:
            times.append(t)
        prev = tok
    return times


def gen_timestamps_from_peak(peaks: List[int], max_duration: float,
                             frame_rate: float = 0.04,
                             max_token_duration: float = 1.0):
    """(begin, end) second pairs per token (ctc_utils.py:62-92)."""
    times = []
    half = max_token_duration / 2
    for i, peak in enumerate(peaks):
        if i == 0:
            start = max(0.0, peak * frame_rate - half)
        else:
            start = max((peaks[i - 1] + peaks[i]) / 2 * frame_rate,
                        peak * frame_rate - half)
        if i == len(peaks) - 1:
            end = min(max_duration, peak * frame_rate + half)
        else:
            end = min((peaks[i] + peaks[i + 1]) / 2 * frame_rate,
                      peak * frame_rate + half)
        times.append((round(start, 3), round(end, 3)))
    return times
