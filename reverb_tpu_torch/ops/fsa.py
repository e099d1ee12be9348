"""Weighted-FSA forward scoring for LF-MMI training.

Counterpart of reverb_tpu/ops/fsa.py (a `lax.scan` there, not a Pallas
kernel, so torch ops here):

  - `fsa_forward_score`: the log-semiring forward score of frame
    log-probs through an epsilon-free WFSA given as static arc tables
    (src, dst, label, weight), one segment-logsumexp over each frame's
    arcs (`_segment_logsumexp`: scatter_reduce 'amax' and index_add);
  - `bigram_den_arcs`: the denominator graph, CTC topology composed with a
    token bigram LM, built on the host (numpy), as there;
  - `dense_unigram_den_score`: the denominator under a unigram token LM
    without an arc table, O(T·V).

Both scorers run the frame loop over the whole batch at once (JAX vmaps
each utterance); a row stops at its own length.  They compute in logp's
dtype (f32 from the k2_model, as JAX's; f64 for an f64 yardstick).
NEG_INF = −1e30 stands for log 0, as there, so no inf·0 reaches the
backward, and autograd through the recursion gives the numerator and
denominator occupancies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _segment_logsumexp(data, segment_ids, num_segments: int):
    """Logsumexp of data (B, A) over the arcs of each segment (dst state):
    (B, num_segments); empty segments give NEG_INF.  The max is a
    constant of the gradient (the standard stabilisation)."""
    B = data.shape[0]
    idx = segment_ids[None].expand(B, -1)
    m = torch.full((B, num_segments), NEG_INF, dtype=data.dtype,
                   device=data.device).scatter_reduce(
                       1, idx, data.detach(), reduce='amax',
                       include_self=True)
    empty = m <= NEG_INF / 2
    m_safe = torch.where(empty, torch.zeros_like(m), m)
    s = torch.zeros_like(m).index_add(
        1, segment_ids, torch.exp(data - m_safe.gather(1, idx)))
    return torch.where(empty, torch.full_like(m, NEG_INF),
                       m_safe + torch.log(torch.clamp(s, min=1e-37)))


def fsa_forward_score(logp, t_len, src, dst, label, weight,
                      num_states: int, final, start: int = 0):
    """logp (B, T, V) frame log-probs, t_len (B,) valid frames; arc a:
    src[a] --label[a]/weight[a]--> dst[a] (long / f32 tensors on logp's
    device); final (S,) final weights (NEG_INF: not final).  Returns the
    total score of each row (B,): logsumexp over all t_len-frame paths
    from `start` to a final state."""
    B, T, _ = logp.shape
    dev = logp.device
    alpha = torch.full((B, num_states), NEG_INF, dtype=logp.dtype,
                       device=dev)
    alpha[:, start] = 0.0
    lens = t_len.to(dev)
    weight = weight.to(logp.dtype)
    for t in range(T):
        contrib = alpha[:, src] + weight[None] + logp[:, t, label]
        nxt = _segment_logsumexp(contrib, dst, num_states)
        alpha = torch.where((t < lens)[:, None], nxt, alpha)
    return torch.logsumexp(alpha + final.to(logp.dtype)[None], -1)


def bigram_den_arcs(bigram_logp: np.ndarray, blank_id: int,
                    sos_logp: Optional[np.ndarray] = None,
                    eos_logp: Optional[np.ndarray] = None,
                    tokens: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, int, np.ndarray]:
    """The denominator graph: CTC topology ∘ token-bigram LM (host, numpy).

    bigram_logp (K, K) = log P(v | u) over the K modelled tokens; `tokens`
    maps the K rows to vocabulary ids (default: the non-blank ids in
    order).  States: 0 = start; 1 + 2k = the last frame was token k;
    2 + 2k = a blank after token k.  Blank arcs weigh 0, an arc entering
    token v from context u weighs log P(v | u), repeating k without a blank
    is a weight-0 continuation.  Returns (src, dst, label, weight,
    num_states, final) for `fsa_forward_score`."""
    K = bigram_logp.shape[0]
    if tokens is None:
        tokens = np.array([t for t in range(K + 1) if t != blank_id][:K],
                          np.int32)
    sos_logp = (sos_logp if sos_logp is not None
                else np.full((K,), -np.log(K), np.float32))
    eos_logp = (eos_logp if eos_logp is not None
                else np.zeros((K,), np.float32))
    S = 1 + 2 * K
    src, dst, lab, wgt = [], [], [], []

    def arc(s, d, label, w):
        src.append(s)
        dst.append(d)
        lab.append(int(label))
        wgt.append(float(w))

    arc(0, 0, blank_id, 0.0)                        # leading blanks
    for v in range(K):
        arc(0, 1 + 2 * v, tokens[v], sos_logp[v])   # first emission
    for u in range(K):
        tok_u, blank_u = 1 + 2 * u, 2 + 2 * u
        arc(tok_u, tok_u, tokens[u], 0.0)           # continuation
        arc(tok_u, blank_u, blank_id, 0.0)
        arc(blank_u, blank_u, blank_id, 0.0)
        # re-emitting u needs a blank in between (CTC's rule)
        arc(blank_u, tok_u, tokens[u], bigram_logp[u, u])
        for v in range(K):
            if v != u:
                arc(tok_u, 1 + 2 * v, tokens[v], bigram_logp[u, v])
                arc(blank_u, 1 + 2 * v, tokens[v], bigram_logp[u, v])
    final = np.full((S,), NEG_INF, np.float32)
    final[0] = 0.0                                  # the empty sequence
    for u in range(K):
        final[1 + 2 * u] = eos_logp[u]
        final[2 + 2 * u] = eos_logp[u]
    return (np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(lab, np.int32), np.asarray(wgt, np.float32), S, final)


def dense_unigram_den_score(logp, t_len, unigram_logp, blank_id: int):
    """The denominator score under a unigram token LM, without an arc
    table: logp (B, T, V), t_len (B,), unigram_logp (V,) → (B,).

    States: β, the last frame was blank (or the start), and α_v, the last
    frame was token v.  A frame t gives
        β'  = logp[t, blank] + LSE(β, LSE_v α_v)
        α'_v = logp[t, v] + LSE(α_v, u(v) + LSE(β, LSE_{w≠v} α_w))
    with LSE_{w≠v} taken by exclusion from the total in probability space,
    the excluded share clamped at 1 − 1e-7."""
    B, T, V = logp.shape
    dev, dt = logp.device, logp.dtype
    nonblank = torch.arange(V, device=dev) != blank_id
    neg = torch.tensor(NEG_INF, dtype=dt, device=dev)
    u = torch.where(nonblank, unigram_logp.to(dev, dt), neg)
    alpha = torch.full((B, V), NEG_INF, dtype=dt, device=dev)
    beta = torch.zeros((B,), dtype=dt, device=dev)
    lens = t_len.to(dev)
    for t in range(T):
        xt = logp[:, t]
        tot = torch.logsumexp(torch.cat([alpha, beta[:, None]], 1), -1)
        rest = tot[:, None] + torch.log1p(-torch.clamp(
            torch.exp(alpha - tot[:, None]), 0.0, 1.0 - 1e-7))
        new_alpha = torch.where(
            nonblank, xt + torch.logaddexp(alpha, u + rest), neg)
        new_beta = xt[:, blank_id] + torch.logaddexp(
            beta, torch.logsumexp(torch.where(nonblank, alpha, neg), -1))
        keep = t < lens
        alpha = torch.where(keep[:, None], new_alpha, alpha)
        beta = torch.where(keep, new_beta, beta)
    return torch.logsumexp(torch.cat([alpha, beta[:, None]], 1), -1)
