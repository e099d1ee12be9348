"""CTC head: projection, per-frame top-k with deferred normalization, the
dense log-prob table, and the training losses.

Counterpart of reverb_tpu/models/ctc.py (`ctc_topk_logprobs`,
`ctc_logprobs`, `ctc_loss`, `label_smoothing_loss`).  The top-k runs on the
logits in their compute dtype (order-preserving), and only the k winners
and p(blank) are normalized by one f32 logsumexp, so the (B,T,V) f32
log-prob table is built only for the decode modes that walk the whole
distribution (`ctc_logprobs`).  Ties go to the lowest vocabulary index
(ops/topk.py).

The CTC loss is torch's on an f32 log-softmax (the JAX package computes it
with optax in XLA, not in a Pallas kernel); the attention loss is the
closed form of the label-smoothed KL divergence, with no (B, L, V) f32
temporaries beyond the logits' own f32 view.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.models.modules import Linear
from reverb_tpu_torch.ops.topk import topk_lastdim


class CTC(nn.Module):
    def __init__(self, odim: int, idim: int):
        super().__init__()
        self.ctc_lo = Linear(idim, odim)


def ctc_topk_logprobs(ctc: CTC, encoder_out, k: int,
                      blank_penalty: float = 0.0, blank_id: int = 0):
    """Returns (topk_logp f32 (B,T,k), topk_idx i32 (B,T,k), blank_logp f32
    (B,T))."""
    logits = ctc.ctc_lo(encoder_out)
    if blank_penalty > 0.0:
        logits = logits.clone()
        logits[:, :, blank_id] -= blank_penalty
    m = logits.amax(-1).to(torch.float32)
    se = torch.exp(logits.to(torch.float32) - m[..., None]).sum(-1)
    lse = m + torch.log(se)
    tv, ti = topk_lastdim(logits, k)
    topk_logp = tv.to(torch.float32) - lse[..., None]
    blank_logp = logits[:, :, blank_id].to(torch.float32) - lse
    return topk_logp, ti.to(torch.int32), blank_logp


def ctc_logprobs(ctc: CTC, encoder_out, blank_penalty: float = 0.0,
                 blank_id: int = 0):
    """(B, T, V) f32 log-softmax of the logits, the blank logit lowered by
    `blank_penalty` first (in f32, as the reference does)."""
    logits = ctc.ctc_lo(encoder_out).to(torch.float32)
    if blank_penalty > 0.0:
        logits[:, :, blank_id] -= blank_penalty
    return torch.log_softmax(logits, -1)


def ctc_loss(ctc: CTC, encoder_out, encoder_lens, ys_pad, ys_lens,
             blank_id: int = 0, focal: bool = False, focal_alpha: float = 0.5,
             focal_gamma: float = 2.0, denom=None):
    """Sum of the per-utterance CTC losses (`ctc_per_seq`: optax's value
    also where no alignment exists) / B; with `focal`, the mean of
    α·(1 − p)^γ·loss with p = exp(−loss).  ys_pad may hold any padding
    past ys_lens.  `denom` replaces B (a larger batch's rows)."""
    logp = torch.log_softmax(ctc.ctc_lo(encoder_out).to(torch.float32), -1)
    B = logp.shape[0]
    L = ys_pad.shape[1]
    labels = torch.where(
        torch.arange(L, device=ys_pad.device)[None, :] < ys_lens[:, None],
        ys_pad, torch.zeros_like(ys_pad)).to(torch.int64)
    per_seq = ctc_per_seq(logp, encoder_lens, labels, ys_lens, blank_id)
    if focal:
        p = torch.exp(-per_seq)
        per_seq = focal_alpha * (1 - p) ** focal_gamma * per_seq
        return per_seq.mean() if denom is None else per_seq.sum() / denom
    return per_seq.sum() / (B if denom is None else denom)


def ctc_per_seq(logp, encoder_lens, labels, ys_lens, blank_id: int = 0):
    """Per-utterance CTC loss (B,) of log-probs (B, T, V) against labels
    (B, L), as optax.ctc_loss gives it: `F.ctc_loss` where an alignment
    exists; where none does (fewer frames than labels plus adjacent
    repeats), where F.ctc_loss gives inf, optax's recursion with log(0)
    taken as −1e5 (`optax_ctc_per_seq`), a large finite loss."""
    lens = encoder_lens.to(torch.int64)
    ylens = ys_lens.to(torch.int64)
    per_seq = F.ctc_loss(logp.transpose(0, 1), labels, lens, ylens,
                         blank=blank_id, reduction='none', zero_infinity=True)
    L = labels.shape[1]
    pos = torch.arange(L, device=labels.device)[None, :]
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos[:, 1:] < ylens[:, None])).sum(1)
    impossible = lens < ylens + repeats
    if bool(impossible.any()):
        per_seq = torch.where(impossible, optax_ctc_per_seq(
            logp, lens, labels, ylens, blank_id), per_seq)
    return per_seq


def optax_ctc_per_seq(logp, encoder_lens, labels, ys_lens,
                      blank_id: int = 0, log_epsilon: float = -1e5):
    """optax.ctc_loss's forward recursion (its blank and label
    α-probabilities, log(0) taken as `log_epsilon`), frame by frame over
    the batch: (B,) losses, finite also where no alignment exists."""
    B, T, _ = logp.shape
    L = labels.shape[1]
    dev = logp.device
    logp = torch.log_softmax(logp, -1)
    lab = labels.to(torch.int64)
    repeat = torch.cat([(lab[:, :-1] == lab[:, 1:]).to(logp.dtype),
                        torch.zeros((B, 1), dtype=logp.dtype, device=dev)],
                       1)
    emit_lp = torch.gather(logp, 2, lab[:, None, :].expand(B, T, L))
    phi_lp = logp[:, :, blank_id:blank_id + 1]
    phi = torch.full((B, L + 1), log_epsilon, dtype=logp.dtype, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, L), log_epsilon, dtype=logp.dtype, device=dev)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], 1)

    pad = (torch.arange(T, device=dev)[None, :]
           >= encoder_lens.to(dev)[:, None]).to(logp.dtype)
    for t in range(T):
        prev_phi = phi
        phi_in = add_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(phi_in[:, :-1] + emit_lp[:, t],
                                    emit + emit_lp[:, t])
        next_phi = add_phi(phi_in + phi_lp[:, t], emit + phi_lp[:, t]
                           + log_epsilon * (1.0 - repeat))
        p = pad[:, t:t + 1]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * prev_phi + (1.0 - p) * next_phi
    last = add_phi(phi, emit)
    return -torch.gather(last, 1, ys_lens.to(torch.int64)[:, None])[:, 0]


def label_smoothing_loss(logits, target, smoothing: float, vocab_size: int,
                         ignore_id: int = -1, normalize_length: bool = False,
                         denom=None):
    """KL(smoothed one-hot ‖ softmax(logits)) over the non-ignored positions,
    / B (or / their count with normalize_length; `denom` replaces either).
    Closed form: the cross term needs only the target's log-prob and
    Σ_v logp_v = Σ_v logits − V·lse; 0·log 0 = 0 as in torch's
    KLDivLoss."""
    B = logits.shape[0]
    V = vocab_size
    confidence = 1.0 - smoothing
    low = smoothing / (V - 1)
    mask = target != ignore_id
    tgt = torch.where(mask, target, torch.zeros_like(target))
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, -1)
    logp_tgt = torch.gather(lf, -1, tgt[..., None].to(torch.int64))[..., 0] \
        - lse
    ent = confidence * math.log(confidence) if confidence > 0 else 0.0
    if low > 0:
        ent += (V - 1) * low * math.log(low)
        sum_logp = lf.sum(-1) - V * lse
        cross = confidence * logp_tgt + low * (sum_logp - logp_tgt)
    else:
        cross = confidence * logp_tgt
    kl = torch.where(mask, ent - cross, torch.zeros_like(cross))
    if denom is None:
        denom = mask.sum() if normalize_length else B
    return kl.sum() / denom
