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
    """Sum of the per-utterance CTC losses / B; with `focal`, the mean of
    α·(1 − p)^γ·loss with p = exp(−loss).  ys_pad may hold any padding
    past ys_lens.  `denom` replaces B (a larger batch's rows)."""
    logp = torch.log_softmax(ctc.ctc_lo(encoder_out).to(torch.float32), -1)
    B = logp.shape[0]
    L = ys_pad.shape[1]
    labels = torch.where(
        torch.arange(L, device=ys_pad.device)[None, :] < ys_lens[:, None],
        ys_pad, torch.zeros_like(ys_pad)).to(torch.int64)
    per_seq = F.ctc_loss(logp.transpose(0, 1), labels,
                         encoder_lens.to(torch.int64),
                         ys_lens.to(torch.int64), blank=blank_id,
                         reduction='none')
    if focal:
        p = torch.exp(-per_seq)
        per_seq = focal_alpha * (1 - p) ** focal_gamma * per_seq
        return per_seq.mean() if denom is None else per_seq.sum() / denom
    return per_seq.sum() / (B if denom is None else denom)


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
