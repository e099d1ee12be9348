"""Teacher-student distillation.

Counterpart of reverb_tpu/train/teacher_student.py (`TSConfig`, `_kl`,
`_topk_sym_kl`, `ts_loss`, `decay_ts_weight`): the teacher runs without
gradients; the distillation term is the (optionally symmetric top-K) KL
between the teacher's and the student's CTC posteriors and between their
left decoders' posteriors, each / the student's count of valid encoder
frames; the loss is

    ts_weight · (ctc_w · kl_enc + (1 − ctc_w) · kl_dec)
        + reg_weight · the student's own hybrid loss.

The two distillation forwards take no dropout and no chunk; the
student's own loss is a separate forward with the generator's dropout, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from reverb_tpu_torch.models import ctc as ctc_mod
from reverb_tpu_torch.models.asr_model import ASRModel, compute_loss
from reverb_tpu_torch.ops.topk import topk_lastdim
from reverb_tpu_torch.parallel import global_batch as gb
from reverb_tpu_torch.utils.common import add_sos_eos


@dataclasses.dataclass(frozen=True)
class TSConfig:
    ts_weight: float = 0.5
    reg_weight: float = float('nan')      # nan → 1 − ts_weight (≥ 0)
    top_k_entries: int = 0                # 0 → the full-vocabulary KL
    min_ts_weight: float = 0.0
    decrease_every: int = 0
    decrease_factor: float = 1.0

    @property
    def resolved_reg_weight(self) -> float:
        if self.reg_weight == self.reg_weight:     # not nan
            return self.reg_weight
        return 1.0 if self.ts_weight > 1 else 1.0 - self.ts_weight


def _kl(student_logp, teacher_logp):
    """KLDivLoss(log_target=True, reduction='sum'): Σ exp(t)·(t − s)."""
    return (torch.exp(teacher_logp) * (teacher_logp - student_logp)).sum()


def _topk_sym_kl(student_logp, teacher_logp, k: int):
    """The symmetric top-K KL: each side's top-K values against the other
    side's values at those ids, averaged (ties to the lower id, as
    jax.lax.top_k); the plain KL at k ≤ 0."""
    if k <= 0:
        return _kl(student_logp, teacher_logp)
    s_vals, s_idx = topk_lastdim(student_logp, k)
    t_vals, t_idx = topk_lastdim(teacher_logp, k)
    xs = torch.gather(student_logp, -1, t_idx)
    xt = torch.gather(teacher_logp, -1, s_idx)
    return (_kl(xs, t_vals) + _kl(s_vals, xt)) / 2


def _posteriors(model: ASRModel, batch, ys_in, text_lens):
    """(CTC log-probs, left decoder log-probs, encoder mask) of one model,
    no dropout.  The distillation reads the left decoder only, so the
    right one is not run (the JAX package computes it and drops it)."""
    cfg = model.cfg
    cat = batch.get('cat_embs')
    enc, mask = model.forward_encoder(batch['feats'], batch['feats_lengths'],
                                      cat if cfg.lsl_enc else None)
    ctc = ctc_mod.ctc_logprobs(model.ctc, enc)
    dec, _ = model.decoder(enc, mask, ys_in, text_lens + 1, None, 0.0,
                           cat if cfg.lsl_dec else None)
    return ctc, torch.log_softmax(dec, -1), mask


def ts_loss(student: ASRModel, teacher: ASRModel, batch: Dict, ts: TSConfig,
            generator=None, ts_weight: Optional[float] = None) -> Dict:
    """The distillation loss of `student` against the frozen `teacher`;
    `ts_weight` overrides the config's (a decayed schedule)."""
    text, text_lens = batch['target'], batch['target_lengths']
    cfg_t = teacher.cfg
    ys_in, _ = add_sos_eos(text, text_lens, cfg_t.sos, cfg_t.eos,
                           cfg_t.ignore_id)
    with torch.no_grad():
        t_ctc, t_dec, _ = _posteriors(teacher, batch, ys_in, text_lens)
    s_ctc, s_dec, s_mask = _posteriors(student, batch, ys_in, text_lens)
    denom = gb.total(s_mask.sum())
    kl_enc = _topk_sym_kl(s_ctc, t_ctc, ts.top_k_entries) / denom
    kl_dec = _topk_sym_kl(s_dec, t_dec, ts.top_k_entries) / denom
    own = compute_loss(student, batch, generator, norm=gb.norms(batch))
    w = ts.ts_weight if ts_weight is None else ts_weight
    ctc_w = student.cfg.ctc_weight
    dist = kl_enc * ctc_w + (1 - ctc_w) * kl_dec
    loss = dist * w + own['loss'] * ts.resolved_reg_weight
    return {'loss': loss, 'kl_enc_loss': kl_enc, 'kl_dec_loss': kl_dec,
            'student_loss': own['loss'], 'loss_att': own['loss_att'],
            'loss_ctc': own['loss_ctc'], 'th_accuracy': own['th_accuracy']}


def decay_ts_weight(ts_weight: float, ts: TSConfig) -> float:
    """The multiplicative decay toward min_ts_weight."""
    return ((ts_weight - ts.min_ts_weight) * ts.decrease_factor
            + ts.min_ts_weight)
