"""The CTL model: one conformer run in a full-context view and a chunked
streaming view, with a contrastive loss between the two.

Counterpart of reverb_tpu/models/ctl.py (`sample_negatives`,
`ctl_contrastive_loss`, `ctl_compute_loss`):

    loss = loss_full + loss_chunk + ctl_weight · CTL

- loss_full: the hybrid CTC/attention loss of the full view, which takes
  no chunk mask at all (not even a static_chunk_size), so its attention is
  kernel K1's key-length mask;
- loss_chunk: the same loss of the chunk view, whose dynamic chunk is
  drawn with enable_full_context False (never the whole context;
  utils/common.py:dynamic_chunk_from_draws), so its attention takes the
  masked route;
- CTL: frame-level InfoNCE of the chunk view's frame against [the full
  view's frame at the same position; N negatives from the full view of
  the same utterance], at `temperature`, valid frames only, / their count.
  Added when ctl_weight > 0 and n_negatives > 0.

Gradients flow through both views and through the negatives; only the
index draw is not differentiable.
"""

from __future__ import annotations

import torch

from reverb_tpu_torch.models.asr_model import ASRModel, loss_from_encoder
from reverb_tpu_torch.parallel import global_batch as gb


def sample_negatives(y, n_negatives: int, lengths, generator=None,
                     neg_idxs=None):
    """Negatives from the same utterance: y (B, T, D) the full view,
    lengths (B,) valid frames.  Index ~ U[0, len − 1), then +1 where it
    reaches its own position t (so it is never the positive's frame).
    Returns (negs (N, B, T, D), neg_idxs (B, T, N)); `neg_idxs` replaces
    the draw."""
    B, T, D = y.shape
    if neg_idxs is None:
        high = torch.clamp(lengths.to(torch.int64) - 1, min=1)[:, None, None]
        u = torch.rand((B, T, n_negatives), generator=generator,
                       device=y.device)
        idx = torch.clamp((u * high).to(torch.int64), max=high - 1)
        t = torch.arange(T, device=y.device)[None, :, None]
        neg_idxs = torch.where(idx >= t, idx + 1, idx)
    flat = neg_idxs.reshape(B, T * n_negatives).to(torch.int64)
    negs = torch.gather(y, 1, flat[:, :, None].expand(-1, -1, D))
    return negs.reshape(B, T, n_negatives, D).permute(2, 0, 1, 3), neg_idxs


def ctl_contrastive_loss(x, y, negs, mask, temperature: float = 0.1):
    """InfoNCE over [positive; negatives]: x (B, T, D) the chunk view, y
    (B, T, D) the full view, negs (N, B, T, D), mask (B, 1, T) the chunk
    view's valid frames.  Negatives equal to the positive take −inf."""
    targets = torch.cat([y[None], negs], 0)
    neg_is_pos = (y[None] == negs).all(-1)
    xf = x.to(torch.float32)
    tf = targets.to(torch.float32)
    num = (xf[None] * tf).sum(-1)
    den = torch.clamp(torch.linalg.vector_norm(xf, dim=-1)[None]
                      * torch.linalg.vector_norm(tf, dim=-1), min=1e-8)
    logits = (num / den) / temperature
    logits = torch.cat([logits[:1], logits[1:].masked_fill(
        neg_is_pos, -torch.inf)], 0)
    ce = -torch.log_softmax(logits, 0)[0]
    valid = mask[:, 0, :]
    return (torch.where(valid, ce, torch.zeros_like(ce)).sum()
            / torch.clamp(gb.total(valid.sum()), min=1))


def ctl_compute_loss(model: ASRModel, batch, generator=None,
                     ctl_weight: float = 1.0, temperature: float = 0.1,
                     n_negatives: int = 0, neg_idxs=None):
    """Both views' hybrid losses and the contrastive term.  Dropout and the
    chunk view's chunk are drawn from `generator` (dropout none and the
    chunk from seed 0 without one); the negatives too, unless `neg_idxs`
    is given."""
    feats, lens = batch['feats'], batch['feats_lengths']
    cat = batch.get('cat_embs')
    cat = cat if model.cfg.lsl_enc else None
    x = feats.to(model.cfg.compute_dtype)
    full_out, full_mask = model.encoder(x, lens, cat, generator, -1,
                                        chunk_mask=False)
    norm = gb.norms(batch)
    full = loss_from_encoder(model, full_out, full_mask, batch, generator,
                             norm)
    chunk_gen = generator
    if chunk_gen is None:
        chunk_gen = torch.Generator(device=feats.device).manual_seed(0)
    chunk_out, chunk_mask = model.encoder(
        x, lens, cat, generator, 0, chunk_generator=chunk_gen,
        enable_full_context=False)
    chunk = loss_from_encoder(model, chunk_out, chunk_mask, batch, generator,
                              norm)
    ctl = torch.zeros((), dtype=torch.float32, device=feats.device)
    if ctl_weight > 0 and n_negatives > 0:
        negs, _ = sample_negatives(full_out, n_negatives,
                                   chunk_mask[:, 0, :].sum(-1), generator,
                                   neg_idxs)
        ctl = ctl_contrastive_loss(chunk_out, full_out, negs, chunk_mask,
                                   temperature)
    return {'loss': full['loss'] + chunk['loss'] + ctl_weight * ctl,
            'loss_full': full['loss'], 'loss_chunk': chunk['loss'],
            'loss_ctl': ctl, 'th_accuracy': full['th_accuracy'],
            'chunk_th_accuracy': chunk['th_accuracy']}
