"""Attention rescoring of CTC prefix-beam nbest lists, whole batch at once.

Counterpart of reverb_tpu/decode/rescoring.py (`_rescore_flat`,
`_rescore_device_all`).  The (B, N) nbest grid is flattened to B·N decoder
rows, grouped by utterance so each group shares its utterance's
cross-attention K/V.  The decoder's log-softmax is deferred: only the
hypothesis tokens' logits and one f32 logsumexp per position are taken, so
no (rows, L, V) f32 log-prob tensor is built.
"""

from __future__ import annotations

import torch

from reverb_tpu_torch.utils.common import reverse_sequence


def _rescore_flat(model, hyps_pad, hyps_lens, encoder_outs,
                  reverse_weight: float, cat_embs, enc_lens, group: int):
    """hyps_pad (M, Lmax) WITHOUT sos, rows grouped by utterance
    (M = B·group); encoder_outs (B, T, D); enc_lens (B,) valid frames.
    Returns (att (M,), r_att (M,), tok_logp (M, Lmax))."""
    cfg = model.cfg
    M, Lmax = hyps_pad.shape
    B, T, _ = encoder_outs.shape
    dev = hyps_pad.device
    f32 = torch.float32
    idx = torch.arange(Lmax, device=dev)
    valid = idx[None, :] < hyps_lens[:, None]                 # (M, Lmax)
    sos_col = torch.full((M, 1), cfg.sos, dtype=hyps_pad.dtype, device=dev)
    body = torch.where(valid, hyps_pad, torch.full_like(hyps_pad, cfg.eos))
    hyps_in = torch.cat([sos_col, body], 1)                   # (M, L+1)
    lens_in = hyps_lens + 1
    enc_mask = (torch.arange(T, device=dev)[None, :]
                < enc_lens.reshape(B)[:, None])[:, None, :]
    r_body = reverse_sequence(hyps_in[:, 1:], lens_in - 1, cfg.eos)
    r_hyps = torch.cat([hyps_in[:, :1], r_body], 1)
    dec_cat = cat_embs if cfg.lsl_dec else None
    l_x, r_x = model.decoder(encoder_outs, enc_mask, hyps_in, lens_in, r_hyps,
                             reverse_weight, dec_cat, mem_group=group)

    tok = torch.where(valid, hyps_pad, torch.zeros_like(hyps_pad)).to(
        torch.int64)
    lens64 = hyps_lens.to(torch.int64)[:, None]
    rows = torch.arange(M, device=dev)[:, None]

    def scores(x, pos):
        """Per-token log-probs (token j read at position pos[:, j]) and the
        eos log-prob."""
        lse = torch.logsumexp(x.to(f32), dim=-1)               # (M, L+1)
        val = x[rows, pos, tok].to(f32)
        logp = torch.where(valid, val - torch.gather(lse[:, :Lmax], 1, pos),
                           torch.zeros_like(val))
        eos_val = torch.gather(x[:, :, cfg.eos], 1, lens64)[:, 0].to(f32)
        eos_logp = eos_val - torch.gather(lse, 1, lens64)[:, 0]
        return logp, logp.sum(1) + eos_logp

    pos = idx[None, :].expand(M, Lmax)
    tok_logp, att = scores(l_x, pos)
    if r_x is not None:
        # the right decoder scores the reversed sequence: token j of a hyp
        # sits at position len-1-j of the reversed stream
        rpos = torch.where(valid, hyps_lens[:, None] - 1 - idx[None, :],
                           torch.zeros_like(pos)).to(torch.int64)
        r_tok_logp, r_att = scores(r_x, rpos)
        tok_logp = torch.where(
            valid,
            torch.log(torch.clamp(
                (torch.exp(tok_logp) + torch.exp(r_tok_logp)) / 2,
                min=1e-30)),
            torch.zeros_like(tok_logp))
    else:
        r_att = torch.zeros_like(att)
    return att, r_att, tok_logp


def _rescore_device_all(model, hyps_pad, hyps_lens, encoder_outs,
                        reverse_weight: float, cat_embs=None, enc_lens=None):
    """Whole-batch rescoring: hyps_pad (B,N,L), hyps_lens (B,N),
    encoder_outs (B,T,D), enc_lens (B,) → (att, r_att (B,N),
    tok_logp (B,N,L))."""
    B, N, Lmax = hyps_pad.shape
    att, r_att, tok_logp = _rescore_flat(
        model, hyps_pad.reshape(B * N, Lmax), hyps_lens.reshape(B * N),
        encoder_outs, reverse_weight, cat_embs, enc_lens, group=N)
    return (att.reshape(B, N), r_att.reshape(B, N),
            tok_logp.reshape(B, N, Lmax))
