"""CTC head: projection + per-frame top-k with deferred normalization.

Counterpart of reverb_tpu/models/ctc.py (`ctc_topk_logprobs`).  The top-k
runs on the logits in their compute dtype (order-preserving), and only the
k winners and p(blank) are normalized by one f32 logsumexp, so the (B,T,V)
f32 log-prob table is never built.  Ties go to the lowest vocabulary index
(ops/topk.py).
"""

from __future__ import annotations

import torch
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
