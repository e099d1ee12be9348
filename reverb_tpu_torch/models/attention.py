"""Multi-headed attention: vanilla, WeNet rel-pos WITHOUT rel_shift, and the
grouped shared-memory cross-attention of nbest rescoring.

Counterpart of reverb_tpu/models/attention.py (`mha`, `rel_pos_mha`,
`cross_kv_batched`, `mha_shared_kv_grouped`).  Scores are normalized in
float32 whatever the activation dtype, and the probabilities are cast to
V's dtype before the second product.  The encoder's rel-pos attention runs
through kernel K1 (ops/flash_attention.py) with a key-padding mask.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from reverb_tpu_torch.models.modules import Linear
from reverb_tpu_torch.ops import flash_attention as fa

_MASK_VALUE = -1e9


def _split_heads(x, h: int):
    B, T, D = x.shape
    return x.reshape(B, T, h, D // h).transpose(1, 2)      # (B,H,T,dk) view


def _merge_heads(x):
    B, H, T, dk = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dk)


def _masked_softmax_av(scores, mask, value):
    """f32 softmax of scores with bool `mask` (True = keep, broadcastable),
    probabilities zeroed where masked and cast to value.dtype, then · V."""
    s = scores.to(torch.float32)
    if mask is not None:
        s = s.masked_fill(~mask, _MASK_VALUE)
        attn = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    else:
        attn = torch.softmax(s, dim=-1)
    return torch.matmul(attn.to(value.dtype), value)


class MultiHeadedAttention(nn.Module):
    """WeNet MultiHeadedAttention parameters: linear_q/k/v/out."""

    def __init__(self, n_head: int, n_feat: int, key_bias: bool = True):
        super().__init__()
        self.h = n_head
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(n_feat, n_feat, bias=key_bias)
        self.linear_v = Linear(n_feat, n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def forward(self, query, key, value, mask):
        """Vanilla MHA; mask bool (B, 1|T1, T2), True = keep."""
        q = _split_heads(self.linear_q(query), self.h)
        k = _split_heads(self.linear_k(key), self.h)
        v = _split_heads(self.linear_v(value), self.h)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        m = None if mask is None else mask[:, None, :, :scores.shape[-1]]
        return self.linear_out(_merge_heads(_masked_softmax_av(scores, m, v)))

    def cross_kv(self, memory):
        """K/V heads of a memory shared by many query rows: (B,T,D) →
        ((B,H,T,dk), (B,H,T,dk))."""
        return (_split_heads(self.linear_k(memory), self.h),
                _split_heads(self.linear_v(memory), self.h))

    def forward_shared_kv_grouped(self, query, kv, mask, group: int):
        """Each consecutive block of `group` query rows attends to one
        utterance's (k, v): query (B·group, L, D), kv from `cross_kv`, mask
        (B, 1, T).  The group's rows are one query stream of length
        group·L, so every product is a plain batched matmul over B·H."""
        BG, L, D = query.shape
        B = BG // group
        q = _split_heads(self.linear_q(query).reshape(B, group * L, D),
                         self.h)
        k, v = kv
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        m = None if mask is None else mask[:, None, :, :scores.shape[-1]]
        ctx = _masked_softmax_av(scores, m, v)
        return self.linear_out(_merge_heads(ctx)).reshape(BG, L, -1)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """WeNet RelPositionMultiHeadedAttention with rel_shift disabled (the
    variant the released weights were trained with):
    scores = ((q+u)·kᵀ + (q+v)·pᵀ) / √dk."""

    def __init__(self, n_head: int, n_feat: int, key_bias: bool = True):
        super().__init__(n_head, n_feat, key_bias)
        dk = n_feat // n_head
        self.linear_pos = Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, dk))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, dk))

    def reset_parameters(self, g):
        # xavier-uniform over (H, dk), as the JAX init
        h, dk = self.pos_bias_u.shape
        a = math.sqrt(6.0 / (dk + h))
        with torch.no_grad():
            self.pos_bias_u.uniform_(-a, a, generator=g)
            self.pos_bias_v.uniform_(-a, a, generator=g)

    def forward(self, x, kv_lens, pos_emb):
        """Self-attention over x (B, T, D) with the first kv_lens[b] keys of
        row b valid; pos_emb (1, T, D)."""
        q = _split_heads(self.linear_q(x), self.h)
        k = _split_heads(self.linear_k(x), self.h)
        v = _split_heads(self.linear_v(x), self.h)
        pos = _split_heads(self.linear_pos(pos_emb), self.h)
        ctx = fa.rel_pos_attention(q, k, v, pos, self.pos_bias_u,
                                   self.pos_bias_v, kv_lens)
        return self.linear_out(_merge_heads(ctx))
