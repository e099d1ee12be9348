"""Multi-headed attention: vanilla, WeNet rel-pos WITHOUT rel_shift, and the
grouped shared-memory cross-attention of nbest rescoring.

Counterpart of reverb_tpu/models/attention.py (`mha`, `rel_pos_mha`,
`cross_kv_batched`, `mha_shared_kv_grouped`).  Scores are normalized in
float32 whatever the activation dtype, and the probabilities are cast to
V's dtype before the second product.  The encoder's rel-pos attention runs
through kernels K1/K4 (ops/flash_attention.py) with a key-padding mask.

Attention dropout (rate, generator) follows the JAX package: the vanilla
paths drop the probabilities after their cast to V's dtype
(forward_attention); the rel-pos path draws a (B, H, Tq, Tk) int8
keep-mask outside the kernel and hands it over, as
rel_pos_flash_attention does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from reverb_tpu_torch.models.modules import Linear, dropout
from reverb_tpu_torch.ops import flash_attention as fa

_MASK_VALUE = -1e9


def _split_heads(x, h: int):
    B, T, D = x.shape
    return x.reshape(B, T, h, D // h).transpose(1, 2)      # (B,H,T,dk) view


def _merge_heads(x):
    B, H, T, dk = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dk)


def _masked_softmax(scores, mask, dtype):
    """f32 softmax of scores with bool `mask` (True = keep, broadcastable),
    probabilities zeroed where masked, cast to `dtype`."""
    s = scores.to(torch.float32)
    if mask is not None:
        s = s.masked_fill(~mask, _MASK_VALUE)
        attn = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    else:
        attn = torch.softmax(s, dim=-1)
    return attn.to(dtype)


def _masked_softmax_av(scores, mask, value, rate: float = 0.0,
                       generator=None):
    """`_masked_softmax` in value.dtype, dropped out, then · V."""
    attn = dropout(_masked_softmax(scores, mask, value.dtype), rate,
                   generator)
    return torch.matmul(attn, value)


class MultiHeadedAttention(nn.Module):
    """WeNet MultiHeadedAttention parameters: linear_q/k/v/out."""

    def __init__(self, n_head: int, n_feat: int, key_bias: bool = True):
        super().__init__()
        self.h = n_head
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(n_feat, n_feat, bias=key_bias)
        self.linear_v = Linear(n_feat, n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def forward(self, query, key, value, mask, rate: float = 0.0,
                generator=None):
        """Vanilla MHA; mask bool (B, 1|T1, T2), True = keep; attention
        dropout at `rate` when a generator is given."""
        q = _split_heads(self.linear_q(query), self.h)
        k = _split_heads(self.linear_k(key), self.h)
        v = _split_heads(self.linear_v(value), self.h)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        m = None if mask is None else mask[:, None, :, :scores.shape[-1]]
        return self.linear_out(_merge_heads(
            _masked_softmax_av(scores, m, v, rate, generator)))

    def cross_kv(self, memory):
        """K/V heads of a memory shared by many query rows: (B,T,D) →
        ((B,H,T,dk), (B,H,T,dk))."""
        return (_split_heads(self.linear_k(memory), self.h),
                _split_heads(self.linear_v(memory), self.h))

    def forward_shared_kv_grouped(self, query, kv, mask, group: int,
                                  rate: float = 0.0, generator=None,
                                  return_weights: bool = False):
        """Each consecutive block of `group` query rows attends to one
        utterance's (k, v): query (B·group, L, D), kv from `cross_kv`, mask
        (B, 1, T).  The group's rows are one query stream of length
        group·L, so every product is a plain batched matmul over B·H.  With
        group 1 this is plain cross-attention over a full memory (the
        teacher-forced decoder), with attention dropout at `rate`.  With
        `return_weights` also the probabilities (B, H, group·L, T) in V's
        dtype, before dropout."""
        BG, L, D = query.shape
        B = BG // group
        q = _split_heads(self.linear_q(query).reshape(B, group * L, D),
                         self.h)
        k, v = kv
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        m = None if mask is None else mask[:, None, :, :scores.shape[-1]]
        attn = _masked_softmax(scores, m, v.dtype)
        ctx = torch.matmul(dropout(attn, rate, generator), v)
        out = self.linear_out(_merge_heads(ctx)).reshape(BG, L, -1)
        return (out, attn) if return_weights else out


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

    def forward(self, x, kv_lens, pos_emb, rate: float = 0.0,
                generator=None):
        """Self-attention over x (B, T, D) with the first kv_lens[b] keys of
        row b valid; pos_emb (1, T, D); attention dropout at `rate` when a
        generator is given."""
        q = _split_heads(self.linear_q(x), self.h)
        k = _split_heads(self.linear_k(x), self.h)
        v = _split_heads(self.linear_v(x), self.h)
        pos = _split_heads(self.linear_pos(pos_emb), self.h)
        mask = None
        if generator is not None and rate > 0.0:
            B, H, T, _ = q.shape
            mask = (torch.rand((B, H, T, k.shape[2]), generator=generator,
                               device=x.device) < 1.0 - rate).to(torch.int8)
        ctx = fa.rel_pos_attention(q, k, v, pos, self.pos_bias_u,
                                   self.pos_bias_v, kv_lens, mask, rate)
        return self.linear_out(_merge_heads(ctx))
