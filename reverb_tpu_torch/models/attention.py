"""Multi-headed attention: vanilla, WeNet rel-pos WITHOUT rel_shift, and the
grouped shared-memory cross-attention of nbest rescoring.

Counterpart of reverb_tpu/models/attention.py (`mha`, `rel_pos_mha`,
`cross_kv_batched`, `mha_shared_kv_grouped`).  Scores are normalized in
float32 whatever the activation dtype, and the probabilities are cast to
V's dtype before the second product.  The encoder's rel-pos attention runs
through kernels K1/K4 (ops/flash_attention.py) with a key-padding mask; a
chunk mask or a streaming KV cache takes `forward_masked` (matmuls and a
masked softmax, as the JAX package takes XLA there).

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

from reverb_tpu_torch.models.modules import (Linear, dropout, join_splits,
                                             keep_mask)
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
                       generator=None, split=None):
    """`_masked_softmax` in value.dtype, dropped out (`split`: modules.
    keep_mask's), then · V."""
    attn = dropout(_masked_softmax(scores, mask, value.dtype), rate,
                   generator, split)
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
        # (1, rank, n) when the heads are split over a 'model' group of n
        # (parallel/sharding.py): dropout keeps the rank's heads of the
        # unsplit mask
        self.tp_split = None

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
            _masked_softmax_av(scores, m, v, rate, generator,
                               self.tp_split)))

    def forward_cached(self, x, mask, cache=None, rate: float = 0.0,
                       generator=None):
        """Vanilla self-attention over x (B, T, D) with a streaming KV
        cache (B, H, Tc, 2·dk) put before this chunk's keys and values
        (none: S = T); mask bool (B, 1|T, S), True = keep.  Returns (out,
        new cache (B, H, S, 2·dk))."""
        q = _split_heads(self.linear_q(x), self.h)
        k = _split_heads(self.linear_k(x), self.h)
        v = _split_heads(self.linear_v(x), self.h)
        if cache is not None:
            kc, vc = cache.to(k.dtype).chunk(2, dim=-1)
            k = torch.cat([kc, k], 2)
            v = torch.cat([vc, v], 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        m = None if mask is None else mask[:, None, :, :scores.shape[-1]]
        out = self.linear_out(_merge_heads(
            _masked_softmax_av(scores, m, v, rate, generator,
                               self.tp_split)))
        return out, torch.cat([k, v], -1)

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
        q = _split_heads(self.linear_q(query).reshape(B, group * L, -1),
                         self.h)
        k, v = kv
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        m = None if mask is None else mask[:, None, :, :scores.shape[-1]]
        attn = _masked_softmax(scores, m, v.dtype)
        ctx = torch.matmul(dropout(attn, rate, generator, self.tp_split), v)
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
                generator=None, q_valid=None, seq=None):
        """Self-attention over x (B, T, D) with the first kv_lens[b] keys of
        row b valid; pos_emb (1, T, D); attention dropout at `rate` when a
        generator is given.  With `q_valid` (B, T) bool the rows of padded
        queries get a zero context, which is what a (B, T, T) mask
        `valid ∧ validᵀ` gives them on the masked route (all keys masked,
        every probability zeroed).  Under 'seq' (`seq`, parallel/
        collectives.py:TimeSplit) x is this rank's block of queries and the
        keys and values are every rank's, gathered (pos_emb then holds the
        whole padded axis): K1 runs with Tq = the block, Tk = the axis, and
        the dropout mask is this rank's rows of the unsplit one."""
        q = _split_heads(self.linear_q(x), self.h)
        if seq is None:
            k = _split_heads(self.linear_k(x), self.h)
            v = _split_heads(self.linear_v(x), self.h)
        else:
            kv = seq.gather(torch.cat([self.linear_k(x), self.linear_v(x)],
                                      -1))
            k, v = (_split_heads(t, self.h) for t in kv.chunk(2, -1))
        pos = _split_heads(self.linear_pos(pos_emb), self.h)
        mask = None
        if generator is not None and rate > 0.0:
            B, H, T, _ = q.shape
            split = self.tp_split
            if seq is not None:
                split = join_splits(split, seq.entry(2),
                                    (3, 0, 1, seq.length))
            mask = keep_mask((B, H, T, k.shape[2]), rate, generator,
                             x.device, split).to(torch.int8)
        ctx = fa.rel_pos_attention(q, k, v, pos, self.pos_bias_u,
                                   self.pos_bias_v, kv_lens, mask, rate)
        if q_valid is not None:
            ctx = ctx * q_valid[:, None, :, None].to(ctx.dtype)
        return self.linear_out(_merge_heads(ctx))

    def forward_masked(self, x, mask, pos_emb, cache=None, rate: float = 0.0,
                       generator=None):
        """The route for what K1 does not take (reverb_tpu/models/
        attention.py:rel_pos_mha outside the flash kernel): a chunk mask or a
        streaming cache.  x (B, T, D); mask bool (B, 1|T, S), True = keep;
        pos_emb (1|B, S, D) rows of the S keys; cache (B, H, Tc, 2·dk) keys
        and values put before this chunk's (S = Tc + T).  The scores are
        plain matmuls, normalised by an f32 masked softmax.  Returns (out,
        new cache (B, H, S, 2·dk))."""
        q = _split_heads(self.linear_q(x), self.h)
        k = _split_heads(self.linear_k(x), self.h)
        v = _split_heads(self.linear_v(x), self.h)
        if cache is not None:
            kc, vc = cache.to(k.dtype).chunk(2, dim=-1)
            k = torch.cat([kc, k], 2)
            v = torch.cat([vc, v], 2)
        new_cache = torch.cat([k, v], -1)
        pos = _split_heads(self.linear_pos(pos_emb), self.h)
        u = self.pos_bias_u.to(q.dtype)[None, :, None, :]
        vb = self.pos_bias_v.to(q.dtype)[None, :, None, :]
        matrix_ac = torch.matmul(q + u, k.transpose(-1, -2))
        matrix_bd = torch.matmul(q + vb, pos.transpose(-1, -2))
        scores = (matrix_ac + matrix_bd[..., :matrix_ac.shape[-1]]) \
            / math.sqrt(q.shape[-1])
        m = None if mask is None else mask[:, None, :, :scores.shape[-1]]
        ctx = _masked_softmax_av(scores, m, v, rate, generator,
                                 self.tp_split)
        return self.linear_out(_merge_heads(ctx)), new_cache
