"""(Bi)Transformer decoder with Language-Specific Layers.

Counterpart of reverb_tpu/models/decoder.py (`DecoderConfig`,
`decoder_layer` with `mem_kv`/`mem_group`, `decoder_forward`,
`decoder_forward_one_step`).  An LSL decoder layer uses LayerNorm eps
1e-12, mixes the FFN input by `cat_embs`, and has no trailing `+ y`.  The
forward is the batched teacher-forced pass: each consecutive group of
`mem_group` hypothesis rows shares one utterance's precomputed
cross-attention K/V (nbest rescoring); with group 1 it is plain
cross-attention over a full memory (training).  With a `torch.Generator`
dropout runs at the JAX package's sites (decoder_layer, the positional
dropout of the embedding); without one the pass is deterministic.

`TransformerDecoder.forward_step` is the incremental step of the search
modes (attention, onmt, joint).  The reference's step caches each layer's
OUTPUTS and projects self-attention K/V over the whole buffer again at
every step; here each layer caches the k‖v row of every position when that
position is the query (as reverb_tpu/decode/joint_device.py:_decoder_rows
does), which is the same function of the same rows: one projection per
layer per step instead of one over the whole buffer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from reverb_tpu_torch.models import embedding as emb
from reverb_tpu_torch.models.attention import (MultiHeadedAttention,
                                               _masked_softmax, _merge_heads,
                                               _split_heads)
from reverb_tpu_torch.models.encoder import FeedForward, lsl_mix
from reverb_tpu_torch.models.modules import (Embedding, LayerNorm, Linear,
                                             dropout)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 5000
    encoder_output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    r_num_blocks: int = 0
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    self_attention_dropout_rate: float = 0.0
    src_attention_dropout_rate: float = 0.0
    input_layer: str = 'embed'
    use_output_layer: bool = True
    normalize_before: bool = True
    src_attention: bool = True
    key_bias: bool = True
    activation_type: str = 'relu'
    num_langs: int = 0           # >0 → first+last layers are LSL
    decoder_type: str = 'bitransformer'   # 'transformer' | 'bitransformer'
    compute_dtype: Optional[torch.dtype] = None


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, is_lsl: bool):
        super().__init__()
        d = cfg.encoder_output_size
        eps = 1e-12 if is_lsl else 1e-5
        self.is_lsl = is_lsl
        self.rate = cfg.dropout_rate
        self.self_rate = cfg.self_attention_dropout_rate
        self.src_rate = cfg.src_attention_dropout_rate
        self.self_attn = MultiHeadedAttention(cfg.attention_heads, d,
                                              cfg.key_bias)
        self.src_attn = MultiHeadedAttention(cfg.attention_heads, d,
                                             cfg.key_bias)
        self.feed_forward = FeedForward(d, cfg.linear_units,
                                        cfg.activation_type, cfg.dropout_rate)
        self.norm1 = LayerNorm(d, eps)
        self.norm2 = LayerNorm(d, eps)
        self.norm3 = LayerNorm(d, eps)
        if is_lsl:
            self.language_layers = nn.ModuleList(
                Linear(d, d) for _ in range(cfg.num_langs))

    def forward(self, x, tgt_mask, mem_kv, memory_mask, mem_group: int,
                cat_embs=None, generator=None):
        def drop(v):
            return dropout(v, self.rate, generator)

        xn = self.norm1(x)
        x = x + drop(self.self_attn(xn, xn, xn, tgt_mask, self.self_rate,
                                    generator))
        x = x + drop(self.src_attn.forward_shared_kv_grouped(
            self.norm2(x), mem_kv, memory_mask, mem_group, self.src_rate,
            generator))
        return self._ff_block(x, cat_embs, generator)

    def _ff_block(self, x, cat_embs, generator=None):
        """x + the feed-forward of norm3(x), LSL-mixed in an LSL layer."""
        xn = self.norm3(x)
        if self.is_lsl:
            if cat_embs is None:
                raise ValueError('an LSL decoder layer requires cat_embs')
            xn = lsl_mix(self.language_layers, xn, cat_embs)
        return x + dropout(self.feed_forward(xn, generator), self.rate,
                           generator)

    def forward_step(self, x, kv_cache, rows, steps, keep, mem_kv,
                     memory_mask, mem_group: int, cat_embs=None,
                     return_src_attn: bool = False):
        """The layer at one query position per row: x (R, 1, D) the layer's
        input there; kv_cache (R, Lb, 2D) this layer's k‖v rows, into which
        the query's own row is written at `steps` (in place); keep (R, 1, 1,
        Lb) the positions ≤ steps.  Returns (x (R, 1, D), cross-attention
        probabilities (B, H, group, T) or None)."""
        sa = self.self_attn
        D = x.shape[-1]
        xn = self.norm1(x)
        q = _split_heads(sa.linear_q(xn), sa.h)
        kv_cache[rows, steps] = torch.cat(
            [sa.linear_k(xn), sa.linear_v(xn)], -1)[:, 0].to(kv_cache.dtype)
        k = _split_heads(kv_cache[..., :D].to(x.dtype), sa.h)
        v = _split_heads(kv_cache[..., D:].to(x.dtype), sa.h)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        x = x + sa.linear_out(_merge_heads(torch.matmul(
            _masked_softmax(scores, keep, v.dtype), v)))
        ca = self.src_attn.forward_shared_kv_grouped(
            self.norm2(x), mem_kv, memory_mask, mem_group,
            return_weights=return_src_attn)
        ca, w = ca if return_src_attn else (ca, None)
        return self._ff_block(x + ca, cat_embs), w


class TransformerDecoder(nn.Module):
    """One direction: embed.0 + abs-pos → layers → after_norm →
    output_layer."""

    def __init__(self, cfg: DecoderConfig, n_blocks: int):
        super().__init__()
        d = cfg.encoder_output_size
        self.cfg = cfg
        self.embed = nn.ModuleDict({'0': Embedding(cfg.vocab_size, d)})
        self.decoders = nn.ModuleList(
            DecoderLayer(cfg, cfg.num_langs > 0 and i in (0, n_blocks - 1))
            for i in range(n_blocks))
        self.after_norm = LayerNorm(d)
        self.output_layer = Linear(d, cfg.vocab_size)

    def cross_kv(self, memory):
        return [layer.src_attn.cross_kv(memory) for layer in self.decoders]

    def forward(self, ys_in, ys_lens, mem_kv, memory_mask, mem_group: int,
                cat_embs=None, generator=None):
        """ys_in (N, L) sos-prefixed; ys_lens (N,) → logits (N, L, V)."""
        L = ys_in.shape[1]
        dev = ys_in.device
        pad = (torch.arange(L, device=dev)[None, :] < ys_lens[:, None])
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
        tgt_mask = pad[:, None, :] & causal[None]               # (N, L, L)
        x, _ = emb.abs_position_encoding(self.embed['0'](ys_in),
                                         self.cfg.positional_dropout_rate,
                                         generator)
        if self.cfg.compute_dtype is not None:
            x = x.to(self.cfg.compute_dtype)
        for layer, kv in zip(self.decoders, mem_kv):
            x = layer(x, tgt_mask, kv, memory_mask, mem_group, cat_embs,
                      generator)
        return self.output_layer(self.after_norm(x))

    def init_cache(self, rows: int, length: int, dtype, device):
        """The zero k‖v cache of `forward_step`: (n_layers, rows, length,
        2D)."""
        d = self.embed['0'].weight.shape[1]
        return torch.zeros((len(self.decoders), rows, length, 2 * d),
                           dtype=dtype, device=device)

    def forward_step(self, tok, steps, cache, mem_kv, memory_mask,
                     mem_group: int, cat_embs=None,
                     return_src_attn: bool = False):
        """One incremental step for R = B·mem_group rows: row r's token
        tok[r] sits at position steps[r] (R,) and attends to positions ≤
        steps[r], whose k‖v rows `cache` (from `init_cache`, reordered by
        the caller with its beams) holds; this step writes each row's own
        (in place).  Returns (logp (R, V) f32, the cache), and with
        `return_src_attn` also the cross-attention probabilities averaged
        over heads and layers (R, T) f32."""
        R = tok.shape[0]
        dev = tok.device
        d = self.embed['0'].weight.shape[1]
        x = self.embed['0'](tok.to(torch.int64))
        pe = emb.pe_table_on(d, dev)[steps.to(torch.int64)]
        x = (x * math.sqrt(d) + pe.to(x.dtype))[:, None]
        if self.cfg.compute_dtype is not None:
            x = x.to(self.cfg.compute_dtype)
        keep = (torch.arange(cache.shape[2], device=dev)[None, :]
                <= steps[:, None])[:, None, None, :]
        rows = torch.arange(R, device=dev)
        attn_sum = None
        for layer, kv_c, kv in zip(self.decoders, cache, mem_kv):
            x, w = layer.forward_step(x, kv_c, rows, steps.to(torch.int64),
                                      keep, kv, memory_mask, mem_group,
                                      cat_embs, return_src_attn)
            if return_src_attn:
                w = w.to(torch.float32).mean(1).reshape(R, -1)
                attn_sum = w if attn_sum is None else attn_sum + w
        y = self.output_layer(self.after_norm(x[:, 0]))
        logp = torch.log_softmax(y.to(torch.float32), -1)
        if return_src_attn:
            return logp, cache, attn_sum / len(self.decoders)
        return logp, cache


class BiTransformerDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.left_decoder = TransformerDecoder(cfg, cfg.num_blocks)
        self.right_decoder = TransformerDecoder(cfg, cfg.r_num_blocks)

    def forward(self, memory, memory_mask, ys_in, ys_lens, r_ys_in,
                reverse_weight: float, cat_embs=None, mem_group: int = 1,
                generator=None):
        """Teacher-forced pass over memory (B, T, D): ys_in (B·group, L)
        rows grouped by utterance (group 1 in training).  Returns
        (l_x (N,L,V), r_x or None)."""
        l_x = self.left_decoder(ys_in, ys_lens,
                                self.left_decoder.cross_kv(memory),
                                memory_mask, mem_group, cat_embs, generator)
        r_x = None
        if reverse_weight > 0.0 and self.cfg.r_num_blocks > 0:
            r_x = self.right_decoder(r_ys_in, ys_lens,
                                     self.right_decoder.cross_kv(memory),
                                     memory_mask, mem_group, cat_embs,
                                     generator)
        return l_x, r_x


def build_decoder(cfg: DecoderConfig) -> nn.Module:
    ported = {'decoder_type': 'bitransformer', 'input_layer': 'embed',
              'use_output_layer': True, 'normalize_before': True,
              'src_attention': True}
    for name, want in ported.items():
        if getattr(cfg, name) != want:
            raise NotImplementedError(
                f'decoder {name}={getattr(cfg, name)!r} is not ported '
                f'(only {want!r})')
    return BiTransformerDecoder(cfg)
