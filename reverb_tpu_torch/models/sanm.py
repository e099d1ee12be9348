"""Ali-Paraformer SANM stack: LFR frontend, FSMN-memory attention, encoder,
decoder (+ the decoders3 tail block).

Counterpart of reverb_tpu/models/sanm.py (`SanmConfig`, `lfr`,
`whisper_sinusoids`, `_fsmn`, `sanm_self_attention`,
`sanm_cross_attention`, `_ali_encoder_layer`, `sanm_encoder_forward`,
`sanm_decoder_forward`, `sanm_forward_paraformer`).  Module and parameter
names are WeNet's state-dict keys (`encoder.encoders0.0.self_attn.
linear_q_k_v`, `...self_attn.fsmn_block`, `decoder.decoders.3.src_attn.
linear_k_v`, `decoder.decoders3.0.feed_forward.norm`, ...), so a
WeNet-converted checkpoint loads strictly (convert.py).

Numerics follow the JAX package:
  - SANM attention fills masked scores with the finite −1e9 in f32 and
    zeroes the masked probabilities after the softmax, so a fully masked
    (padded) query row stays finite; it is a plain matmul attention
    (the JAX package computes it in XLA), not kernel K1;
  - the fsmn block is a depthwise conv with the asymmetric padding
    `SanmConfig.fsmn_pad`, added to its masked input;
  - the encoder adds the whisper sinusoid table of width input_size, read
    from row 1, to x·√output_size;
  - `encoders0` maps the 560-dim LFR features to output_size and skips the
    residual;
  - the decoder layers' norm1-norm3 and decoders3's norm1 use eps 1e-12;
    the FFN's inner norm and after_norm keep 1e-5.
Every LayerNorm is `models.modules.LayerNorm`: over 512 and 2048 channels a
CUDA tensor launches kernel K5 (K6 in the backward); over the 560 LFR
channels (`encoders0.0.norm1`) it is the plain formulation, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.models.attention import _masked_softmax
from reverb_tpu_torch.models.encoder import count_seq_step
from reverb_tpu_torch.models.modules import (Conv1d, Embedding, LayerNorm,
                                             Linear, dropout)
from reverb_tpu_torch.parallel import collectives as tpc


@dataclasses.dataclass(frozen=True)
class SanmConfig:
    input_size: int = 560            # post-LFR feature dim (80 * m)
    output_size: int = 512
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 50
    decoder_blocks: int = 16
    vocab_size: int = 8404
    kernel_size: int = 11
    sanm_shift: int = 0
    dropout_rate: float = 0.1
    lfr_m: int = 7
    lfr_n: int = 6

    @property
    def fsmn_pad(self):
        left = (self.kernel_size - 1) // 2 + self.sanm_shift
        return (left, self.kernel_size - 1 - left)


# ------------------------------ LFR frontend ------------------------------

def lfr(x, x_lens, m: int = 7, n: int = 6):
    """Low-frame-rate stacking: output frame t stacks input frames
    [t·n − ⌊(m−1)/2⌋, … + m), clamped to [0, len − 1] per row (head-padded
    with frame 0, tail-padded with the last valid frame).  One gather.
    x (B, T, D) → ((B, ⌈T/n⌉, D·m), ⌈lens/n⌉)."""
    B, T, D = x.shape
    dev = x.device
    left = (m - 1) // 2
    T_out = -(-T // n)
    t_idx = (torch.arange(T_out, device=dev)[:, None] * n - left
             + torch.arange(m, device=dev)[None, :])            # (T_out, m)
    hi = torch.clamp(x_lens.to(dev), min=1)[:, None, None] - 1
    idx = torch.minimum(torch.clamp(t_idx[None], min=0), hi)    # (B,T_out,m)
    out = x[torch.arange(B, device=dev)[:, None, None], idx]
    new_lens = torch.div(x_lens + (n - 1), n, rounding_mode='floor')
    return out.reshape(B, T_out, m * D), new_lens


@functools.lru_cache(maxsize=8)
def whisper_sinusoids(d_model: int, max_len: int = 5000) -> np.ndarray:
    """openai-whisper sinusoid table (sin half, then cos half), built once
    per width (callers do not write to it)."""
    inc = np.log(10000) / (d_model // 2 - 1)
    inv = np.exp(-inc * np.arange(d_model // 2))
    t = np.arange(max_len)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def pad_mask(lens, T: int):
    """(B, 1, T) bool, True on the first lens[b] frames."""
    return (torch.arange(T, device=lens.device)[None, :]
            < lens[:, None])[:, None, :]


# ---------------------------- fsmn / attention ----------------------------

def fsmn(block: Conv1d, v, mask_pad, pad, rate: float = 0.0,
         generator=None, split=None):
    """FSMN memory: mask → depthwise conv (asymmetric pad (left, right), no
    bias) → + its input → dropout → mask.  v (B, T, C), mask_pad (B, 1, T)
    bool; `split` as in modules.keep_mask (a 'model' rank's channels)."""
    m = mask_pad[:, 0, :, None].to(v.dtype)
    v = v * m
    y = F.conv1d(F.pad(v.transpose(1, 2), pad), block.weight.to(v.dtype),
                 groups=block.groups).transpose(1, 2)
    return dropout(y + v, rate, generator, split) * m


def _heads(x, h: int):
    B, T, D = x.shape
    return x.reshape(B, T, h, D // h).transpose(1, 2)


class MultiHeadedAttentionSANM(nn.Module):
    """softmax(qkᵀ/√dk)·v → linear_out, plus the fsmn memory over v.

    Split over a 'model' group (parallel/sharding.py; `tp_split` = (-1,
    rank, n)) a rank holds its heads' rows of each third of linear_q_k_v,
    the fsmn taps of its v channels and linear_out's columns of them: its
    memory enters the row-parallel sum at its channels, so the sum is the
    unsplit output, and the memory's dropout keeps the rank's channels of
    the unsplit mask."""

    def __init__(self, n_head: int, in_feat: int, n_feat: int, kernel: int,
                 pad, rate: float):
        super().__init__()
        self.h = n_head
        self.pad = pad
        self.rate = rate
        self.linear_q_k_v = Linear(in_feat, 3 * n_feat)
        self.fsmn_block = Conv1d(n_feat, n_feat, kernel, groups=n_feat,
                                 bias=False)
        self.linear_out = Linear(n_feat, n_feat)
        self.tp_split = None

    def forward(self, x, mask, mask_pad, generator=None):
        """x (B, T, in); mask (B, T, T) bool; mask_pad (B, 1, T) bool."""
        B, T, _ = x.shape
        q, k, v = self.linear_q_k_v(x).chunk(3, dim=-1)
        mem = fsmn(self.fsmn_block, v, mask_pad, self.pad, self.rate,
                   generator, self.tp_split)
        q, k, v = _heads(q, self.h), _heads(k, self.h), _heads(v, self.h)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        att = _masked_softmax(scores, mask[:, None], x.dtype)
        ctx = torch.matmul(att, v).transpose(1, 2).reshape(B, T, -1)
        if self.tp_split is None:
            return self.linear_out(ctx) + mem
        _, rank, n = self.tp_split
        out = self.linear_out
        c = mem.shape[-1]
        part = F.linear(ctx, out.weight.to(ctx.dtype)) + F.pad(
            mem, (rank * c, (n - rank - 1) * c))
        return tpc.reduce_out(part, out.tp[1]) + out.bias.to(ctx.dtype)


class MultiHeadAttentionCross(nn.Module):
    """Cross-attention: q from the decoder stream, one fused k‖v projection
    of the encoder memory; q is scaled by dk^-½ before the product.  Split
    over a 'model' group a rank holds its heads' rows of linear_q and of
    each half of linear_k_v (parallel/sharding.py)."""

    def __init__(self, n_head: int, n_feat: int, target_size: int):
        super().__init__()
        self.h = n_head
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k_v = Linear(target_size, 2 * n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def forward(self, x, memory, memory_mask):
        """x (B, U, D); memory (B, T, D); memory_mask (B, 1, T) bool."""
        B, U, _ = x.shape
        q = _heads(self.linear_q(x), self.h)
        k, v = self.linear_k_v(memory).chunk(2, dim=-1)
        k, v = _heads(k, self.h), _heads(v, self.h)
        scores = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
        att = _masked_softmax(scores, memory_mask[:, None], x.dtype)
        ctx = torch.matmul(att, v).transpose(1, 2).reshape(B, U, -1)
        return self.linear_out(ctx)


# ------------------------------ encoder ------------------------------

class FeedForwardSANM(nn.Module):
    """The encoder layer's w_1 and w_2 (the layer applies them); split
    over a 'model' group (`tp_split` = (-1, rank, n)) a rank holds its
    hidden units and drops them with its block of the unsplit mask."""

    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.w_1 = Linear(d, hidden)
        self.w_2 = Linear(hidden, d)
        self.tp_split = None


class AliEncoderLayer(nn.Module):
    """Pre-norm SANM block; the residual of the attention is skipped when
    the layer resizes (encoders0)."""

    def __init__(self, cfg: SanmConfig, in_size: int):
        super().__init__()
        self.rate = cfg.dropout_rate
        self.resize = in_size != cfg.output_size
        self.self_attn = MultiHeadedAttentionSANM(
            cfg.attention_heads, in_size, cfg.output_size, cfg.kernel_size,
            cfg.fsmn_pad, cfg.dropout_rate)
        self.feed_forward = FeedForwardSANM(cfg.output_size,
                                            cfg.linear_units)
        self.norm1 = LayerNorm(in_size)
        self.norm2 = LayerNorm(cfg.output_size)

    def forward(self, x, mask, mask_pad, generator=None):
        att = dropout(self.self_attn(self.norm1(x), mask, mask_pad,
                                     generator), self.rate, generator)
        x = att if self.resize else x + att
        ff = self.feed_forward
        h = dropout(torch.relu(ff.w_1(self.norm2(x))), self.rate, generator,
                    ff.tp_split)
        return x + dropout(ff.w_2(h), self.rate, generator)


class SanmEncoder(nn.Module):
    """LFR → CMVN → x·√output_size + whisper sinusoids (from row 1) →
    encoders0 → encoders → after_norm.  The CMVN stats over the post-LFR
    dim are non-persistent buffers (`set_cmvn`): the JAX package keeps
    them outside the parameters, a constant of its loss and forward.
    Under 'seq' (`seq_split`, parallel/sharding.py) it runs whole on every
    rank (the LFR stacking and the fsmn memory have no split form;
    `seq_steps` counts the forwards)."""

    def __init__(self, cfg: SanmConfig):
        super().__init__()
        self.cfg = cfg
        self.seq_split = None
        self.seq_steps = {'split': 0, 'whole': 0}
        self.encoders0 = nn.ModuleList([AliEncoderLayer(cfg,
                                                        cfg.input_size)])
        self.encoders = nn.ModuleList(
            AliEncoderLayer(cfg, cfg.output_size)
            for _ in range(cfg.num_blocks - 1))
        self.after_norm = LayerNorm(cfg.output_size)
        self.register_buffer('cmvn_mean', None, persistent=False)
        self.register_buffer('cmvn_istd', None, persistent=False)

    def set_cmvn(self, mean, istd):
        dev = self.after_norm.weight.device
        self.cmvn_mean = torch.as_tensor(np.asarray(mean, np.float32),
                                         device=dev)
        self.cmvn_istd = torch.as_tensor(np.asarray(istd, np.float32),
                                         device=dev)

    def forward(self, feats, feats_lens, generator=None):
        """feats raw (B, T, 80) fbank, feats_lens (B,) → (out (B, T', D),
        mask (B, 1, T') bool)."""
        cfg = self.cfg
        count_seq_step(self, False)
        x, lens = lfr(feats, feats_lens, cfg.lfr_m, cfg.lfr_n)
        if self.cmvn_mean is not None:
            x = (x - self.cmvn_mean.to(x.dtype)) * self.cmvn_istd.to(x.dtype)
        T = x.shape[1]
        masks = pad_mask(lens.to(x.device), T)
        pe = torch.from_numpy(whisper_sinusoids(cfg.input_size)[1:T + 1])
        x = x * math.sqrt(cfg.output_size) + pe.to(x.device, x.dtype)[None]
        x = dropout(x, cfg.dropout_rate, generator)
        att_mask = masks & masks.transpose(1, 2)                # (B, T, T)
        for layer in (*self.encoders0, *self.encoders):
            x = layer(x, att_mask, masks, generator)
        return self.after_norm(x), masks


# ------------------------------ decoder ------------------------------

class FeedForwardDecoderSANM(nn.Module):
    """w_2(LayerNorm(dropout(relu(w_1 x)))), w_2 without bias.  Split over
    a 'model' group (`tp_split`, parallel/sharding.py) a rank holds its
    hidden units, and the LayerNorm normalises the ranks' units gathered
    (`LayerNorm.tp`, kernel K5 on the whole rows)."""

    def __init__(self, d: int, hidden: int, rate: float):
        super().__init__()
        self.rate = rate
        self.w_1 = Linear(d, hidden)
        self.w_2 = Linear(hidden, d, bias=False)
        self.norm = LayerNorm(hidden)
        self.tp_split = None

    def forward(self, x, generator=None):
        h = dropout(torch.relu(self.w_1(x)), self.rate, generator,
                    self.tp_split)
        return self.w_2(self.norm(h))


class _FsmnOnly(nn.Module):
    """DummyMultiHeadSANM: the fsmn block alone."""

    def __init__(self, d: int, kernel: int):
        super().__init__()
        self.fsmn_block = Conv1d(d, d, kernel, groups=d, bias=False)


class SanmDecoderLayer(nn.Module):
    def __init__(self, cfg: SanmConfig):
        super().__init__()
        d = cfg.output_size
        self.rate = cfg.dropout_rate
        self.pad = cfg.fsmn_pad
        self.self_attn = _FsmnOnly(d, cfg.kernel_size)
        self.src_attn = MultiHeadAttentionCross(cfg.attention_heads, d, d)
        self.feed_forward = FeedForwardDecoderSANM(d, cfg.linear_units,
                                                   cfg.dropout_rate)
        self.norm1 = LayerNorm(d, 1e-12)
        self.norm2 = LayerNorm(d, 1e-12)
        self.norm3 = LayerNorm(d, 1e-12)

    def forward(self, x, tgt_mask, memory, memory_mask, generator=None):
        tgt = self.feed_forward(self.norm1(x), generator)
        f = fsmn(self.self_attn.fsmn_block, self.norm2(tgt), tgt_mask,
                 self.pad, self.rate, generator)
        x = x + dropout(f, self.rate, generator)
        c = self.src_attn(self.norm3(x), memory, memory_mask)
        return x + dropout(c, self.rate, generator)


class _Decoders3(nn.Module):
    def __init__(self, cfg: SanmConfig):
        super().__init__()
        self.feed_forward = FeedForwardDecoderSANM(
            cfg.output_size, cfg.linear_units, cfg.dropout_rate)
        self.norm1 = LayerNorm(cfg.output_size, 1e-12)

    def forward(self, x, generator=None):
        return self.feed_forward(self.norm1(x), generator)


class SanmDecoder(nn.Module):
    """Non-autoregressive one-pass decoder over the CIF-fired embeddings:
    decoders → decoders3 → after_norm → output_layer (logits)."""

    def __init__(self, cfg: SanmConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.ModuleDict({'0': Embedding(cfg.vocab_size,
                                                   cfg.output_size)})
        self.decoders = nn.ModuleList(SanmDecoderLayer(cfg)
                                      for _ in range(cfg.decoder_blocks))
        self.decoders3 = nn.ModuleList([_Decoders3(cfg)])
        self.after_norm = LayerNorm(cfg.output_size)
        self.output_layer = Linear(cfg.output_size, cfg.vocab_size)

    def forward(self, memory, memory_mask, sematic_embeds, ys_lens,
                generator=None):
        """memory (B, T, D), memory_mask (B, 1, T), sematic_embeds (B, U, D),
        ys_lens (B,) → logits (B, U, V).  The embeddings take the memory's
        dtype (the fired ones are f32)."""
        x = sematic_embeds.to(memory.dtype)
        tgt_mask = pad_mask(ys_lens.to(x.device), x.shape[1])
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask, generator)
        for layer in self.decoders3:
            x = layer(x, generator)
        return self.output_layer(self.after_norm(x))
