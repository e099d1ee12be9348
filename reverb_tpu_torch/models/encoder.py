"""Conformer encoder with Language-Specific Layers (LSL), full context.

Counterpart of reverb_tpu/models/encoder.py (`EncoderConfig`,
`conv2d_subsampling4`, `conv_module`, `feed_forward`, `_lsl_mix`,
`conformer_layer`, `encoder_forward`).  Module and parameter names are
WeNet's state-dict keys (encoder.embed.conv.0, encoder.encoders.3.
conv_module.depthwise_conv, ...).  An LSL layer mixes per-language
projections of the FFN input by `cat_embs` and adds the mix to its output
after norm_final (the trailing `x + y`).

Training: every forward takes an optional `torch.Generator`; with one,
dropout runs at the JAX package's sites and rates (positional dropout after
the subsampling, the FFNs' inner dropout, the residual-branch dropout of
every block, attention dropout on the probabilities), and without one the
forward is deterministic, as with rng=None there.

Streaming (chunk masks, caches) is not part of this port yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from reverb_tpu_torch.models import embedding as emb
from reverb_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from reverb_tpu_torch.models.modules import (ACTIVATIONS, BatchNorm, Conv1d,
                                             Conv2d, LayerNorm, Linear,
                                             dropout, glu)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.0
    input_layer: str = 'conv2d'
    pos_enc_layer_type: str = 'rel_pos'
    normalize_before: bool = True
    static_chunk_size: int = 0
    macaron_style: bool = True
    selfattention_layer_type: str = 'rel_selfattn'
    activation_type: str = 'swish'
    use_cnn_module: bool = True
    cnn_module_kernel: int = 15
    causal: bool = False
    cnn_module_norm: str = 'batch_norm'
    key_bias: bool = True
    num_langs: int = 0          # >0 → first+last layers are LSL
    encoder_type: str = 'conformer'

    def check_supported(self):
        """Raise for the configurations this port does not run yet."""
        unsupported = {
            'input_layer': (self.input_layer, 'conv2d'),
            'pos_enc_layer_type': (self.pos_enc_layer_type, 'rel_pos'),
            'selfattention_layer_type': (self.selfattention_layer_type,
                                         'rel_selfattn'),
            'encoder_type': (self.encoder_type, 'conformer'),
            'normalize_before': (self.normalize_before, True),
            'causal': (self.causal, False),
            'static_chunk_size': (self.static_chunk_size, 0),
        }
        for name, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f'encoder {name}={got!r} is not ported (only {want!r})')


class Conv2dSubsampling4(nn.Module):
    """embed.conv.{0,2} (3×3, stride 2, ReLU) → embed.out.0 → rel-pos."""

    def __init__(self, idim: int, odim: int, pos_rate: float = 0.0):
        super().__init__()
        self.pos_rate = pos_rate
        self.conv = nn.ModuleDict({'0': Conv2d(1, odim, 3, 3, (2, 2)),
                                   '2': Conv2d(odim, odim, 3, 3, (2, 2))})
        self.out = nn.ModuleDict(
            {'0': Linear(odim * (((idim - 1) // 2 - 1) // 2), odim)})

    def forward(self, x, x_mask, generator=None):
        """x (B,T,F), x_mask (B,1,T) → (x (B,T',D), pos_emb, mask (B,1,T'))."""
        x = torch.relu(self.conv['0'](x[:, None]))
        x = torch.relu(self.conv['2'](x))
        B, C, T, F = x.shape
        x = self.out['0'](x.transpose(1, 2).reshape(B, T, C * F))
        x, pos = emb.rel_position_encoding(x, self.pos_rate, generator)
        return x, pos, x_mask[:, :, 2::2][:, :, 2::2]


class FeedForward(nn.Module):
    """w_2(dropout(act(w_1(x)))), the dropout at `rate` (the block's
    dropout_rate) when a generator is given."""

    def __init__(self, d: int, hidden: int, activation: str,
                 rate: float = 0.0):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.rate = rate
        self.w_1 = Linear(d, hidden)
        self.w_2 = Linear(hidden, d)

    def forward(self, x, generator=None):
        return self.w_2(dropout(self.act(self.w_1(x)), self.rate, generator))


class ConvolutionModule(nn.Module):
    """pw(2C) → GLU → depthwise(k) → BatchNorm → swish → pw, in (B,T,C)."""

    def __init__(self, d: int, kernel: int, activation: str):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.pad = (kernel - 1) // 2
        self.pointwise_conv1 = Conv1d(d, 2 * d, 1)
        self.depthwise_conv = Conv1d(d, d, kernel, groups=d)
        self.norm = BatchNorm(d)
        self.pointwise_conv2 = Conv1d(d, d, 1)

    def forward(self, x, mask_pad):
        keep = mask_pad.transpose(1, 2)                   # (B, T, 1)
        x = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        x = glu(self.pointwise_conv1.pointwise(x), dim=-1)
        x = self.depthwise_conv.depthwise(x, self.pad)
        x = self.act(self.norm(x))
        x = self.pointwise_conv2.pointwise(x)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def lsl_mix(language_layers, x, cat_embs):
    """y = Σ_i cat_embs[i] · Linear_i(x); cat_embs (num_langs,) or
    (B, num_langs)."""
    ys = torch.stack([lin(x) for lin in language_layers], 0)   # (L,B,T,D)
    if cat_embs.dim() == 1:
        w = cat_embs.to(x.dtype)[:, None, None, None]
    else:
        w = cat_embs.to(x.dtype).t()[:, :, None, None]
    return (w * ys).sum(0)


class ConformerEncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, is_lsl: bool):
        super().__init__()
        d = cfg.output_size
        self.is_lsl = is_lsl
        self.macaron = cfg.macaron_style
        self.rate = cfg.dropout_rate
        self.att_rate = cfg.attention_dropout_rate
        self.self_attn = RelPositionMultiHeadedAttention(
            cfg.attention_heads, d, cfg.key_bias)
        self.feed_forward = FeedForward(d, cfg.linear_units,
                                        cfg.activation_type, cfg.dropout_rate)
        self.norm_ff = LayerNorm(d)
        self.norm_mha = LayerNorm(d)
        if cfg.macaron_style:
            self.feed_forward_macaron = FeedForward(
                d, cfg.linear_units, cfg.activation_type, cfg.dropout_rate)
            self.norm_ff_macaron = LayerNorm(d)
        self.conv_module = None
        if cfg.use_cnn_module:
            if cfg.cnn_module_norm != 'batch_norm':
                raise NotImplementedError('cnn_module_norm must be batch_norm')
            self.conv_module = ConvolutionModule(d, cfg.cnn_module_kernel,
                                                 cfg.activation_type)
            self.norm_conv = LayerNorm(d)
            self.norm_final = LayerNorm(d)
        if is_lsl:
            self.language_layers = nn.ModuleList(
                Linear(d, d) for _ in range(cfg.num_langs))

    def forward(self, x, kv_lens, pos_emb, mask_pad, cat_embs=None,
                generator=None):
        """reverb_tpu/models/encoder.py:conformer_layer, its dropout sites
        included (active when a generator is given)."""
        def drop(v):
            return dropout(v, self.rate, generator)

        if self.macaron:
            x = x + 0.5 * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), generator))
        x = x + drop(self.self_attn(self.norm_mha(x), kv_lens, pos_emb,
                                    self.att_rate, generator))
        if self.conv_module is not None:
            x = x + drop(self.conv_module(self.norm_conv(x), mask_pad))
        ff_scale = 0.5 if self.macaron else 1.0
        xn = self.norm_ff(x)
        if self.is_lsl:
            if cat_embs is None:
                raise ValueError('an LSL layer requires cat_embs')
            y = lsl_mix(self.language_layers, xn, cat_embs)
            x = x + ff_scale * drop(self.feed_forward(y, generator))
            if self.conv_module is not None:
                x = self.norm_final(x)
            return x + y
        x = x + ff_scale * drop(self.feed_forward(xn, generator))
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x


class GlobalCMVN(nn.Module):
    """(x − mean)·istd.  As in the JAX package, mean and istd are leaves of
    the parameter tree: they take gradients (which count in the global
    gradient norm) and are always frozen by the optimizer."""

    def __init__(self, dim: int):
        super().__init__()
        self.mean = nn.Parameter(torch.empty(dim))
        self.istd = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, g):
        with torch.no_grad():
            self.mean.zero_()
            self.istd.fill_(1.0)

    def forward(self, x):
        return (x - self.mean.to(x.dtype)) * self.istd.to(x.dtype)


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, with_cmvn: bool = False):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        self.global_cmvn = GlobalCMVN(cfg.input_size) if with_cmvn else None
        self.embed = Conv2dSubsampling4(cfg.input_size, cfg.output_size,
                                        cfg.positional_dropout_rate)
        self.encoders = nn.ModuleList(
            ConformerEncoderLayer(cfg, cfg.num_langs > 0 and
                                  i in (0, cfg.num_blocks - 1))
            for i in range(cfg.num_blocks))
        self.after_norm = LayerNorm(cfg.output_size)

    def forward(self, xs, xs_lens, cat_embs=None, generator=None):
        """xs (B, T, F) features, xs_lens (B,) → (out (B, T', D), mask
        (B, 1, T')); dropout when a generator is given."""
        T = xs.shape[1]
        masks = (torch.arange(T, device=xs.device)[None, :]
                 < xs_lens.to(xs.device)[:, None])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks, generator)
        kv_lens = masks[:, 0, :].sum(-1).to(torch.int32)
        for layer in self.encoders:
            xs = layer(xs, kv_lens, pos_emb, masks, cat_embs, generator)
        return self.after_norm(xs), masks
