"""Conformer encoder with Language-Specific Layers (LSL), full context,
chunk-masked and streaming.

Counterpart of reverb_tpu/models/encoder.py (`EncoderConfig`,
`subsampled_len`, `conv2d_subsampling4`, `conv_module`, `feed_forward`,
`_lsl_mix`, `conformer_layer`, `encoder_forward`, `init_stream_caches`,
`encoder_forward_chunk`, `encoder_forward_chunk_by_chunk`).  Module and
parameter names are WeNet's state-dict keys (encoder.embed.conv.0,
encoder.encoders.3.conv_module.depthwise_conv, ...).  An LSL layer mixes
per-language projections of the FFN input by `cat_embs` and adds the mix
to its output after norm_final (the trailing `x + y`).

Attention takes one of two routes, chosen by its arguments alone: with a
key-length mask and no cache, kernel K1 (ops/flash_attention.py); with a
chunk mask (B, T, T) or a KV cache, PyTorch matmuls and an f32 masked
softmax, as the JAX package computes it in XLA there.

Streaming: `init_stream_caches` and `encoder_forward_chunk` keep the JAX
package's static-shape rings — att (L, B, H, cache_t, 2·dk) and cnn
(L, B, D, k−1) — whose first cache_t − min(offset, cache_t) slots are
masked out of attention, with the rel-pos rows of each stream taken at its
absolute position; the offset is a scalar or one per stream.

Training: every forward takes an optional `torch.Generator`; with one,
dropout runs at the JAX package's sites and rates (positional dropout after
the subsampling, the FFNs' inner dropout, the residual-branch dropout of
every block, attention dropout on the probabilities), and without one the
forward is deterministic, as with rng=None there.  `use_dynamic_chunk`
training (decoding_chunk_size 0) draws its chunk from the same generator
(utils/common.py:draw_dynamic_chunk) and attends through the masked route,
as the JAX package's flash kernel rejects a (B, T, T) mask.  With
`gradient_checkpointing` a training forward checkpoints each layer
(models/modules.py:checkpoint_layer under `remat_policy`), replaying its
dropout draws exactly, as the JAX package remats each layer when it has
an rng.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from reverb_tpu_torch.models import embedding as emb
from reverb_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from reverb_tpu_torch.models.modules import (ACTIVATIONS, BatchNorm, Conv1d,
                                             Conv2d, LayerNorm, Linear,
                                             check_remat_policy,
                                             checkpoint_layer, dropout, glu)
from reverb_tpu_torch.utils.common import add_optional_chunk_mask

# right context + 1 of each subsampling rate: the raw frames of a
# one-frame window
CONTEXT = {1: 1, 4: 7, 6: 11, 8: 15}


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
    use_dynamic_chunk: bool = False
    use_dynamic_left_chunk: bool = False
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
    # per-layer activation checkpointing in training (with a generator):
    # models/modules.py:checkpoint_layer, policy 'full' | 'dots' |
    # 'dots_no_ln'
    gradient_checkpointing: bool = False
    remat_policy: str = 'dots'

    @property
    def head_dim(self):
        return self.output_size // self.attention_heads

    @property
    def subsampling_rate(self):
        return {'linear': 1, 'conv2d2': 2, 'conv2d': 4,
                'conv2d6': 6, 'conv2d8': 8}[self.input_layer]

    def check_supported(self):
        """Raise for the configurations this port does not run yet."""
        unsupported = {
            'input_layer': (self.input_layer, 'conv2d'),
            'pos_enc_layer_type': (self.pos_enc_layer_type, 'rel_pos'),
            'selfattention_layer_type': (self.selfattention_layer_type,
                                         'rel_selfattn'),
            'encoder_type': (self.encoder_type, 'conformer'),
            'normalize_before': (self.normalize_before, True),
        }
        for name, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f'encoder {name}={got!r} is not ported (only {want!r})')
        if self.use_cnn_module and self.cnn_module_norm not in (
                'batch_norm', 'layer_norm'):
            raise NotImplementedError(
                f'cnn_module_norm={self.cnn_module_norm!r} is not ported')
        check_remat_policy(self.remat_policy)


def subsampled_len(cfg: EncoderConfig, T: int) -> int:
    """Frames out of the subsampling for T input frames."""
    if cfg.input_layer == 'linear':
        return T
    if cfg.input_layer == 'conv2d':
        return ((T - 1) // 2 - 1) // 2
    if cfg.input_layer == 'conv2d6':
        return ((T - 1) // 2 - 2) // 3
    if cfg.input_layer == 'conv2d8':
        return (((T - 1) // 2 - 1) // 2 - 1) // 2
    raise ValueError(cfg.input_layer)


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
    """pw(2C) → GLU → depthwise(k) → norm → swish → pw, in (B,T,C).  The
    norm is BatchNorm from running statistics or, with
    cnn_module_norm='layer_norm', a LayerNorm (kernel K5).  A causal module
    pads k−1 frames on the left, or takes them from `cnn_cache` (B, C, k−1),
    and returns the last k−1 frames of its input as the next cache."""

    def __init__(self, d: int, kernel: int, activation: str,
                 causal: bool = False, norm: str = 'batch_norm'):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.lorder = kernel - 1 if causal else 0
        self.pad = 0 if causal else (kernel - 1) // 2
        self.pointwise_conv1 = Conv1d(d, 2 * d, 1)
        self.depthwise_conv = Conv1d(d, d, kernel, groups=d)
        self.norm = LayerNorm(d) if norm == 'layer_norm' else BatchNorm(d)
        self.pointwise_conv2 = Conv1d(d, d, 1)

    def forward(self, x, mask_pad, cnn_cache=None):
        """x (B, T, C); mask_pad (B, 1, T) or None.  Returns (out, the new
        cache (B, C, k−1), or None when the module is not causal)."""
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if mask_pad is not None:
            keep = mask_pad.transpose(1, 2)               # (B, T, 1)
            x = torch.where(keep, x, zero)
        new_cache = None
        if self.lorder:
            if cnn_cache is None:
                x = torch.nn.functional.pad(x, (0, 0, self.lorder, 0))
            else:
                x = torch.cat([cnn_cache.transpose(1, 2).to(x.dtype), x], 1)
            new_cache = x[:, -self.lorder:].transpose(1, 2)
        x = glu(self.pointwise_conv1.pointwise(x), dim=-1)
        x = self.depthwise_conv.depthwise(x, self.pad)
        x = self.act(self.norm(x))
        x = self.pointwise_conv2.pointwise(x)
        if mask_pad is not None:
            x = torch.where(keep, x, zero)
        return x, new_cache


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
            self.conv_module = ConvolutionModule(
                d, cfg.cnn_module_kernel, cfg.activation_type, cfg.causal,
                cfg.cnn_module_norm)
            self.norm_conv = LayerNorm(d)
            self.norm_final = LayerNorm(d)
        if is_lsl:
            self.language_layers = nn.ModuleList(
                Linear(d, d) for _ in range(cfg.num_langs))

    def forward(self, x, kv_lens, pos_emb, mask_pad, cat_embs=None,
                generator=None, mask=None):
        """reverb_tpu/models/encoder.py:conformer_layer, its dropout sites
        included (active when a generator is given).  Attention sees the
        first kv_lens[b] keys of row b (kernel K1), or, when `mask` (B, T,
        T) is given, the keys that mask keeps."""
        return self.forward_chunk(x, kv_lens, pos_emb, mask_pad, cat_embs,
                                  generator, mask)[0]

    def forward_chunk(self, x, kv_lens, pos_emb, mask_pad, cat_embs=None,
                      generator=None, mask=None, att_cache=None,
                      cnn_cache=None):
        """`forward` with the streaming caches: att_cache (B, H, Tc, 2·dk)
        is put before this chunk's keys and values, cnn_cache (B, C, k−1)
        before its conv input.  Returns (x, new_att_cache (B, H, Tc+T,
        2·dk) or None, new_cnn_cache or None)."""
        def drop(v):
            return dropout(v, self.rate, generator)

        if self.macaron:
            x = x + 0.5 * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), generator))
        xn = self.norm_mha(x)
        new_att = None
        if mask is None and att_cache is None:
            x_att = self.self_attn(xn, kv_lens, pos_emb, self.att_rate,
                                   generator)
        else:
            x_att, new_att = self.self_attn.forward_masked(
                xn, mask, pos_emb, att_cache, self.att_rate, generator)
        x = x + drop(x_att)
        new_cnn = None
        if self.conv_module is not None:
            xc, new_cnn = self.conv_module(self.norm_conv(x), mask_pad,
                                           cnn_cache)
            x = x + drop(xc)
        ff_scale = 0.5 if self.macaron else 1.0
        xn = self.norm_ff(x)
        if self.is_lsl:
            if cat_embs is None:
                raise ValueError('an LSL layer requires cat_embs')
            y = lsl_mix(self.language_layers, xn, cat_embs)
            x = x + ff_scale * drop(self.feed_forward(y, generator))
            if self.conv_module is not None:
                x = self.norm_final(x)
            return x + y, new_att, new_cnn
        x = x + ff_scale * drop(self.feed_forward(xn, generator))
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x, new_att, new_cnn


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

    def forward(self, xs, xs_lens, cat_embs=None, generator=None,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_generator=None,
                return_layers: bool = False):
        """xs (B, T, F) features, xs_lens (B,) → (out (B, T', D), mask
        (B, 1, T')); dropout when a generator is given.  The chunk mask
        follows reverb_tpu/models/encoder.py:encoder_forward
        (`add_optional_chunk_mask`): decoding_chunk_size > 0 on a
        use_dynamic_chunk model, or a static_chunk_size, masks each frame to
        its chunk and `num_decoding_left_chunks` chunks before it; with
        use_dynamic_chunk and decoding_chunk_size 0 the chunk is drawn from
        `chunk_generator`, else from `generator` (an evaluation draws its
        chunk, as WeNet's add_optional_chunk_mask does, without dropout).
        `return_layers` adds the list of every layer's output, before the
        final norm (the context adaptor's input)."""
        cfg = self.cfg
        T = xs.shape[1]
        masks = (torch.arange(T, device=xs.device)[None, :]
                 < xs_lens.to(xs.device)[:, None])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks, generator)
        kv_lens = masks[:, 0, :].sum(-1).to(torch.int32)
        chunk_masks = None
        # a use_dynamic_chunk model decoding with decoding_chunk_size < 0
        # gets masks & ones(T, T): every row keeps the same first kv_lens
        # keys, which is the key-length mask K1 takes — the same function,
        # so K1 computes it
        if (cfg.use_dynamic_chunk and decoding_chunk_size >= 0) or (
                not cfg.use_dynamic_chunk and cfg.static_chunk_size > 0):
            chunk_masks = add_optional_chunk_mask(
                masks, cfg.use_dynamic_chunk, cfg.use_dynamic_left_chunk,
                decoding_chunk_size, cfg.static_chunk_size,
                num_decoding_left_chunks,
                generator if chunk_generator is None else chunk_generator)
        layer_outs = []
        remat = (cfg.gradient_checkpointing and generator is not None
                 and torch.is_grad_enabled())
        for layer in self.encoders:
            args = (xs, kv_lens, pos_emb, masks, cat_embs, generator,
                    chunk_masks)
            xs = (checkpoint_layer(layer, cfg.remat_policy, generator, *args)
                  if remat else layer(*args))
            layer_outs.append(xs)
        if return_layers:
            return self.after_norm(xs), masks, layer_outs
        return self.after_norm(xs), masks

    def forward_chunk(self, xs, offset, att_cache, cnn_cache, cat_embs=None):
        """One streaming chunk (reverb_tpu/models/encoder.py:
        encoder_forward_chunk): xs (B, window, F) raw features giving
        chunk_t frames, `offset` the absolute (subsampled) position of the
        chunk — an int, a 0-d tensor or one per stream (B,).  The att ring
        (L, B, H, cache_t, 2·dk) holds the last cache_t frames' keys and
        values, right-aligned; its first cache_t − min(offset, cache_t)
        slots are masked out.  Returns (ys (B, chunk_t, D), new att cache,
        new cnn cache)."""
        cfg = self.cfg
        B = xs.shape[0]
        dev = xs.device
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        cache_t = att_cache.shape[3]
        xs, _, _ = self.embed(xs, torch.ones((B, 1, xs.shape[1]),
                                             dtype=torch.bool, device=dev))
        chunk_t = xs.shape[1]
        S = cache_t + chunk_t
        off = torch.as_tensor(offset, device=dev).reshape(-1).to(torch.int64)
        pos_emb = emb.stream_position_rows(cfg.output_size, off, cache_t, S,
                                           xs.dtype)
        # key validity: the last min(offset, cache_t) cache slots and the
        # whole chunk
        valid_cache = torch.clamp(off, max=cache_t)
        slot = torch.arange(S, device=dev)
        key_mask = (slot[None, None, :]
                    >= cache_t - valid_cache[:, None, None]).expand(B, 1, S)
        new_att, new_cnn = [], []
        for i, layer in enumerate(self.encoders):
            xs, a, c = layer.forward_chunk(
                xs, None, pos_emb, None, cat_embs, mask=key_mask,
                att_cache=att_cache[i],
                cnn_cache=None if cnn_cache is None else cnn_cache[i])
            new_att.append(a[:, :, a.shape[2] - cache_t:])
            if c is not None:
                new_cnn.append(c)
        xs = self.after_norm(xs)
        return (xs, torch.stack(new_att, 0),
                torch.stack(new_cnn, 0) if new_cnn else cnn_cache)

    def forward_chunk_by_chunk(self, xs, decoding_chunk_size: int,
                               num_decoding_left_chunks: int = -1,
                               cat_embs=None):
        """The whole utterance xs (B, T, F) through `forward_chunk`, window
        by window (reverb_tpu/models/encoder.py:
        encoder_forward_chunk_by_chunk): windows of (chunk − 1)·sub +
        context raw frames at a stride of sub·chunk, the caches carried,
        cache_t = chunk · num_left (16 when num_left < 0).  Returns (ys
        (B, T', D), mask (B, 1, T'))."""
        sub = self.cfg.subsampling_rate
        context = CONTEXT[sub]
        stride = sub * decoding_chunk_size
        window = (decoding_chunk_size - 1) * sub + context
        num_left = (num_decoding_left_chunks if num_decoding_left_chunks >= 0
                    else 16)
        att, cnn = init_stream_caches(
            self.cfg, decoding_chunk_size * num_left, xs.shape[0], xs.dtype,
            xs.device)
        outputs, offset = [], 0
        T = xs.shape[1]
        for start in range(0, T - context + 1, stride):
            ys, att, cnn = self.forward_chunk(
                xs[:, start:min(start + window, T)], offset, att, cnn,
                cat_embs)
            outputs.append(ys)
            offset += ys.shape[1]
        ys = torch.cat(outputs, 1)
        return ys, torch.ones((xs.shape[0], 1, ys.shape[1]),
                              dtype=torch.bool, device=xs.device)


def init_stream_caches(cfg: EncoderConfig, cache_t: int, batch: int = 1,
                       dtype=torch.float32, device=None):
    """Zero streaming caches: att (L, B, H, cache_t, 2·dk) and cnn
    (L, B, D, k−1), or None when the conv module is not causal."""
    att = torch.zeros((cfg.num_blocks, batch, cfg.attention_heads, cache_t,
                       2 * cfg.head_dim), dtype=dtype, device=device)
    lorder = (cfg.cnn_module_kernel - 1
              if cfg.use_cnn_module and cfg.causal else 0)
    cnn = (torch.zeros((cfg.num_blocks, batch, cfg.output_size, lorder),
                       dtype=dtype, device=device) if lorder else None)
    return att, cnn
