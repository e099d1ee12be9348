"""Conformer / transformer encoder with Language-Specific Layers (LSL),
full context, chunk-masked and streaming.

Counterpart of reverb_tpu/models/encoder.py (`EncoderConfig`,
`subsampled_len`, `conv2d_subsampling4`, `linear_input`, `_pos_enc`,
`conv_module`, `feed_forward`, `_lsl_mix`, `conformer_layer`,
`transformer_layer`, `encoder_forward`, `init_stream_caches`,
`encoder_forward_chunk`, `encoder_forward_chunk_by_chunk`).  The options:
input_layer 'conv2d' or 'linear' (linear → LayerNorm → dropout; the JAX
package has no subsampling function for conv2d2/6/8, and neither has the
port); pos_enc_layer_type 'rel_pos', 'abs_pos', 'abs_pos_whisper' or
'no_pos'; selfattention_layer_type 'rel_selfattn' or 'selfattn' (plain
MHA inside the conformer block); encoder_type 'conformer' or 'transformer'
(a pre-norm MHA + relu FFN block, `norm1`/`norm2`); normalize_before False
drops only the final `after_norm`, as in the JAX package (the blocks stay
pre-norm).  Module and
parameter names are WeNet's state-dict keys (encoder.embed.conv.0,
encoder.encoders.3.conv_module.depthwise_conv, ...).  An LSL layer mixes
per-language projections of the FFN input by `cat_embs` and adds the mix
to its output after norm_final (the trailing `x + y`).

Rel-pos attention takes one of two routes, chosen by its arguments alone:
with a key-length mask and no cache, kernel K1 (ops/flash_attention.py);
with a chunk mask (B, T, T) or a KV cache, PyTorch matmuls and an f32
masked softmax, as the JAX package computes it in XLA there.  Plain MHA
('selfattn', the transformer block) is that masked route always, as in
JAX.

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
from reverb_tpu_torch.models.attention import (
    MultiHeadedAttention, RelPositionMultiHeadedAttention)
from reverb_tpu_torch.models.modules import (ACTIVATIONS, BatchNorm, Conv1d,
                                             Conv2d, LayerNorm, Linear,
                                             check_remat_policy,
                                             checkpoint_layer, dropout, glu,
                                             join_splits, keep_mask)
from reverb_tpu_torch.parallel import collectives as tpc
from reverb_tpu_torch.ops.topk import topk_lastdim
from reverb_tpu_torch.utils.common import add_optional_chunk_mask

# right context + 1 of each subsampling rate: the raw frames of a
# one-frame window
CONTEXT = {1: 1, 4: 7, 6: 11, 8: 15}
# the input layers with a subsampling function (the JAX package's
# SUBSAMPLE_FNS)
INPUT_LAYERS = ('conv2d', 'linear')


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
    # MoE feed-forward (positionwise_layer_type 'moe'): token-choice top-k
    # over n_expert experts (`MoEFeedForward`)
    positionwise_layer_type: str = 'position_wise_feed_forward'
    n_expert: int = 8
    n_expert_per_token: int = 3
    # GPipe over a 'pipe' mesh axis of this many stages (the homogeneous
    # middle stack, `ConformerEncoder.pipe_region`), in this many
    # microbatches; sequential without a matching axis
    pipeline_stages: int = 1
    pipeline_microbatches: int = 2

    @property
    def head_dim(self):
        return self.output_size // self.attention_heads

    @property
    def subsampling_rate(self):
        return {'linear': 1, 'conv2d2': 2, 'conv2d': 4,
                'conv2d6': 6, 'conv2d8': 8}[self.input_layer]

    def check_supported(self):
        """Raise for the configurations neither package builds: a
        subsampling without a function in the JAX package (conv2d2,
        conv2d6, conv2d8), or an unknown option."""
        if self.input_layer not in INPUT_LAYERS:
            raise NotImplementedError(
                f'encoder input_layer={self.input_layer!r}: the JAX package '
                f'has no subsampling function for it either (it builds '
                f'{INPUT_LAYERS})')
        options = {
            'pos_enc_layer_type': (self.pos_enc_layer_type,
                                   emb.POS_ENC_TYPES),
            'selfattention_layer_type': (self.selfattention_layer_type,
                                         ('rel_selfattn', 'selfattn')),
            'encoder_type': (self.encoder_type,
                             ('conformer', 'transformer')),
        }
        for name, (got, known) in options.items():
            if got not in known:
                raise ValueError(f'encoder {name}={got!r} is not one of '
                                 f'{known}')
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
    """embed.conv.{0,2} (3×3, stride 2, ReLU) → embed.out.0 → the
    positional encoding (`pos_type`, rel-pos by default)."""

    def __init__(self, idim: int, odim: int, pos_rate: float = 0.0,
                 pos_type: str = 'rel_pos'):
        super().__init__()
        self.pos_rate = pos_rate
        self.pos_type = pos_type
        self.conv = nn.ModuleDict({'0': Conv2d(1, odim, 3, 3, (2, 2)),
                                   '2': Conv2d(odim, odim, 3, 3, (2, 2))})
        self.out = nn.ModuleDict(
            {'0': Linear(odim * (((idim - 1) // 2 - 1) // 2), odim)})

    def forward(self, x, x_mask, generator=None, seq=None):
        """x (B,T,F), x_mask (B,1,T) → (x (B,T',D), pos_emb, mask (B,1,T')).
        Under 'seq' (`seq`, a TimeSplit of the T' frames) x is this rank's
        block of the T' frames, computed from the input frames
        [4·start, 4·(start + b) + 3) that its two stride-2 3×3 convs read
        (every rank holds the whole feature rows, so the halo is read in
        place), zeros past T'; pos_emb and the mask stay whole."""
        mask = x_mask[:, :, 2::2][:, :, 2::2]
        if seq is None:
            x = self._convs(x)
        else:
            lo = 4 * seq.start
            n_out = min(seq.block, seq.length - seq.start)
            D = self.out['0'].weight.shape[0]
            y = self._convs(x[:, lo:lo + 4 * seq.block + 3]) if n_out > 0 \
                else x.new_zeros((x.shape[0], 0, D))
            x = torch.cat([y, y.new_zeros((x.shape[0], seq.block - n_out,
                                           D))], 1)
        x, pos = emb.position_encoding(self.pos_type, x, self.pos_rate,
                                       generator, seq)
        return x, pos, mask

    def _convs(self, x):
        x = torch.relu(self.conv['0'](x[:, None]))
        x = torch.relu(self.conv['2'](x))
        B, C, T, F = x.shape
        return self.out['0'](x.transpose(1, 2).reshape(B, T, C * F))


class LinearInput(nn.Module):
    """embed.out.0 (a linear layer) → embed.out.1 (LayerNorm) → dropout
    at the block's dropout_rate → the positional encoding; no
    subsampling."""

    def __init__(self, idim: int, odim: int, rate: float = 0.0,
                 pos_rate: float = 0.0, pos_type: str = 'rel_pos'):
        super().__init__()
        self.rate = rate
        self.pos_rate = pos_rate
        self.pos_type = pos_type
        self.out = nn.ModuleDict({'0': Linear(idim, odim),
                                  '1': LayerNorm(odim)})

    def forward(self, x, x_mask, generator=None):
        x = dropout(self.out['1'](self.out['0'](x)), self.rate, generator)
        x, pos = emb.position_encoding(self.pos_type, x, self.pos_rate,
                                       generator)
        return x, pos, x_mask


def input_layer(cfg: EncoderConfig) -> nn.Module:
    """The encoder's `embed`: Conv2dSubsampling4 or LinearInput."""
    if cfg.input_layer == 'linear':
        return LinearInput(cfg.input_size, cfg.output_size,
                           cfg.dropout_rate, cfg.positional_dropout_rate,
                           cfg.pos_enc_layer_type)
    return Conv2dSubsampling4(cfg.input_size, cfg.output_size,
                              cfg.positional_dropout_rate,
                              cfg.pos_enc_layer_type)


class FeedForward(nn.Module):
    """w_2(dropout(act(w_1(x)))), the dropout at `rate` (the block's
    dropout_rate) when a generator is given."""

    def __init__(self, d: int, hidden: int, activation: str,
                 rate: float = 0.0):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.rate = rate
        self.hidden = hidden
        self.w_1 = Linear(d, hidden)
        self.w_2 = Linear(hidden, d)
        # (-1, rank, n) when the hidden units are split over a 'model'
        # group of n (parallel/sharding.py)
        self.tp_split = None

    def _split(self, seq):
        return join_splits(self.tp_split, None if seq is None
                           else seq.entry(1))

    def forward(self, x, generator=None, seq=None):
        """x (B, T, D); under 'seq' this rank's time block, its dropout the
        block of the unsplit mask."""
        return self.w_2(dropout(self.act(self.w_1(x)), self.rate, generator,
                                self._split(seq)))

    def skip(self, x, generator=None, seq=None):
        """Draw the dropout mask `forward(x)` would draw, and nothing
        else: an expert another 'expert' rank computes."""
        if generator is not None and self.rate > 0.0:
            keep_mask(tuple(x.shape[:-1]) + (self.hidden,), self.rate,
                      generator, x.device, self._split(seq))


class MoEFeedForward(nn.Module):
    """Token-choice top-k mixture of experts (reverb_tpu/models/encoder.py:
    moe_feed_forward): a gate linear without bias gives each token's
    router logits over the experts, the top k (ties to the lower index,
    ops/topk.py) are softmaxed in f32 and cast to the activation dtype,
    and the output is the dense weighted sum of every expert's FFN over
    all tokens, the experts not chosen for a token weighing 0 — the JAX
    package's arithmetic.  The experts are `FeedForward`s under WeNet's
    names (`experts.{e}.w_1`, `experts.{e}.w_2`); each runs as two plain
    products.  (JAX's einsums over the stacked f32 expert weights promote
    a bf16 activation to f32; here the weights take the activation's
    dtype, as every other layer's do.)

    Under 'expert' (`expert_split` = (group, rank, n), parallel/
    sharding.py) a rank holds experts [rE/n, (r+1)E/n) and sums their
    weighted outputs; the ranks' partial sums meet in `reduce_out`, the
    experts' input goes through `copy_in`, and so do the routing weights
    (a rank differentiates only its experts' weights, and every rank's
    gate must take the whole gradient, as a replicated parameter does).
    Routing runs on every rank.  A rank draws the dropout masks of the
    other ranks' experts too, in order, so its experts drop what they
    drop in the unsplit layer."""

    def __init__(self, d: int, hidden: int, activation: str, rate: float,
                 n_expert: int, n_expert_per_token: int):
        super().__init__()
        self.k = min(n_expert_per_token, n_expert)
        self.gate = Linear(d, n_expert, bias=False)
        self.experts = nn.ModuleList(
            FeedForward(d, hidden, activation, rate)
            for _ in range(n_expert))
        self.expert_split = None

    def route(self, xs):
        """xs (N, D) → (weights (N, k) in xs.dtype, expert indices
        (N, k))."""
        logits, idx = topk_lastdim(self.gate(xs), self.k)
        return torch.softmax(logits.to(torch.float32), -1).to(xs.dtype), idx

    def forward(self, x, generator=None, seq=None):
        B, L, D = x.shape
        E = len(self.experts)
        w, idx = self.route(x.reshape(-1, D))
        we = torch.zeros((B * L, E), dtype=w.dtype, device=w.device) \
            .scatter(1, idx, w).reshape(B, L, E)
        own, xe = range(E), x
        if self.expert_split is not None:
            group, rank, n = self.expert_split
            own = range(rank * (E // n), (rank + 1) * (E // n))
            we, xe = tpc.copy_in(we, group), tpc.copy_in(x, group)
        out = None
        for e, expert in enumerate(self.experts):
            if e not in own:
                expert.skip(x, generator, seq)
                continue
            y = we[..., e, None] * expert(xe, generator, seq)
            out = y if out is None else out + y
        if self.expert_split is not None:
            out = tpc.reduce_out(out, self.expert_split[0])
        return out


def feed_forward_module(cfg: EncoderConfig, activation=None) -> nn.Module:
    """The encoder layers' FFN: `MoEFeedForward` when
    positionwise_layer_type is 'moe', else `FeedForward`; its activation
    is the config's unless `activation` names another (the transformer
    block's relu)."""
    act = activation or cfg.activation_type
    if cfg.positionwise_layer_type == 'moe':
        return MoEFeedForward(cfg.output_size, cfg.linear_units, act,
                              cfg.dropout_rate, cfg.n_expert,
                              cfg.n_expert_per_token)
    return FeedForward(cfg.output_size, cfg.linear_units, act,
                       cfg.dropout_rate)


class ConvolutionModule(nn.Module):
    """pw(2C) → GLU → depthwise(k) → norm → swish → pw, in (B,T,C).  The
    norm is BatchNorm from running statistics or, with
    cnn_module_norm='layer_norm', a LayerNorm (kernel K5).  A causal module
    pads k−1 frames on the left, or takes them from `cnn_cache` (B, C, k−1),
    and returns the last k−1 frames of its input as the next cache.

    Under 'seq' (`seq`, a TimeSplit) x is this rank's time block: after the
    GLU its frames past the axis are zeroed (the unsplit conv pads zeros
    there) and the depthwise conv reads (k−1)/2 frames of each
    neighbour's block (k−1 of the previous one's when causal; rank 0's
    are the pointwise conv of zero frames, as the unsplit left pad)."""

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

    def forward(self, x, mask_pad, cnn_cache=None, seq=None):
        """x (B, T, C); mask_pad (B, 1, T) or None.  Returns (out, the new
        cache (B, C, k−1), or None when the module is not causal)."""
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if mask_pad is not None:
            keep = mask_pad.transpose(1, 2)               # (B, T, 1)
            x = torch.where(keep, x, zero)
        new_cache = None
        if self.lorder and seq is None:
            if cnn_cache is None:
                x = torch.nn.functional.pad(x, (0, 0, self.lorder, 0))
            else:
                x = torch.cat([cnn_cache.transpose(1, 2).to(x.dtype), x], 1)
            new_cache = x[:, -self.lorder:].transpose(1, 2)
        x = glu(self.pointwise_conv1.pointwise(x), dim=-1)
        if seq is None:
            x = self.depthwise_conv.depthwise(x, self.pad)
        else:
            x = self.depthwise_conv.depthwise(self._halo(x, seq), 0)
        x = self.act(self.norm(x))
        x = self.pointwise_conv2.pointwise(x)
        if mask_pad is not None:
            x = torch.where(keep, x, zero)
        return x, new_cache

    def _halo(self, x, seq):
        """A 'seq' rank's GLU output with its frames past the axis zeroed
        and the depthwise conv's halo put around it."""
        x = torch.where(seq.valid(x.device)[None, :, None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        if not self.lorder:
            return seq.halo(x, self.pad, self.pad)
        x = seq.halo(x, self.lorder, 0)
        if seq.rank == 0:
            edge = glu(self.pointwise_conv1.pointwise(x.new_zeros(
                (x.shape[0], self.lorder,
                 self.pointwise_conv1.weight.shape[1]))), dim=-1)
            x = torch.cat([edge, x[:, self.lorder:]], 1)
        return x


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
        self.rel = cfg.selfattention_layer_type == 'rel_selfattn'
        self.self_attn = (RelPositionMultiHeadedAttention if self.rel
                          else MultiHeadedAttention)(
            cfg.attention_heads, d, cfg.key_bias)
        self.feed_forward = feed_forward_module(cfg)
        self.norm_ff = LayerNorm(d)
        self.norm_mha = LayerNorm(d)
        if cfg.macaron_style:
            self.feed_forward_macaron = feed_forward_module(cfg)
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
                generator=None, mask=None, seq=None):
        """reverb_tpu/models/encoder.py:conformer_layer, its dropout sites
        included (active when a generator is given).  Attention sees the
        first kv_lens[b] keys of row b (kernel K1), or, when `mask` (B, T,
        T) is given, the keys that mask keeps.  Under 'seq' (`seq`, a
        TimeSplit; the K1 route) x and mask_pad are this rank's time
        block, kv_lens and pos_emb the whole axis's."""
        return self.forward_chunk(x, kv_lens, pos_emb, mask_pad, cat_embs,
                                  generator, mask, seq=seq)[0]

    def forward_chunk(self, x, kv_lens, pos_emb, mask_pad, cat_embs=None,
                      generator=None, mask=None, att_cache=None,
                      cnn_cache=None, seq=None):
        """`forward` with the streaming caches: att_cache (B, H, Tc, 2·dk)
        is put before this chunk's keys and values, cnn_cache (B, C, k−1)
        before its conv input.  Returns (x, new_att_cache (B, H, Tc+T,
        2·dk) or None, new_cnn_cache or None)."""
        split = None if seq is None else seq.entry(1)

        def drop(v):
            return dropout(v, self.rate, generator, split)

        if self.macaron:
            x = x + 0.5 * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), generator, seq))
        xn = self.norm_mha(x)
        new_att = None
        if not self.rel:
            x_att, new_att = self.self_attn.forward_cached(
                xn, key_mask(kv_lens, xn, mask), att_cache, self.att_rate,
                generator)
        elif mask is None and att_cache is None:
            x_att = self.self_attn(xn, kv_lens, pos_emb, self.att_rate,
                                   generator, seq=seq)
        else:
            x_att, new_att = self.self_attn.forward_masked(
                xn, mask, pos_emb, att_cache, self.att_rate, generator)
        x = x + drop(x_att)
        new_cnn = None
        if self.conv_module is not None:
            xc, new_cnn = self.conv_module(self.norm_conv(x), mask_pad,
                                           cnn_cache, seq)
            x = x + drop(xc)
        ff_scale = 0.5 if self.macaron else 1.0
        xn = self.norm_ff(x)
        if self.is_lsl:
            if cat_embs is None:
                raise ValueError('an LSL layer requires cat_embs')
            y = lsl_mix(self.language_layers, xn, cat_embs)
            x = x + ff_scale * drop(self.feed_forward(y, generator, seq))
            if self.conv_module is not None:
                x = self.norm_final(x)
            return x + y, new_att, new_cnn
        x = x + ff_scale * drop(self.feed_forward(xn, generator, seq))
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x, new_att, new_cnn


def count_seq_step(encoder, split: bool):
    """Count a training forward of an encoder under 'seq' (its
    `seq_split` set by parallel/sharding.py) in its `seq_steps`: split
    over the group, or whole on every rank of it (JAX's numbers without
    the memory saving)."""
    if encoder.seq_split is not None and torch.is_grad_enabled():
        encoder.seq_steps['split' if split else 'whole'] += 1


def key_mask(kv_lens, x, mask=None):
    """`mask` when given, else the key-length mask (B, 1, T) of kv_lens."""
    if mask is not None:
        return mask
    return (torch.arange(x.shape[1], device=x.device)[None, :]
            < kv_lens[:, None])[:, None, :]


class TransformerEncoderLayer(nn.Module):
    """The plain transformer block (reverb_tpu/models/encoder.py:
    transformer_layer): x + MHA(norm1(x)), then x + FFN(norm2(x)) with a
    relu FFN whatever the config's activation; dropout at its sites with
    a generator.  Attention is the masked route (plain MHA)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.output_size
        self.rate = cfg.dropout_rate
        self.att_rate = cfg.attention_dropout_rate
        self.self_attn = MultiHeadedAttention(cfg.attention_heads, d,
                                              cfg.key_bias)
        self.feed_forward = feed_forward_module(cfg, 'relu')
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)

    def forward(self, x, kv_lens, pos_emb, mask_pad, cat_embs=None,
                generator=None, mask=None):
        return self.forward_chunk(x, kv_lens, pos_emb, mask_pad, cat_embs,
                                  generator, mask)[0]

    def forward_chunk(self, x, kv_lens, pos_emb, mask_pad, cat_embs=None,
                      generator=None, mask=None, att_cache=None,
                      cnn_cache=None):
        """As ConformerEncoderLayer.forward_chunk (no 'seq' split); pos_emb, mask_pad,
        cat_embs and cnn_cache are unused.  Returns (x, new_att_cache,
        None)."""
        x_att, new_att = self.self_attn.forward_cached(
            self.norm1(x), key_mask(kv_lens, x, mask), att_cache,
            self.att_rate, generator)
        x = x + dropout(x_att, self.rate, generator)
        x = x + dropout(self.feed_forward(self.norm2(x), generator),
                        self.rate, generator)
        return x, new_att, None


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
    """The encoder of an asr_model: conformer or transformer blocks
    (`encoder_type`) over the configured input layer.

    Parallel forms (set by parallel/sharding.py):
    - 'seq' (`seq_split` = (group, rank, n)): a training forward whose
      input frames divide by n (JAX's `constrain` drops its hint
      otherwise) runs each layer on this rank's block of the subsampled
      frames (parallel/collectives.py:TimeSplit) and gathers the output
      before the losses, which run whole on every rank.  The split needs
      the K1 route (rel-pos self-attention of a conformer over the conv2d
      input, no chunk mask) and blocks at least as long as the conv
      module's halo; other forwards run whole.  `seq_steps` counts the
      forwards that ran split and whole.
    - 'pipe' (`pipe`, a parallel/pipeline.py:PipeStage): `pipe_region`'s
      layers run as GPipe stages when the batch divides into the
      microbatches, else in order (the stage's layers gathered first,
      parallel/sharding.py:gather_params).  With 'seq' too, each stage
      runs its layers on the rank's time block of each microbatch (the
      stages of one 'seq' coordinate pass those blocks on), and with
      'expert' its MoE layers split their experts over the stage's
      'expert' group."""

    def __init__(self, cfg: EncoderConfig, with_cmvn: bool = False):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        self.seq_split = None
        self.pipe = None
        self.seq_steps = {'split': 0, 'whole': 0}
        # True where the caller runs the layers one by one (the SSL
        # objectives' ssl_encoder_blocks, as in the JAX package): no
        # GPipe region then
        self.whole_stack = False
        self.global_cmvn = GlobalCMVN(cfg.input_size) if with_cmvn else None
        self.embed = input_layer(cfg)
        if cfg.encoder_type == 'transformer':
            layers = (TransformerEncoderLayer(cfg)
                      for _ in range(cfg.num_blocks))
        else:
            layers = (ConformerEncoderLayer(cfg, cfg.num_langs > 0 and
                                            i in (0, cfg.num_blocks - 1))
                      for i in range(cfg.num_blocks))
        self.encoders = nn.ModuleList(layers)
        self.after_norm = LayerNorm(cfg.output_size)

    def _final(self, xs):
        """after_norm, which normalize_before False leaves out."""
        return self.after_norm(xs) if self.cfg.normalize_before else xs

    def pipe_region(self, stages: int):
        """(lo, hi): the encoder layers that run as `stages` GPipe stages
        (reverb_tpu/models/encoder.py:encoder_forward): the longest run of
        the homogeneous (non-LSL) middle stack whose length is a multiple
        of `stages`; None when the config asks for no pipeline of that
        many stages, the run is shorter, or the caller runs the layers
        (`whole_stack`)."""
        cfg = self.cfg
        if cfg.pipeline_stages <= 1 or cfg.pipeline_stages != stages or \
                self.whole_stack:
            return None
        lo = 1 if cfg.num_langs > 0 else 0
        hi = cfg.num_blocks - 1 if cfg.num_langs > 0 else cfg.num_blocks
        n = ((hi - lo) // stages) * stages
        return (lo, lo + n) if n >= stages else None

    def pipe_engages(self, rows: int) -> bool:
        """Whether a batch of `rows` runs the GPipe region."""
        return self.pipe is not None and \
            rows % self.cfg.pipeline_microbatches == 0

    def _time_split(self, T: int, chunked: bool, return_layers: bool):
        """The TimeSplit of this forward's subsampled frames, or None
        when it runs whole (counted in `seq_steps` in training)."""
        if self.seq_split is None:
            return None
        cfg = self.cfg
        group, rank, n = self.seq_split
        length = subsampled_len(cfg, T)
        block = -(-length // n)
        halo = (cfg.cnn_module_kernel - 1 if cfg.causal
                else (cfg.cnn_module_kernel - 1) // 2) \
            if cfg.use_cnn_module else 0
        ok = (T % n == 0 and cfg.input_layer == 'conv2d'
              and cfg.pos_enc_layer_type == 'rel_pos'
              and cfg.encoder_type == 'conformer'
              and cfg.selfattention_layer_type == 'rel_selfattn'
              and not chunked and not return_layers
              and block >= max(halo, 1))
        count_seq_step(self, ok)
        return tpc.TimeSplit(group, rank, n, length) if ok else None

    def _run_region(self, xs, lo, hi, kv_lens, pos_emb, mask_pad,
                    generator, chunk_masks, seq=None):
        """Layers [lo, hi) as GPipe stages over 'pipe'
        (parallel/pipeline.py:gpipe).  With a generator one seed is drawn
        for each region layer on every stage (so the main stream stays one
        for the layers and the decoder after), and a layer's dropout on
        microbatch m draws from a generator seeded by (its seed, m), as
        JAX folds the microbatch index into each layer's key; a stage's
        recomputation (gradient_checkpointing) draws the same masks.
        Under 'seq' (`seq`) xs and mask_pad are the rank's time blocks,
        and each layer's dropout the rank's block of the unsplit mask of
        its microbatch."""
        from reverb_tpu_torch.parallel.pipeline import gpipe, mb_generator
        st = self.pipe
        per = (hi - lo) // st.size
        first = lo + st.rank * per
        layers = list(self.encoders[first:first + per])
        seeds = None
        if generator is not None:
            seeds = torch.randint(0, 2 ** 62, (hi - lo,),
                                  generator=generator,
                                  device=generator.device).tolist()
            seeds = seeds[first - lo:first - lo + per]
        split = () if seq is None else (seq,)

        def stage_fn(h, m, kv, mp, cm):
            for j, layer in enumerate(layers):
                g = None if seeds is None else mb_generator(
                    seeds[j], m, h.device)
                h = layer(h, kv, pos_emb, mp, None, g, cm, *split)
            return h
        return gpipe(stage_fn, xs, st, (kv_lens, mask_pad, chunk_masks),
                     self.cfg.gradient_checkpointing,
                     [p for layer in layers for p in layer.parameters()])

    def forward(self, xs, xs_lens, cat_embs=None, generator=None,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_generator=None,
                return_layers: bool = False, apply_cmvn: bool = True,
                chunk_mask: bool = True, enable_full_context: bool = True):
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
        final norm (the context adaptor's input).  `apply_cmvn` False skips
        the global CMVN (features normalised by the caller, as the SSL
        objectives do); `chunk_mask` False leaves every chunk mask out (the
        CTL model's full view); `enable_full_context` False keeps a drawn
        dynamic chunk from taking the whole context (its chunk view)."""
        cfg = self.cfg
        T = xs.shape[1]
        masks = (torch.arange(T, device=xs.device)[None, :]
                 < xs_lens.to(xs.device)[:, None])[:, None, :]
        if self.global_cmvn is not None and apply_cmvn:
            xs = self.global_cmvn(xs)
        # a use_dynamic_chunk model decoding with decoding_chunk_size < 0
        # gets masks & ones(T, T): every row keeps the same first kv_lens
        # keys, which is the key-length mask K1 takes — the same function,
        # so K1 computes it
        chunked = chunk_mask and (
            (cfg.use_dynamic_chunk and decoding_chunk_size >= 0)
            or (not cfg.use_dynamic_chunk and cfg.static_chunk_size > 0))
        seq = self._time_split(T, chunked, return_layers)
        if seq is None:
            xs, pos_emb, masks = self.embed(xs, masks, generator)
        else:
            xs, pos_emb, masks = self.embed(xs, masks, generator, seq)
        kv_lens = masks[:, 0, :].sum(-1).to(torch.int32)
        chunk_masks = None
        if chunked:
            chunk_masks = add_optional_chunk_mask(
                masks, cfg.use_dynamic_chunk, cfg.use_dynamic_left_chunk,
                decoding_chunk_size, cfg.static_chunk_size,
                num_decoding_left_chunks,
                generator if chunk_generator is None else chunk_generator,
                enable_full_context)
        layer_outs = []
        remat = (cfg.gradient_checkpointing and generator is not None
                 and torch.is_grad_enabled())
        region = None
        if not return_layers and self.pipe_engages(xs.shape[0]):
            region = self.pipe_region(self.pipe.size)
        mask_pad = masks if seq is None else seq.take(masks, 2)
        for i, layer in enumerate(self.encoders):
            if region is not None and region[0] <= i < region[1]:
                if i == region[0]:
                    xs = self._run_region(xs, *region, kv_lens, pos_emb,
                                          mask_pad, generator, chunk_masks,
                                          seq)
                continue
            args = (xs, kv_lens, pos_emb, mask_pad, cat_embs, generator,
                    chunk_masks) + (() if seq is None else (seq,))
            xs = (checkpoint_layer(layer, cfg.remat_policy, generator, *args)
                  if remat else layer(*args))
            layer_outs.append(xs)
        if return_layers:
            return self._final(xs), masks, layer_outs
        xs = self._final(xs)
        if seq is not None:
            xs = seq.gather(xs)[:, :seq.length]
        return xs, masks

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
        xs = self._final(xs)
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
