"""Alternative encoder families: Branchformer, E-Branchformer, Squeezeformer
and the Efficient Conformer with grouped rel-pos attention.

Counterpart of reverb_tpu/models/encoders_alt.py (`init_cgmlp` /
`cgmlp_forward`, `BranchformerConfig`, `branchformer_layer_forward`,
`branchformer_forward`, `SqueezeformerConfig`, `_rel_shift`,
`_sq_attention`, `_sq_ffn`, `_sq_conv`, `squeezeformer_layer_forward`,
`squeezeformer_forward`, `grouped_rel_pos_mha`,
`EfficientConformerConfig`, `_efficient_layer`,
`efficient_conformer_forward`), with the JAX tree's parameter names
(`attn`, `cgmlp.csgu.conv`, `depthwise_conv_fusion`, `ada_scale`, ...;
a conv module's parameters sit in `conv_module`, which convert.py
flattens into the layer as for the conformer).

Attention: where the JAX package calls `rel_pos_mha` — the Branchformer
layers and the Efficient Conformer's ungrouped layers — the port calls
`RelPositionMultiHeadedAttention.forward`, kernel K1 forward and K4
backward on the card, as the conformer's.  A Branchformer whose
pos_enc_layer_type is not rel_pos takes that encoding after its
subsampling and plain MHA over the key-padding mask, as JAX's `att.mha`.  The Efficient Conformer
passes a (B, T, T) mask `valid ∧ validᵀ`, which the JAX package takes
through XLA; its rows of valid queries keep the key-length mask K1
takes, and its padded query rows get a zero context (`q_valid`), so K1
computes the same function.  Squeezeformer's attention (with
`_rel_shift`) and the grouped attention are plain torch, as they are
XLA in JAX.  Every LayerNorm is the port's, K5/K6 where eligible.

Dropout: with a generator, at the JAX package's sites and rates
(positional dropout 0.1 after the conv2d subsampling of Branchformer and
the Efficient Conformer, as their EncoderConfig's default).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.models import embedding as emb
from reverb_tpu_torch.models.attention import (MultiHeadedAttention,
                                               RelPositionMultiHeadedAttention,
                                               _masked_softmax_av,
                                               _merge_heads, _split_heads)
from reverb_tpu_torch.models.encoder import (ConformerEncoderLayer,
                                             Conv2dSubsampling4,
                                             ConvolutionModule, EncoderConfig,
                                             FeedForward, count_seq_step)
from reverb_tpu_torch.models.modules import (ACTIVATIONS, BatchNorm, Conv1d,
                                             Conv2d, LayerNorm, Linear,
                                             dropout, glu, swish)
from reverb_tpu_torch.parallel import collectives as tpc


def _key_mask(xs, xs_lens):
    T = xs.shape[1]
    return (torch.arange(T, device=xs.device)[None, :]
            < xs_lens.to(xs.device)[:, None])[:, None, :]      # (B, 1, T)


class _AltEncoder(nn.Module):
    """The global CMVN stats of an alternative-encoder model: a constant
    of the JAX package's loss closure (reverb_tpu/models/registry.py:
    _alt_encoder_bundle), so non-persistent buffers here (no state-dict
    entry), set after construction by `set_cmvn`.  Under 'seq'
    (`seq_split`, parallel/sharding.py) the Branchformers split their time
    axis; the Squeezeformer and the Efficient Conformer, whose layers
    change the frame rate, run whole on every rank (`seq_steps` counts
    both)."""

    def __init__(self):
        super().__init__()
        self.seq_split = None
        self.seq_steps = {'split': 0, 'whole': 0}

    def set_cmvn(self, mean, istd):
        dev = next(self.parameters()).device
        self.register_buffer('cmvn_mean', torch.as_tensor(
            mean, dtype=torch.float32, device=dev), persistent=False)
        self.register_buffer('cmvn_istd', torch.as_tensor(
            istd, dtype=torch.float32, device=dev), persistent=False)

    def _cmvn(self, xs):
        if getattr(self, 'cmvn_mean', None) is None:
            return xs
        return (xs - self.cmvn_mean) * self.cmvn_istd


# ------------------------------ cgMLP ------------------------------

class ConvolutionalGatingMLP(nn.Module):
    """proj → GELU → spatial gating (LayerNorm and depthwise conv on half the
    channels, times the other half) → proj (branchformer/cgmlp.py).  When
    causal, the gate half is padded k−1 frames on the left BEFORE its
    LayerNorm (the padded frames enter the conv as β, not 0)."""

    def __init__(self, size: int, linear_units: int, kernel: int,
                 causal: bool, rate: float):
        super().__init__()
        h = linear_units // 2
        self.kernel, self.causal, self.rate = kernel, causal, rate
        self.channel_proj1 = nn.ModuleDict({'0': Linear(size, linear_units)})
        self.csgu = nn.ModuleDict({'norm': LayerNorm(h),
                                   'conv': Conv1d(h, h, kernel, groups=h)})
        self.channel_proj2 = Linear(h, size)

    def forward(self, x, generator=None, seq=None):
        """x (B, T, D); under 'seq' (`seq`, a TimeSplit) this rank's time
        block, the gate's conv reading its halo (`_gate_halo`) and the
        dropout taking the block of the unsplit mask."""
        x = F.gelu(self.channel_proj1['0'](x))
        xr, xg = x.chunk(2, -1)
        k = self.kernel
        conv = self.csgu['conv']
        if seq is not None:
            xg = conv.depthwise(self._gate_halo(self.csgu['norm'](xg), seq),
                                0)
        elif self.causal:
            xg = self.csgu['norm'](F.pad(xg, (0, 0, k - 1, 0)))
            xg = conv.depthwise(xg, 0)
        else:
            xg = conv.depthwise(self.csgu['norm'](xg), (k - 1) // 2)
        return self.channel_proj2(dropout(
            xr * xg, self.rate, generator,
            None if seq is None else seq.entry(1)))

    def _gate_halo(self, xg, seq):
        """A 'seq' rank's normalised gate with its frames past the axis
        zeroed (the unsplit conv pads zeros there) and the conv's halo
        around it: k−1 frames of the previous block when causal, rank 0's
        being the LayerNorm of zero frames, which is its bias (the
        unsplit left pad enters the norm; no K5 launch for it), else
        (k−1)/2 of each neighbour's."""
        k = self.kernel
        xg = torch.where(seq.valid(xg.device)[None, :, None], xg,
                         torch.zeros((), dtype=xg.dtype, device=xg.device))
        if not self.causal:
            return seq.halo(xg, (k - 1) // 2, (k - 1) // 2)
        xg = seq.halo(xg, k - 1, 0)
        if seq.rank == 0:
            edge = self.csgu['norm'].bias.to(xg.dtype).expand(
                xg.shape[0], k - 1, xg.shape[2])
            xg = torch.cat([edge, xg[:, k - 1:]], 1)
        return xg


# ------------------------------ branchformer ------------------------------

@dataclasses.dataclass(frozen=True)
class BranchformerConfig:
    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    num_blocks: int = 12
    cgmlp_linear_units: int = 2048
    cgmlp_conv_kernel: int = 31
    dropout_rate: float = 0.1
    merge_method: str = 'concat'          # concat | learned_ave | fixed_ave
    cgmlp_weight: float = 0.5             # fixed_ave branch weight
    causal: bool = False                  # csgu / fusion conv causality
    e_branchformer: bool = False          # adds macaron FFNs + conv merge
    ffn_units: int = 2048
    merge_conv_kernel: int = 3
    pos_enc_layer_type: str = 'rel_pos'


class BranchformerLayer(nn.Module):
    """Parallel attention and cgMLP branches, merged by concat + linear
    (or an attention-pooled / fixed average); the E-Branchformer adds the
    macaron FFN halves and a depthwise-conv merge.  norm_final on every
    layer."""

    def __init__(self, cfg: BranchformerConfig):
        super().__init__()
        d = cfg.output_size
        self.cfg = cfg
        self.norm_mha = LayerNorm(d)
        self.norm_mlp = LayerNorm(d)
        self.norm_final = LayerNorm(d)
        self.rel = cfg.pos_enc_layer_type == 'rel_pos'
        self.attn = (RelPositionMultiHeadedAttention if self.rel
                     else MultiHeadedAttention)(cfg.attention_heads, d, True)
        # the plain Branchformer never hands its `causal` to the cgMLP
        # (branchformer/encoder.py:83-90): its CSGU is causal
        self.cgmlp = ConvolutionalGatingMLP(
            d, cfg.cgmlp_linear_units, cfg.cgmlp_conv_kernel,
            cfg.causal if cfg.e_branchformer else True, cfg.dropout_rate)
        if cfg.e_branchformer:
            self.feed_forward = FeedForward(d, cfg.ffn_units, 'swish',
                                            cfg.dropout_rate)
            self.feed_forward_macaron = FeedForward(d, cfg.ffn_units,
                                                    'swish', cfg.dropout_rate)
            self.norm_ff = LayerNorm(d)
            self.norm_ff_macaron = LayerNorm(d)
            self.depthwise_conv_fusion = Conv1d(2 * d, 2 * d,
                                                cfg.merge_conv_kernel,
                                                groups=2 * d)
            self.merge_proj = Linear(2 * d, d)
        else:
            self.merge_proj = Linear(
                2 * d if cfg.merge_method == 'concat' else d, d)
            self.pooling_proj1 = Linear(d, 1)
            self.pooling_proj2 = Linear(d, 1)
            self.weight_proj1 = Linear(d, 1)
            self.weight_proj2 = Linear(d, 1)

    def forward(self, x, kv_lens, pos_emb, mask_pad, generator=None,
                seq=None):
        """Under 'seq' (`seq`, a TimeSplit; rel-pos attention, a concat or
        fixed average merge) x is this rank's time block: the attention
        keeps its queries and gathers the keys and values (K1 with Tq the
        block), the convs read halos, and each dropout takes its block of
        the unsplit mask."""
        cfg = self.cfg
        split = None if seq is None else seq.entry(1)

        def drop(v):
            return dropout(v, cfg.dropout_rate, generator, split)

        if cfg.e_branchformer:
            x = x + 0.5 * drop(self.feed_forward_macaron(
                self.norm_ff_macaron(x), generator, seq))
        xn = self.norm_mha(x)
        x1 = drop(self.attn(xn, kv_lens, pos_emb, seq=seq) if self.rel
                  else self.attn(xn, xn, xn, mask_pad))
        x2 = drop(self.cgmlp(self.norm_mlp(x), generator, seq))
        if cfg.e_branchformer:
            cat = torch.cat([x1, x2], -1)
            x = x + drop(self.merge_proj(cat + self._fusion(cat, seq)))
            x = x + 0.5 * drop(self.feed_forward(self.norm_ff(x), generator,
                                                 seq))
            return self.norm_final(x)
        if cfg.merge_method == 'concat':
            merged = self.merge_proj(torch.cat([x1, x2], -1))
        elif cfg.merge_method == 'learned_ave':
            # attention-pooled branch weights
            D = x.shape[-1]
            valid = mask_pad[:, 0, :, None]

            def pooled_weight(branch, pool, wproj):
                score = pool(branch) / D ** 0.5                  # (B, T, 1)
                score = score.masked_fill(~valid, float('-inf'))
                pooled = (torch.softmax(score, 1) * branch).sum(1)
                return wproj(pooled)                             # (B, 1)

            w = torch.softmax(torch.cat([
                pooled_weight(x1, self.pooling_proj1, self.weight_proj1),
                pooled_weight(x2, self.pooling_proj2, self.weight_proj2)],
                -1), -1)
            merged = self.merge_proj(w[:, 0:1, None] * x1
                                     + w[:, 1:2, None] * x2)
        elif cfg.merge_method == 'fixed_ave':
            merged = self.merge_proj((1.0 - cfg.cgmlp_weight) * x1
                                     + cfg.cgmlp_weight * x2)
        else:
            raise ValueError(cfg.merge_method)
        return self.norm_final(x + drop(merged))

    def _fusion(self, cat, seq):
        """E-Branchformer's depthwise conv over the concatenated branches
        (zero padded; under 'seq' the frames past the axis zeroed and the
        neighbours' frames read as a halo)."""
        k = self.cfg.merge_conv_kernel
        conv = self.depthwise_conv_fusion
        if seq is None:
            return (conv.depthwise(F.pad(cat, (0, 0, k - 1, 0)), 0)
                    if self.cfg.causal else conv.depthwise(cat, (k - 1) // 2))
        left, right = (k - 1, 0) if self.cfg.causal else ((k - 1) // 2,) * 2
        cat = torch.where(seq.valid(cat.device)[None, :, None], cat,
                          torch.zeros((), dtype=cat.dtype,
                                      device=cat.device))
        return conv.depthwise(seq.halo(cat, left, right), 0)


class BranchformerEncoder(_AltEncoder):
    """conv2d subsampling → Branchformer / E-Branchformer layers →
    after_norm."""

    def __init__(self, cfg: BranchformerConfig):
        super().__init__()
        if cfg.pos_enc_layer_type not in emb.POS_ENC_TYPES:
            raise ValueError(f'branchformer pos_enc_layer_type='
                             f'{cfg.pos_enc_layer_type!r} is not one of '
                             f'{emb.POS_ENC_TYPES}')
        self.cfg = cfg
        self.embed = Conv2dSubsampling4(cfg.input_size, cfg.output_size, 0.1,
                                        cfg.pos_enc_layer_type)
        self.encoders = nn.ModuleList(BranchformerLayer(cfg)
                                      for _ in range(cfg.num_blocks))
        self.after_norm = LayerNorm(cfg.output_size)

    def _time_split(self, T: int):
        """The TimeSplit of a forward of T input frames under 'seq', or
        None when it runs whole: the split needs the frames to divide by
        the group (JAX's `constrain`), rel-pos attention, a merge that
        does not pool over time, and blocks as long as the convs' halos."""
        if self.seq_split is None:
            return None
        cfg = self.cfg
        group, rank, n = self.seq_split
        length = ((T - 1) // 2 - 1) // 2
        csgu = cfg.causal if cfg.e_branchformer else True
        k = cfg.cgmlp_conv_kernel
        halo = max(k - 1 if csgu else (k - 1) // 2,
                   cfg.merge_conv_kernel - 1 if cfg.e_branchformer else 0)
        ok = (T % n == 0 and cfg.pos_enc_layer_type == 'rel_pos'
              and (cfg.e_branchformer or cfg.merge_method != 'learned_ave')
              and -(-length // n) >= max(halo, 1))
        count_seq_step(self, ok)
        return tpc.TimeSplit(group, rank, n, length) if ok else None

    def forward(self, xs, xs_lens, generator=None):
        """(B, T, F) → ((B, T', D), masks (B, 1, T')).  Under 'seq' the
        layers run on this rank's block of the subsampled frames and the
        output is gathered."""
        masks = _key_mask(xs, xs_lens)
        seq = self._time_split(xs.shape[1])
        xs, pos_emb, masks = self.embed(self._cmvn(xs), masks, generator,
                                        seq)
        kv_lens = masks[:, 0, :].sum(-1).to(torch.int32)
        for layer in self.encoders:
            xs = layer(xs, kv_lens, pos_emb, masks, generator, seq)
        xs = self.after_norm(xs)
        if seq is not None:
            xs = seq.gather(xs)[:, :seq.length]
        return xs, masks


# ------------------------------ squeezeformer ------------------------------

@dataclasses.dataclass(frozen=True)
class SqueezeformerConfig:
    """Squeezeformer (squeezeformer/encoder.py:35-200): depthwise-conv2d
    subsampling → preln → post-norm blocks [MHSA→LN, FFN1→LN, conv→LN,
    FFN2→LN] with adaptive input scales, a 2× time reduction at
    reduce_idx and repeat-2× + linear recovery at recover_idx; rel-pos
    attention WITH rel_shift."""
    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 1024
    num_blocks: int = 12
    reduce_idx: int = 5
    recover_idx: int = 11
    dropout_rate: float = 0.1
    cnn_module_kernel: int = 31
    time_reduction_kernel: int = 5
    adaptive_scale: bool = True
    do_rel_shift: bool = True
    activation: str = 'swish'


def _register_ada(module: nn.Module, d: int):
    module.ada_scale = nn.Parameter(torch.empty(1, 1, d))
    module.ada_bias = nn.Parameter(torch.empty(1, 1, d))


def _reset_ada(module: nn.Module):
    with torch.no_grad():
        module.ada_scale.fill_(1.0)
        module.ada_bias.zero_()


def _ada(module: nn.Module, x, adaptive: bool):
    if not adaptive:
        return x
    return module.ada_scale.to(x.dtype) * x + module.ada_bias.to(x.dtype)


def rel_shift(x):
    """Transformer-XL relative shift (squeezeformer/attention.py:73-97):
    zero-pad one column, fold, drop the first row."""
    B, H, T1, T2 = x.shape
    xp = torch.cat([x.new_zeros(B, H, T1, 1), x], -1).reshape(B, H, T2 + 1,
                                                                T1)
    return xp[:, :, 1:].reshape(B, H, T1, T2)


class SqueezeformerAttention(RelPositionMultiHeadedAttention):
    """Rel-pos attention with an adaptive input scale and rel_shift
    (squeezeformer/attention.py:146-232); plain matmuls and an f32 masked
    softmax."""

    def __init__(self, cfg: SqueezeformerConfig):
        super().__init__(cfg.attention_heads, cfg.output_size, True)
        self.adaptive = cfg.adaptive_scale
        self.do_rel_shift = cfg.do_rel_shift
        self.rate = cfg.dropout_rate
        _register_ada(self, cfg.output_size)

    def reset_parameters(self, g):
        super().reset_parameters(g)
        _reset_ada(self)

    def forward(self, x, mask, pos_emb, generator=None):
        """x (B, T, D); mask (B, T, T) bool; pos_emb (1, T, D)."""
        xa = _ada(self, x, self.adaptive)
        q = _split_heads(self.linear_q(xa), self.h)
        k = _split_heads(self.linear_k(xa), self.h)
        v = _split_heads(self.linear_v(xa), self.h)
        pe = _split_heads(self.linear_pos(pos_emb), self.h)
        u = self.pos_bias_u.to(x.dtype)[None, :, None, :]
        vb = self.pos_bias_v.to(x.dtype)[None, :, None, :]
        ac = torch.matmul(q + u, k.transpose(-1, -2))
        bd = torch.matmul(q + vb, pe.transpose(-1, -2))
        if self.do_rel_shift:
            bd = rel_shift(bd)
        scores = (ac + bd) / math.sqrt(q.shape[-1])
        ctx = _masked_softmax_av(scores, mask[:, None], v, self.rate,
                                 generator, self.tp_split)
        return self.linear_out(_merge_heads(ctx))


class SqueezeformerFFN(FeedForward):
    """FeedForward with an adaptive input scale."""

    def __init__(self, cfg: SqueezeformerConfig):
        super().__init__(cfg.output_size, cfg.linear_units, cfg.activation,
                         cfg.dropout_rate)
        self.adaptive = cfg.adaptive_scale
        _register_ada(self, cfg.output_size)

    def reset_parameters(self, g):
        _reset_ada(self)

    def forward(self, x, generator=None):
        return super().forward(_ada(self, x, self.adaptive), generator)


class SqueezeformerLayer(nn.Module):
    """Post-norm block (squeezeformer/encoder_layer.py:49-150); the conv
    module's adaptive scale is the layer's own `ada_scale`/`ada_bias`."""

    def __init__(self, cfg: SqueezeformerConfig):
        super().__init__()
        d = cfg.output_size
        self.cfg = cfg
        self.self_attn = SqueezeformerAttention(cfg)
        self.ffn1 = SqueezeformerFFN(cfg)
        self.ffn2 = SqueezeformerFFN(cfg)
        self.conv_module = ConvolutionModule(d, cfg.cnn_module_kernel,
                                             cfg.activation)
        for i in range(1, 5):
            setattr(self, f'layer_norm{i}', LayerNorm(d))
        _register_ada(self, d)

    def reset_parameters(self, g):
        _reset_ada(self)

    def forward(self, x, mask, pos_emb, mask_pad, generator=None):
        def drop(v):
            return dropout(v, self.cfg.dropout_rate, generator)

        x = self.layer_norm1(x + drop(self.self_attn(x, mask, pos_emb,
                                                     generator)))
        x = self.layer_norm2(x + drop(self.ffn1(x, generator)))
        xc, _ = self.conv_module(_ada(self, x, self.cfg.adaptive_scale),
                                 mask_pad)
        x = self.layer_norm3(x + drop(xc))
        return self.layer_norm4(x + drop(self.ffn2(x, generator)))


class SqueezeformerEncoder(_AltEncoder):
    """DepthwiseConv2dSubsampling4 (pw → relu → conv → relu → flatten, ×√d,
    the pos table, input_proj) → preln → the layers, the time reduced 2×
    before reduce_idx and recovered before recover_idx."""

    def __init__(self, cfg: SqueezeformerConfig):
        super().__init__()
        d, f = cfg.output_size, cfg.input_size
        self.cfg = cfg
        self.embed = nn.ModuleDict({
            'pw_conv': Conv2d(1, d, 3, 3, (2, 2)),
            'dw_conv': Conv2d(d, d, 3, 3, (2, 2)),
            'input_proj': nn.ModuleDict({'0': Linear(
                d * (((f - 1) // 2 - 1) // 2), d)})})
        self.preln = LayerNorm(d)
        self.time_reduction_layer = nn.ModuleDict({
            'dw_conv': Conv1d(d, d, cfg.time_reduction_kernel, groups=d),
            'pw_conv': Conv1d(d, d, 1)})
        self.time_recover_layer = Linear(d, d)
        self.encoders = nn.ModuleList(SqueezeformerLayer(cfg)
                                      for _ in range(cfg.num_blocks))

    def forward(self, xs, xs_lens, generator=None):
        cfg = self.cfg
        count_seq_step(self, False)
        masks = _key_mask(xs, xs_lens)
        x4 = torch.relu(self.embed['pw_conv'](self._cmvn(xs)[:, None]))
        x4 = torch.relu(self.embed['dw_conv'](x4))
        b, c, t, f = x4.shape
        xs = x4.transpose(1, 2).reshape(b, t, c * f)
        d = cfg.output_size
        # the pos table sits BEFORE input_proj, built at encoder_dim
        xs = xs * math.sqrt(d)
        pos_emb = emb.pe_table_on(d, xs.device)[None, :t].to(xs.dtype)
        xs = self.preln(self.embed['input_proj']['0'](xs))
        masks = masks[:, :, :-2:2][:, :, :-2:2]
        cur_pad = masks
        cur_att = masks & masks.transpose(1, 2)
        cur_pos = pos_emb[:, :xs.shape[1]]
        recover = None
        tr = self.time_reduction_layer
        for i, layer in enumerate(self.encoders):
            if i == cfg.reduce_idx:
                recover = (xs, cur_att, cur_pos, cur_pad)
                # TimeReductionLayer1D: mask → depthwise (stride 2, pad
                # k − 2) → pointwise → trim or pad to ceil(T/2)
                xm = xs * cur_pad[:, 0, :, None].to(xs.dtype)
                xr = tr['pw_conv'].pointwise(tr['dw_conv'].depthwise(
                    xm, max(0, cfg.time_reduction_kernel - 2), stride=2))
                cur_att = cur_att[:, ::2, ::2]
                cur_pad = cur_pad[:, :, ::2]
                L = cur_pad.shape[-1]
                xs = (xr[:, :L] if xr.shape[1] >= L
                      else F.pad(xr, (0, 0, 0, L - xr.shape[1])))
                cur_pos = cur_pos[:, ::2]
            if i == cfg.recover_idx and recover is not None:
                r_x, cur_att, cur_pos, cur_pad = recover
                up = self.time_recover_layer(
                    torch.repeat_interleave(xs, 2, dim=1))
                xs = (r_x + up[:, :r_x.shape[1]]) \
                    * cur_pad[:, 0, :, None].to(r_x.dtype)
            xs = layer(xs, cur_att, cur_pos, cur_pad, generator)
        return xs, masks


# -------------------- grouped attention (efficient conformer) -----------

class GroupedRelPositionMultiHeadedAttention(RelPositionMultiHeadedAttention):
    """q/k/v/pos grouped by concatenating `group_size` consecutive frames
    (d_k → d_k·g per head), the mask strided ::g, scores scaled by
    √(d_k·g), the context un-grouped and trimmed
    (efficient_conformer/attention.py:28-260); pos_bias_u/v are
    (h, d_k·g).  No rel_shift.  Plain matmuls and an f32 masked softmax.
    A grouped head reads g consecutive frames of every channel, not a
    block of channels, so under 'model' the layer runs whole on every
    rank (parallel/sharding.py:_whole_form)."""

    def __init__(self, n_head: int, n_feat: int, group_size: int):
        super().__init__(n_head, n_feat, True)
        dk = n_feat // n_head
        self.g = group_size
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, dk * group_size))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, dk * group_size))

    def forward_grouped(self, x, mask, pos_emb, rate: float = 0.0,
                        generator=None):
        """x (B, T, D); mask (B, T, T) bool; pos_emb (1, T, D)."""
        B, T, D = x.shape
        h, g = self.h, self.g
        q, k, v = self.linear_q(x), self.linear_k(x), self.linear_v(x)
        pe = self.linear_pos(pos_emb)
        pad_q = (-T) % g
        if pad_q:
            q, k, v = (F.pad(t, (0, 0, 0, pad_q)) for t in (q, k, v))
        pad_p = (-pe.shape[1]) % g
        if pad_p:
            pe = F.pad(pe, (0, 0, 0, pad_p))
        Tg = q.shape[1] // g

        def grp(t):
            return t.reshape(t.shape[0], -1, h, D // h * g).transpose(1, 2)

        qg, kg, vg, pg = grp(q), grp(k), grp(v), grp(pe)
        u = self.pos_bias_u.to(x.dtype)[None, :, None, :]
        vb = self.pos_bias_v.to(x.dtype)[None, :, None, :]
        ac = torch.matmul(qg + u, kg.transpose(-1, -2))
        bd = torch.matmul(qg + vb, pg[:, :, :kg.shape[2]].transpose(-1, -2))
        scores = (ac + bd) / math.sqrt(D // h * g)
        mm = mask[:, ::g, ::g][:, None, :, :scores.shape[-1]]
        ctx = _masked_softmax_av(scores, mm, vg, rate, generator)
        ctx = ctx.transpose(1, 2).reshape(B, Tg * g, D)[:, :T]
        return self.linear_out(ctx)


# -------------------- efficient conformer (full encoder) -----------------

@dataclasses.dataclass(frozen=True)
class EfficientConformerConfig:
    """EfficientConformerEncoder (efficient_conformer/encoder.py:41):
    conformer blocks with grouped rel-pos attention in group_layer_idx; at
    stride_layer_idx the conv module's depthwise conv is strided (kernel
    k//s after it when stride_kernel) and the residual is average-pooled
    (ceil mode); later layers run at the reduced rate."""
    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 12
    cnn_module_kernel: int = 15
    dropout_rate: float = 0.1
    group_size: int = 3
    group_layer_idx: tuple = (0, 1, 2, 3)
    stride_layer_idx: tuple = (3,)
    stride: tuple = (2,)
    stride_kernel: bool = True


def _eff_layer_kernel(cfg: EfficientConformerConfig, i: int) -> int:
    """The conv kernel of layer i: the stride layer itself keeps the
    kernel before it; the layers after it take k//s."""
    ks = [cfg.cnn_module_kernel]
    for s in cfg.stride:
        ks.append(ks[-1] // s if cfg.stride_kernel else ks[-1])
    return ks[sum(1 for j in cfg.stride_layer_idx if j < i)]


def avg_pool_ceil(x, s: int):
    """AvgPool1d(kernel=s, stride=s, ceil_mode=True,
    count_include_pad=False) over the time axis of (B, T, D)."""
    B, T, D = x.shape
    Tp = -(-T // s) * s
    xs = F.pad(x, (0, 0, 0, Tp - T)).reshape(B, Tp // s, s, D).sum(2)
    cnt = F.pad(torch.ones(T, dtype=x.dtype, device=x.device),
                (0, Tp - T)).reshape(Tp // s, s).sum(1)
    return xs / cnt[None, :, None]


class EfficientConformerLayer(ConformerEncoderLayer):
    """A conformer block (batch-norm conv module, swish, macaron) whose
    attention is grouped in group_layer_idx, and whose conv module, in a
    stride layer, downsamples with the residual average-pooled to match
    (efficient_conformer/encoder_layer.py:44-150).  Attention dropout at
    dropout_rate, as the JAX layer passes it."""

    def __init__(self, cfg: EfficientConformerConfig, i: int):
        super().__init__(EncoderConfig(
            input_size=cfg.input_size, output_size=cfg.output_size,
            attention_heads=cfg.attention_heads,
            linear_units=cfg.linear_units,
            cnn_module_kernel=_eff_layer_kernel(cfg, i),
            cnn_module_norm='batch_norm', dropout_rate=cfg.dropout_rate),
            False)
        self.grouped = i in cfg.group_layer_idx
        self.stride = (cfg.stride[list(cfg.stride_layer_idx).index(i)]
                       if i in cfg.stride_layer_idx else 1)
        self.kernel = _eff_layer_kernel(cfg, i)
        self.att_rate = cfg.dropout_rate
        if self.grouped:
            self.self_attn = GroupedRelPositionMultiHeadedAttention(
                cfg.attention_heads, cfg.output_size, cfg.group_size)

    def forward(self, x, kv_lens, pos_emb, mask_pad, att_mask,
                generator=None):
        def drop(v):
            return dropout(v, self.rate, generator)

        x = x + 0.5 * drop(self.feed_forward_macaron(
            self.norm_ff_macaron(x), generator))
        xn = self.norm_mha(x)
        if self.grouped:
            x_att = self.self_attn.forward_grouped(xn, att_mask, pos_emb,
                                                   self.att_rate, generator)
        else:
            x_att = self.self_attn(xn, kv_lens, pos_emb, self.att_rate,
                                   generator, q_valid=mask_pad[:, 0, :])
        x = x + drop(x_att)
        xn = self.norm_conv(x)
        cm = self.conv_module
        if self.stride > 1:
            s = self.stride
            xc = xn * mask_pad[:, 0, :, None].to(xn.dtype)
            xc = glu(cm.pointwise_conv1.pointwise(xc), dim=-1)
            xc = cm.depthwise_conv.depthwise(xc, (self.kernel - 1) // 2, s)
            xc = cm.pointwise_conv2.pointwise(swish(cm.norm(xc)))
            new_pad = mask_pad[:, :, ::s][:, :, :xc.shape[1]]
            xc = xc * new_pad[:, 0, :, None].to(xc.dtype)
            x = avg_pool_ceil(x, s)[:, :xc.shape[1]] + drop(xc)
        else:
            x = x + drop(cm(xn, mask_pad)[0])
        x = x + 0.5 * drop(self.feed_forward(self.norm_ff(x), generator))
        return self.norm_final(x)


class EfficientConformerEncoder(_AltEncoder):
    """conv2d subsampling → Efficient Conformer layers, the masks and the
    pos rows strided after each stride layer → after_norm."""

    def __init__(self, cfg: EfficientConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Conv2dSubsampling4(cfg.input_size, cfg.output_size, 0.1)
        self.encoders = nn.ModuleList(EfficientConformerLayer(cfg, i)
                                      for i in range(cfg.num_blocks))
        self.after_norm = LayerNorm(cfg.output_size)

    def forward(self, xs, xs_lens, generator=None):
        cfg = self.cfg
        count_seq_step(self, False)
        masks = _key_mask(xs, xs_lens)
        xs, pos_emb, masks = self.embed(self._cmvn(xs), masks, generator)
        att_mask = masks & masks.transpose(1, 2)
        stride_at = dict(zip(cfg.stride_layer_idx, cfg.stride))
        for i, layer in enumerate(self.encoders):
            kv_lens = masks[:, 0, :].sum(-1).to(torch.int32)
            xs = layer(xs, kv_lens, pos_emb, masks, att_mask, generator)
            if i in stride_at:
                s = stride_at[i]
                masks = masks[:, :, ::s]
                att_mask = att_mask[:, ::s, ::s]
                pos_emb = pos_emb[:, ::s]
        return self.after_norm(xs), masks


ALT_ENCODERS = {'branchformer': (BranchformerConfig, BranchformerEncoder),
                'e_branchformer': (BranchformerConfig, BranchformerEncoder),
                'squeezeformer': (SqueezeformerConfig, SqueezeformerEncoder),
                'efficient_conformer': (EfficientConformerConfig,
                                        EfficientConformerEncoder)}
