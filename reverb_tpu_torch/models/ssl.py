"""Self-supervised objectives: BEST-RQ, wav2vec 2.0 and w2v-BERT.

Counterpart of reverb_tpu/models/ssl.py:
  - BEST-RQ: a frozen random projection and codebook quantize stacked,
    normalised fbank windows (Euclidean nearest code); the encoder, fed
    the features with masked spans replaced by one Gaussian vector,
    predicts the code ids at the masked positions (`bestrq_loss`);
  - wav2vec 2.0: the subsampled features, masked spans replaced by the
    trained `mask_emb`, run the encoder blocks; InfoNCE of the context
    against the gumbel-softmax quantized unmasked features, with
    negatives from the masked positions of the same utterance
    (`wav2vec2_loss`);
  - w2v-BERT: one encoder pass, the contrastive branch tapped after
    `contrastive_blocks`, an MLM branch on the final output predicting the
    quantizer's ids (`w2vbert_loss`).

The encoder is the port's conformer (or transformer) stack, so its
attention runs kernel K1/K4 (pad mask only) and its LayerNorms K5/K6.
Every drawn quantity can be injected: BEST-RQ's `mask` and `noise`,
`span_mask`, `mask_noise`, `neg_pos` and `gumbels`; what is not injected is
drawn from the `torch.Generator` given (torch cannot reproduce
jax.random, so the parity tests feed both packages the same draws).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from reverb_tpu_torch.models.asr_model import ASRModel, ModelConfig
from reverb_tpu_torch.models.encoder import count_seq_step
from reverb_tpu_torch.models.modules import Linear
from reverb_tpu_torch.parallel import global_batch as gb


@dataclasses.dataclass(frozen=True)
class BestRQConfig:
    input_dim: int = 80
    encoder_output_size: int = 256
    num_codebooks: int = 1
    codebook_size: int = 8192
    codebook_dim: int = 16
    mask_prob: float = 0.01          # per-frame mask-start probability
    mask_length: int = 10
    stack_frames: int = 4            # quantizer window (right_context+1)
    stride: int = 4                  # encoder subsampling rate
    norm_epsilon: float = 1e-5
    features_regularization_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class Wav2vec2Config:
    encoder_output_size: int = 256
    num_codebooks: int = 1
    codebook_size: int = 320          # num_embeddings per codebook
    embedding_dim: int = 256          # total codevector dim (= G · per-group)
    mask_prob: float = 0.065
    mask_length: int = 10
    min_masks: int = 2
    num_negatives: int = 100
    features_regularization_weight: float = 0.01
    max_gumbel_temperature: float = 2.0
    min_gumbel_temperature: float = 0.1
    gumbel_temperature_decay: float = 0.999995
    contrastive_temperature: float = 0.1
    diversity_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    contrastive_blocks: int = 6
    masked_blocks: int = 6
    contrastive_weight: float = 1.0
    mlm_weight: float = 1.0
    warmup_steps: int = 25000
    bias: bool = True


# ------------------------------ the models ------------------------------

class BestRQModel(ASRModel):
    """The asr_model's parameters (the decoder and the CTC head take no
    part in the loss), the random quantizer (`projection`, `codebook`:
    standard normal, never used differentiably, so their gradient is
    zero, and they are leaves the optimizer updates as the JAX package's
    does) and the trained prediction `head`, the last three at the top
    level as in the JAX tree."""

    def __init__(self, cfg: ModelConfig, bcfg: BestRQConfig,
                 with_cmvn: bool = False):
        super().__init__(cfg, with_cmvn)
        self.bcfg = bcfg
        d_in = bcfg.input_dim * bcfg.stack_frames
        self.projection = nn.Parameter(torch.empty(
            d_in, bcfg.num_codebooks * bcfg.codebook_dim))
        self.codebook = nn.Parameter(torch.empty(
            bcfg.num_codebooks, bcfg.codebook_size, bcfg.codebook_dim))
        self.head = Linear(bcfg.encoder_output_size,
                           bcfg.num_codebooks * bcfg.codebook_size)

    def reset_parameters(self, g):
        with torch.no_grad():
            self.projection.normal_(generator=g)
            self.codebook.normal_(generator=g)


class Wav2vec2Model(ASRModel):
    """The asr_model's parameters, the gumbel quantizer (`vq_proj`,
    `vq_codebook` uniform [0, 1)) and, for wav2vec 2.0, the trained
    `mask_emb` (uniform [0, 1)); for w2v-BERT (`bcfg` given) instead the
    per-codebook MLM head `top_n_out` (G, D, C) at 0.02 · a normal
    truncated to ±2, and its zero bias."""

    def __init__(self, cfg: ModelConfig, wcfg: Wav2vec2Config,
                 bcfg: Optional[W2VBertConfig] = None,
                 with_cmvn: bool = False):
        super().__init__(cfg, with_cmvn)
        self.wcfg, self.bcfg = wcfg, bcfg
        # the losses run the encoder's layers themselves
        # (`ssl_encoder_blocks`): no GPipe region, whole under 'seq'
        self.encoder.whole_stack = True
        G, C = wcfg.num_codebooks, wcfg.codebook_size
        self.vq_proj = Linear(wcfg.encoder_output_size, G * C)
        self.vq_codebook = nn.Parameter(torch.empty(
            G, C, wcfg.embedding_dim // G))
        self.mask_emb = self.top_n_out = self.top_n_out_bias = None
        if bcfg is None:
            self.mask_emb = nn.Parameter(torch.empty(
                wcfg.encoder_output_size))
        else:
            self.top_n_out = nn.Parameter(torch.empty(
                G, wcfg.encoder_output_size, C))
            if bcfg.bias:
                self.top_n_out_bias = nn.Parameter(torch.empty(G, C))

    def reset_parameters(self, g):
        with torch.no_grad():
            self.vq_codebook.uniform_(generator=g)
            if self.mask_emb is not None:
                self.mask_emb.uniform_(generator=g)
            else:
                nn.init.trunc_normal_(self.top_n_out, 0.0, 1.0, -2.0, 2.0,
                                      generator=g)
                self.top_n_out.mul_(0.02)
                if self.top_n_out_bias is not None:
                    self.top_n_out_bias.zero_()


# ------------------------------ BEST-RQ ------------------------------

def _windows(T: int, size: int, step: int, device):
    Tp = max((T - size) // step + 1, 0)
    return (torch.arange(Tp, device=device)[:, None] * step
            + torch.arange(size, device=device)[None])       # (T', size)


def stack_features(feats, size: int, step: int):
    """Sliding windows of `size` frames every `step` (torch's
    `unfold(1, size, step)` layout: a window's frames contiguous, each
    frame's F features inside) → (B, T', size·F)."""
    B, T, F = feats.shape
    idx = _windows(T, size, step, feats.device)
    return feats[:, idx].reshape(B, idx.shape[0], size * F)


def subsampled_mask(mask, size: int, step: int):
    """A subsampled position is masked only when every frame of its window
    is (B, T')."""
    idx = _windows(mask.shape[1], size, step, mask.device)
    return mask[:, idx].all(-1)


def bestrq_targets(model: BestRQModel, feats, cfg: BestRQConfig):
    """(B, T', num_codebooks) code ids: the stacked windows normalised
    without affine (when stack_frames > 1), projected, and each codebook
    group's nearest code (argmin of ‖c‖² − 2·l·c; ties to the lower id)."""
    with torch.no_grad():
        x = stack_features(feats, cfg.stack_frames, cfg.stride)
        if cfg.stack_frames > 1:
            mu = x.mean(-1, keepdim=True)
            var = x.var(-1, unbiased=False, keepdim=True)
            x = (x - mu) * torch.rsqrt(var + cfg.norm_epsilon)
        proj = x @ model.projection
        B, Tp, _ = proj.shape
        proj = proj.reshape(B, Tp, cfg.num_codebooks, cfg.codebook_dim)
        cb = model.codebook
        dist = ((cb ** 2).sum(-1)[None, None]
                - 2.0 * torch.einsum('btgd,gcd->btgc', proj, cb))
        return dist.argmin(-1)


def make_mask(B: int, T: int, mask_prob: float, mask_length: int,
              generator, device):
    """Span masking: starts ~ Bernoulli(mask_prob) over (B, T), each
    masking itself and the mask_length − 1 frames after it."""
    starts = (torch.rand((B, T), generator=generator, device=device)
              < mask_prob).to(torch.int32)
    c = torch.cumsum(starts, 1)
    before = torch.cat([torch.zeros((B, mask_length), dtype=c.dtype,
                                    device=device), c], 1)[:, :T]
    return (c - before) > 0


def bestrq_ce(logits, targets, valid, num_codebooks: int):
    """Σ −log p[target] over the valid positions / ((Σ valid + 1e-5)·G);
    logits (B, T', G, C), targets (B, T', G), valid (B, T').  Returns
    (loss, log-probs)."""
    logp = torch.log_softmax(logits.to(torch.float32), -1)
    tok = torch.gather(logp, -1, targets[..., None].to(torch.int64))[..., 0]
    denom = (gb.total(valid.sum()) + 1e-5) * num_codebooks
    loss = -torch.where(valid[..., None], tok, torch.zeros_like(tok)).sum() \
        / denom
    return loss, logp


def bestrq_loss(model, feats, feats_lens, cfg: BestRQConfig, generator=None,
                mask=None, noise=None):
    """Mask → encode → predict the code ids at masked positions.

    `feats` are already CMVN-normalised and the encoder runs without its
    CMVN and without dropout (the reference applies the signal's CMVN
    itself; the JAX package's encoder call takes no rng).  Loss = masked
    CE + features_regularization_weight · mean(feats²).  `mask` (B, T) and
    `noise` (1, 1, F) replace the draws."""
    B, T, F = feats.shape
    targets = bestrq_targets(model, feats, cfg)
    if mask is None:
        mask = make_mask(B, T, cfg.mask_prob, cfg.mask_length, generator,
                         feats.device)
    if noise is None:
        noise = gb.draw(torch.randn((1, 1, F), generator=generator,
                                    device=feats.device) * 0.1)
    masked = torch.where(mask[..., None], noise.to(feats.dtype), feats)
    enc_out, enc_mask = model.encoder(
        masked.to(model.cfg.compute_dtype), feats_lens, None, None, -1,
        apply_cmvn=False)
    Tq = min(enc_out.shape[1], targets.shape[1])
    logits = model.head(enc_out[:, :Tq]).reshape(
        B, Tq, cfg.num_codebooks, cfg.codebook_size)
    tgt = targets[:, :Tq]
    m_sub = subsampled_mask(mask, cfg.stack_frames, cfg.stride)[:, :Tq]
    valid = enc_mask[:, 0, :Tq] & m_sub
    loss, logp = bestrq_ce(logits, tgt, valid, cfg.num_codebooks)
    if cfg.features_regularization_weight:
        loss = loss + (cfg.features_regularization_weight
                       * gb.mean(feats.to(torch.float32) ** 2))
    n_valid = valid.sum()
    num_codes = torch.clamp(gb.total(n_valid) * cfg.num_codebooks, min=1)
    hit = (logp.argmax(-1) == tgt) & valid[..., None]
    return {'loss': loss, 'code_accuracy': hit.sum() / num_codes,
            'num_masked': n_valid}


# the draws each loss takes in place of the generator's (models/registry.py
# passes those a batch carries)
BESTRQ_DRAWS = ('mask', 'noise')
WAV2VEC2_DRAWS = ('span_mask', 'neg_pos', 'gumbels')
W2VBERT_DRAWS = WAV2VEC2_DRAWS + ('mask_noise',)

# ------------------------------ wav2vec 2.0 ------------------------------

def ssl_subsample(model, feats, feats_lens):
    """The encoder's global CMVN and subsampling, no dropout →
    (xs (B, T', D), pos_emb, masks (B, 1, T'))."""
    enc = model.encoder
    T = feats.shape[1]
    masks = (torch.arange(T, device=feats.device)[None, :]
             < feats_lens.to(feats.device)[:, None])[:, None, :]
    xs = feats.to(model.cfg.compute_dtype)
    if enc.global_cmvn is not None:
        xs = enc.global_cmvn(xs)
    return enc.embed(xs, masks, None)


def ssl_encoder_blocks(model, xs, masks, pos_emb, split=None):
    """The encoder's blocks over a pad mask (no chunk mask, no dropout),
    then after_norm.  Returns (the output after `split` blocks, the final
    output); without a split both are the final output."""
    enc = model.encoder
    count_seq_step(enc, False)
    kv_lens = masks[:, 0, :].sum(-1).to(torch.int32)
    mid = None
    for i, layer in enumerate(enc.encoders):
        xs = layer(xs, kv_lens, pos_emb, masks)
        if split is not None and i == split - 1:
            mid = xs
    xs = enc._final(xs)
    return (xs if mid is None else mid), xs


def draw_gumbels(shape, generator, device):
    """−log(−log u), u uniform in [tiny, 1) (f32)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    u = tiny + (1.0 - tiny) * u
    return -torch.log(-torch.log(u))


def gumbel_quantize(model, x, valid_mask, temperature, cfg: Wav2vec2Config,
                    generator=None, gumbels=None):
    """The gumbel-softmax quantizer, soft (hard=False): x (B, T, D) the
    unmasked subsampled features, valid_mask (B, T).  Returns (codevectors
    (B, T, embedding_dim), perplexity of the valid frames' mean softmax,
    target ids (B, T, G))."""
    B, T, _ = x.shape
    G, C = cfg.num_codebooks, cfg.codebook_size
    logits = model.vq_proj(x).reshape(B, T, G, C).to(torch.float32)
    if gumbels is None:
        gumbels = draw_gumbels(logits.shape, generator, x.device)
    probs = torch.softmax((logits + gumbels) / temperature, -1)
    soft = torch.softmax(logits, -1)
    vm = valid_mask[..., None, None]
    marginal = (gb.shared(torch.where(vm, soft,
                                      torch.zeros_like(soft)).sum((0, 1)))
                / torch.clamp(gb.total(valid_mask.sum()), min=1))
    perplexity = torch.exp(-(marginal * torch.log(marginal + 1e-7)).sum(-1)
                           ).sum()
    targets = probs.argmax(-1)
    cv = torch.einsum('btgc,gcd->btgd', probs,
                      model.vq_codebook.to(probs.dtype))
    return cv.reshape(B, T, -1), perplexity, targets


def sample_negative_indices(span_mask, num_negatives: int, generator=None,
                            neg_pos=None):
    """(B, T, N) frame positions of each anchor's negatives, drawn from the
    masked positions of its utterance: an ordinal uniform in
    [0, n_masked − 1), shifted past the anchor's own ordinal, mapped to
    its frame.  Unmasked anchors get positions too (their terms are masked
    out)."""
    if neg_pos is not None:
        return neg_pos
    B, T = span_mask.shape
    dev = span_mask.device
    pos = torch.arange(T, device=dev)
    order = torch.argsort(torch.where(span_mask, pos, pos + T), dim=1)
    rank = torch.cumsum(span_mask.to(torch.int64), 1) - 1
    cnt = span_mask.sum(1)
    high = torch.clamp(cnt - 1, min=1)[:, None, None]
    u = torch.rand((B, T, num_negatives), generator=generator, device=dev)
    i = torch.clamp((u * high).to(torch.int64), max=high - 1)
    i = torch.where(i >= rank[..., None], i + 1, i)
    i = torch.minimum(i, torch.clamp(cnt, min=1)[:, None, None] - 1)
    return torch.gather(order, 1, i.reshape(B, -1)).reshape(
        B, T, num_negatives)


def _cosine_logits(context, targets, temperature):
    """torch.cosine_similarity's dot / max(|a|·|b|, 1e-8) of context
    (B, T, D) against targets (N+1, B, T, D), / temperature, in f32."""
    cf = context[None].to(torch.float32)
    tf = targets.to(torch.float32)
    num = (cf * tf).sum(-1)
    den = torch.clamp(torch.linalg.vector_norm(cf, dim=-1)
                      * torch.linalg.vector_norm(tf, dim=-1), min=1e-8)
    return (num / den) / temperature


def contrastive_loss(quantized, context, neg_pos, span_mask,
                     temperature: float):
    """Cosine similarity of the context against [positive; negatives] at
    `temperature`, negatives equal to the positive squashed to −1e9, CE
    toward the positive summed over the masked anchors."""
    B, T, D = quantized.shape
    N = neg_pos.shape[-1]
    negs = torch.gather(quantized, 1, neg_pos.reshape(B, -1)[:, :, None]
                        .expand(-1, -1, D)).reshape(B, T, N, D)
    negs = negs.permute(2, 0, 1, 3)                           # (N,B,T,D)
    logits = _cosine_logits(context, torch.cat([quantized[None], negs], 0),
                            temperature)
    neg_is_pos = (quantized[None] == negs).all(-1)
    logits = torch.cat([logits[:1], logits[1:].masked_fill(neg_is_pos,
                                                           -1e9)], 0)
    ce = -torch.log_softmax(logits, 0)[0]
    return torch.where(span_mask, ce, torch.zeros_like(ce)).sum()


def gumbel_temperature(cfg: Wav2vec2Config, steps) -> float:
    """max(max_t · decay^steps, min_t)."""
    return max(cfg.max_gumbel_temperature
               * cfg.gumbel_temperature_decay ** float(steps),
               cfg.min_gumbel_temperature)


def _contrastive_terms(model, unmasked, out_c, valid, span_mask, cfg,
                       steps, generator, neg_pos, gumbels):
    """The contrastive branch shared by wav2vec 2.0 and w2v-BERT: (loss_c,
    its parts, the quantizer's targets)."""
    quantized, perplexity, targets = gumbel_quantize(
        model, unmasked, valid, gumbel_temperature(cfg, steps), cfg, generator,
        gumbels)
    neg_pos = sample_negative_indices(span_mask, cfg.num_negatives,
                                      generator, neg_pos)
    closs = contrastive_loss(quantized, out_c, neg_pos, span_mask,
                             cfg.contrastive_temperature)
    sample_size = torch.clamp(gb.total(span_mask.sum()), min=1)
    G, C = cfg.num_codebooks, cfg.codebook_size
    # a data rank's share of the global perplexity's term
    diversity = gb.share((G * C - perplexity) / (C * G))
    loss = closs
    if cfg.diversity_weight != 0.0:
        loss = loss + cfg.diversity_weight * diversity * sample_size
    loss = loss / sample_size
    features_pen = gb.mean(unmasked.to(torch.float32) ** 2)
    if cfg.features_regularization_weight != 0.0:
        loss = loss + cfg.features_regularization_weight * features_pen
    parts = {'loss_contrastive': closs / sample_size,
             'loss_diversity': diversity * sample_size,
             'code_ppl': gb.share(perplexity), 'features_l2': features_pen,
             'num_masked': span_mask.sum()}
    return loss, parts, targets


def _masked_spans(xs, valid, cfg: Wav2vec2Config, generator, span_mask):
    if span_mask is None:
        B, T = valid.shape
        span_mask = make_mask(B, T, cfg.mask_prob, cfg.mask_length,
                              generator, xs.device) & valid
    return span_mask


def wav2vec2_loss(model, feats, feats_lens, cfg: Wav2vec2Config, steps=0,
                  generator=None, span_mask=None, neg_pos=None,
                  gumbels=None):
    """Subsample → masked spans replaced by the trained mask_emb → the
    encoder blocks → InfoNCE against the gumbel-quantized unmasked
    features (+ the diversity term at diversity_weight, + the features'
    L2 at features_regularization_weight)."""
    xs, pos_emb, masks = ssl_subsample(model, feats, feats_lens)
    valid = masks[:, 0, :]
    span_mask = _masked_spans(xs, valid, cfg, generator, span_mask)
    masked = torch.where(span_mask[..., None],
                         model.mask_emb.to(xs.dtype), xs)
    _, out = ssl_encoder_blocks(model, masked, masks, pos_emb)
    loss, parts, _ = _contrastive_terms(model, xs, out, valid,
                                        span_mask, cfg, steps, generator,
                                        neg_pos, gumbels)
    return {'loss': loss, **parts}


def w2vbert_loss(model, feats, feats_lens, cfg: Wav2vec2Config,
                 bcfg: W2VBertConfig, steps=0, generator=None,
                 span_mask=None, neg_pos=None, gumbels=None,
                 mask_noise=None):
    """One encoder pass over the features with masked spans replaced by
    N(0, 0.1²) noise: the contrastive branch after `contrastive_blocks`,
    the MLM branch (per-codebook heads toward the quantizer's ids at the
    masked positions) on the final output; the MLM weight warms up from
    0.1 to mlm_weight over warmup_steps."""
    xs, pos_emb, masks = ssl_subsample(model, feats, feats_lens)
    valid = masks[:, 0, :]
    span_mask = _masked_spans(xs, valid, cfg, generator, span_mask)
    if mask_noise is None:
        mask_noise = torch.randn(xs.shape, generator=generator,
                                 device=xs.device) * 0.1
    masked = torch.where(span_mask[..., None], mask_noise.to(xs.dtype), xs)
    cvec, mvec = ssl_encoder_blocks(model, masked, masks, pos_emb,
                                    bcfg.contrastive_blocks)
    loss_c, parts, targets = _contrastive_terms(
        model, xs, cvec, valid, span_mask, cfg, steps, generator, neg_pos,
        gumbels)
    G = cfg.num_codebooks
    logits = torch.einsum('btd,gdc->bgtc', mvec.to(torch.float32),
                          model.top_n_out.to(torch.float32))
    if model.top_n_out_bias is not None:
        logits = logits + model.top_n_out_bias[None, :, None, :]
    logp = torch.log_softmax(logits, -1).permute(0, 2, 1, 3)   # (B,T,G,C)
    tok = torch.gather(logp, -1, targets[..., None])[..., 0]
    mlm_mask = (valid & span_mask).to(torch.float32)
    loss_mlm = (-(tok * mlm_mask[..., None]).sum()
                / ((gb.total(mlm_mask.sum()) + 1e-5) * G))
    num_codes = torch.clamp(gb.total(span_mask.sum()) * G, min=1)
    pred = logits.argmax(-1).permute(0, 2, 1)
    codes_acc = ((pred == targets) & span_mask[..., None]).sum() / num_codes
    s = float(steps)
    mlm_w = (bcfg.mlm_weight if s >= bcfg.warmup_steps
             else 0.1 + 0.9 * s / bcfg.warmup_steps)
    loss = bcfg.contrastive_weight * loss_c + mlm_w * loss_mlm
    return {'loss': loss, **parts, 'loss_mlm': loss_mlm,
            'codes_acc': codes_acc}


def quantizer_window(subsampling_rate: int):
    """(stack_frames, stride) of BEST-RQ's quantizer: the encoder's
    receptive window (right_context + 1) every subsampling_rate frames, so
    the targets are as long as the encoder's output."""
    return ({1: 1, 4: 7, 6: 11, 8: 15}.get(subsampling_rate,
                                           subsampling_rate),
            subsampling_rate)

