"""Paraformer: non-autoregressive CIF-based recognition.

Counterpart of reverb_tpu/models/paraformer.py (`CifConfig`, `cif_alphas`,
`cif_tail_process`, `cif_fires`, `cif_peaks_from_tp`,
`tp_alphas_forward`, `cif_fire`, `ParaformerConfig`, `paraformer_loss`,
`paraformer_greedy_decode`) and of the SANM forward
(reverb_tpu/models/sanm.py:sanm_forward_paraformer).

The CIF head gives each encoder frame a firing weight α; frames are
integrated until the running weight crosses the threshold, which fires one
token embedding.  The integrate-and-fire recursion is a frame loop in f32
on the device, as JAX's `lax.scan`: the comparison uses `threshold`, the
reset subtracts a hard-coded 1.0 and a firing frame is topped up with
1 − integ, which a cumulative-sum rewrite would round differently (and so
move fires).  The loop keeps one (B,) integrator and one (B, D) partial
embedding; the fired embeddings are gathered once after it (a fire past
the buffer's last slot overwrites that slot, the last write winning, as
JAX's clipped write does).

The timestamp (tp) branch upsamples the encoder output ×u with a
ConvTranspose1d of stride = kernel (weight (in, out, k)), runs a BiLSTM
over the whole padded sequence (no packing: the backward direction reads
the padding first, as JAX's) and a linear layer.  Its BiLSTM is
`diar/models.py:LSTM`; JAX's one bias per direction is `bias_ih` with
`bias_hh` zero and frozen (convert.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.models.modules import Conv1d, Linear
from reverb_tpu_torch.parallel import global_batch as gb
from reverb_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class CifConfig:
    """Cif / Predictor hyper-parameters (defaults of the reference classes:
    residual, cnn_groups 0 = depthwise; converted Ali-Paraformer configs
    pass cnn_groups 1 and residual False)."""
    idim: int = 256
    l_order: int = 1
    r_order: int = 1
    threshold: float = 1.0
    smooth_factor: float = 1.0
    noise_threshold: float = 0.0
    tail_threshold: float = 0.45
    residual: bool = True
    cnn_groups: int = 0
    # the timestamp (tp) branch
    smooth_factor2: float = 0.25
    noise_threshold2: float = 0.01
    upsample_times: int = 3

    @property
    def groups(self) -> int:
        return self.idim if self.cnn_groups == 0 else self.cnn_groups


@dataclasses.dataclass(frozen=True)
class ParaformerConfig:
    vocab_size: int = 1000
    encoder_output_size: int = 256
    sampler_ratio: float = 0.75
    ctc_weight: float = 0.3
    cif: CifConfig = CifConfig()


class ConvTranspose1dSameK(nn.Module):
    """ConvTranspose1d with stride = kernel (the tp upsampler): torch's
    weight layout (in, out, k), a bias; initialized uniform in
    ±1/√(in·k), bias zero, as the JAX init."""

    def __init__(self, idim: int, odim: int, k: int):
        super().__init__()
        self.k = k
        self.weight = nn.Parameter(torch.empty(idim, odim, k))
        self.bias = nn.Parameter(torch.empty(odim))

    def reset_parameters(self, g):
        bound = 1.0 / math.sqrt(self.weight.shape[0] * self.k)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=g)
            self.bias.zero_()

    def forward(self, x):
        """x (B, T, Din) → (B, T·k, Dout)."""
        y = torch.einsum('btc,cok->btko', x, self.weight.to(x.dtype))
        B, T, k, D = y.shape
        return y.reshape(B, T * k, D) + self.bias.to(x.dtype)


class Predictor(nn.Module):
    """The CIF head (`cif_conv1d`, `cif_output`) and, with `with_tp`, the
    timestamp branch (`tp_upsample_cnn`, `tp_blstm`, `tp_output`) under the
    JAX tree's flattened `predictor.*` names."""

    def __init__(self, cfg: CifConfig, with_tp: bool = False):
        super().__init__()
        from reverb_tpu_torch.diar.models import LSTM
        self.cfg = cfg
        k = cfg.l_order + cfg.r_order + 1
        self.cif_conv1d = Conv1d(cfg.idim, cfg.idim, k, groups=cfg.groups)
        self.cif_output = Linear(cfg.idim, 1)
        self.with_tp = with_tp
        if with_tp:
            self.tp_upsample_cnn = ConvTranspose1dSameK(
                cfg.idim, cfg.idim, cfg.upsample_times)
            self.tp_blstm = LSTM(cfg.idim, cfg.idim, bidirectional=True,
                                 batch_first=True)
            self.tp_output = Linear(2 * cfg.idim, 1)


def cif_alphas(pred: Predictor, encoder_out, encoder_mask):
    """Per-frame firing weights α (B, T): pad (l, r) → grouped conv1d →
    [+ residual] → relu → linear → sigmoid → relu(α·smooth − noise) →
    mask."""
    cfg = pred.cfg
    x = encoder_out.transpose(1, 2)                          # (B, D, T)
    conv = pred.cif_conv1d
    y = F.conv1d(F.pad(x, (cfg.l_order, cfg.r_order)),
                 conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                 groups=conv.groups)
    if cfg.residual:
        y = y + x
    y = torch.relu(y).transpose(1, 2)
    alphas = torch.sigmoid(pred.cif_output(y))[..., 0]
    alphas = torch.relu(alphas * cfg.smooth_factor - cfg.noise_threshold)
    return torch.where(encoder_mask[:, 0, :], alphas,
                       torch.zeros((), dtype=alphas.dtype,
                                   device=alphas.device))


def cif_tail_process(hidden, alphas, mask, tail_threshold: float):
    """Inference tail: one more column carrying `tail_threshold` at each
    row's first padded position (the appended column for an unpadded row),
    hidden extended by a zero frame, token count floor(Σα).  mask (B, T)
    bool.  Returns (hidden (B, T+1, D), alphas (B, T+1), token_num (B,))."""
    B, T, D = hidden.shape
    m = mask.to(alphas.dtype)
    zeros_c = torch.zeros((B, 1), dtype=alphas.dtype, device=alphas.device)
    mask_1 = torch.cat([m, zeros_c], 1)
    mask_2 = torch.cat([torch.ones_like(zeros_c), m], 1)
    alphas = torch.cat([alphas, zeros_c], 1) + (mask_2 - mask_1) \
        * tail_threshold
    hidden = torch.cat([hidden, hidden.new_zeros((B, 1, D))], 1)
    return hidden, alphas, torch.floor(alphas.sum(-1))


def cif_fires(alphas, threshold: float):
    """The running integration value at each frame, reset by −threshold
    after a fire (B, T) → (B, T); a frame loop, as JAX's scan."""
    integ = torch.zeros_like(alphas[:, 0])
    fires = []
    for t in range(alphas.shape[1]):
        integ = integ + alphas[:, t]
        fires.append(integ)
        integ = torch.where(integ >= threshold, integ - threshold, integ)
    return torch.stack(fires, 1)


def cif_peaks_from_tp(tp_alphas, token_nums, threshold: float = 1.0):
    """Scale the tp α so each row sums to the main head's token count, then
    integrate and fire at threshold − 1e-4."""
    total = tp_alphas.sum(-1)
    scale = tp_alphas / (total / torch.clamp(token_nums.to(tp_alphas.dtype),
                                             min=1e-6))[:, None]
    return cif_fires(scale, threshold - 1e-4)


def tp_alphas_forward(pred: Predictor, hidden, encoder_mask):
    """Timestamp-branch α at ×upsample_times the encoder frame rate."""
    cfg = pred.cfg
    h, _ = pred.tp_blstm(pred.tp_upsample_cnn(hidden))
    tp = torch.sigmoid(pred.tp_output(h))[..., 0]
    tp = torch.relu(tp * cfg.smooth_factor2 - cfg.noise_threshold2)
    m = torch.repeat_interleave(encoder_mask[:, 0, :], cfg.upsample_times,
                                dim=1)
    return tp * m.to(tp.dtype)


def cif_fire(encoder_out, alphas, max_tokens: int, threshold: float = 1.0):
    """Integrate and fire: (B, T, D) frames and (B, T) α → ((B, max_tokens,
    D) fired embeddings, (B,) int32 token counts).  The state is f32 (a
    bf16 frame is promoted, as in JAX)."""
    B, T, D = encoder_out.shape
    dev = encoder_out.device
    integ = torch.zeros((B,), device=dev)
    frac = torch.zeros((B, D), device=dev)
    n_fired = torch.zeros((B,), dtype=torch.int32, device=dev)
    embs, fires, slots = [], [], []
    for t in range(T):
        a = alphas[:, t]
        h = encoder_out[:, t]
        completion = 1.0 - integ
        new_integ = integ + a
        fire = new_integ >= threshold
        used = torch.where(fire, completion, a)
        embs.append(frac + used[:, None] * h)
        fires.append(fire)
        slots.append(torch.clamp(n_fired, 0, max_tokens - 1))
        frac = torch.where(fire[:, None], (a - used)[:, None] * h,
                           frac + a[:, None] * h)
        integ = torch.where(fire, new_integ - 1.0, new_integ)
        n_fired = n_fired + fire.to(torch.int32)
    # each slot takes the embedding of the last frame that fired into it
    frame = torch.where(torch.stack(fires, 1),
                        torch.arange(T, device=dev)[None, :], -1)
    last = torch.full((B, max_tokens), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(1, torch.stack(slots, 1).to(torch.int64),
                               frame, 'amax')
    emb = torch.stack(embs, 1)                               # (B, T, D)
    out = torch.gather(emb, 1, torch.clamp(last, min=0)[:, :, None]
                       .expand(B, max_tokens, D))
    out = torch.where((last >= 0)[:, :, None], out,
                      torch.zeros((), dtype=out.dtype, device=dev))
    return out, n_fired


def paraformer_loss(pred: Predictor, output_layer: Linear, encoder_out,
                    encoder_mask, labels, label_lens, ignore_id: int = -1):
    """NAR loss of the conformer-encoder Paraformer: CE over the CIF-fired
    embeddings with α scaled to sum to the target length (the fire count
    teacher-forced) + the mean absolute error of the raw count."""
    alphas = cif_alphas(pred, encoder_out, encoder_mask)
    token_count = alphas.sum(1)
    U = labels.shape[1]
    target_count = label_lens.to(torch.float32)
    scale = target_count / torch.clamp(token_count, min=1e-4)
    fired, _ = cif_fire(encoder_out, alphas * scale[:, None], U,
                        pred.cfg.threshold)
    logp = torch.log_softmax(output_layer(fired).to(torch.float32), -1)
    tgt = torch.where(labels == ignore_id, torch.zeros_like(labels), labels)
    tok_lp = torch.gather(logp, -1, tgt[..., None].to(torch.int64))[..., 0]
    mask = labels != ignore_id
    ce = -torch.where(mask, tok_lp, torch.zeros_like(tok_lp)).sum() \
        / torch.clamp(gb.total(mask.sum()), min=1)
    mae = gb.mean((token_count - target_count).abs())
    return {'loss': ce + mae, 'loss_ce': ce, 'loss_quantity': mae,
            'pred_count': token_count}


def paraformer_greedy_decode(pred: Predictor, output_layer: Linear,
                             encoder_out, encoder_mask,
                             max_tokens: int = 200):
    """Inference of the CIF head alone: fire with the raw α, argmax per
    token.  Returns (tokens (B, max_tokens), n_fired (B,))."""
    alphas = cif_alphas(pred, encoder_out, encoder_mask)
    fired, n_fired = cif_fire(encoder_out, alphas, max_tokens,
                              pred.cfg.threshold)
    return torch.argmax(output_layer(fired), -1), n_fired


class SanmParaformer(nn.Module):
    """Ali-Paraformer: SANM encoder, CIF predictor (with the tp branch of a
    V3 checkpoint), SANM decoder, and a CTC head when ctc_weight > 0."""

    def __init__(self, scfg, cif: CifConfig, with_tp: bool = False,
                 with_ctc: bool = False):
        super().__init__()
        from reverb_tpu_torch.models.ctc import CTC
        from reverb_tpu_torch.models.sanm import SanmDecoder, SanmEncoder
        self.scfg = self.cfg = scfg
        self.cif = cif
        self.train_cfg = None        # the loss's settings (registry.py)
        self.encoder = SanmEncoder(scfg)
        self.decoder = SanmDecoder(scfg)
        self.predictor = Predictor(cif, with_tp)
        self.ctc = CTC(scfg.vocab_size, scfg.output_size) if with_ctc \
            else None

    def forward_paraformer(self, feats, feats_lens, max_tokens: int = 512):
        """Encoder → CIF (inference tail) → one decoder pass → log-softmax
        (reverb_tpu/models/sanm.py:sanm_forward_paraformer).  Returns
        (log-probs (B, max_tokens, V) f32, token counts (B,) int32, tp α
        (B, T·u): zeros without the tp branch).  Its phases are the spans
        `paraformer.encoder`, `paraformer.cif` and `paraformer.decoder`
        (utils/profiling.py:span)."""
        cif = self.cif
        with span('paraformer.encoder'):
            enc, mask = self.encoder(feats, feats_lens)
        with span('paraformer.cif'):
            alphas = cif_alphas(self.predictor, enc, mask)
            hidden = enc
            if cif.tail_threshold > 0.0:
                hidden, alphas, token_num = cif_tail_process(
                    enc, alphas, mask[:, 0, :], cif.tail_threshold)
            else:
                token_num = torch.floor(alphas.sum(-1))
            token_num = torch.clamp(token_num.to(torch.int32), max=max_tokens)
            fired, _ = cif_fire(hidden, alphas, max_tokens, cif.threshold)
        with span('paraformer.decoder'):
            logits = self.decoder(enc, mask, fired, token_num)
            logp = torch.log_softmax(logits.to(torch.float32), -1)
            if self.predictor.with_tp:
                tp = tp_alphas_forward(self.predictor, enc, mask)
            else:
                tp = torch.zeros((enc.shape[0],
                                  enc.shape[1] * cif.upsample_times),
                                 device=enc.device)
        return logp, token_num, tp
