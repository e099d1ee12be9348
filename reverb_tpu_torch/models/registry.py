"""Model registry: config-driven model construction, the `init_model` API.

Counterpart of reverb_tpu/models/registry.py (`ModelBundle`,
`_hybrid_loss`, `_alt_encoder_bundle`, `_asr_bundle`,
`_transducer_bundle`, `init_model`): a dispatch on configs['model'] and,
for `asr_model`, configs['encoder'], so a model family is reachable from
a config alone:

  model: asr_model (default) | k2_model | transducer | bitransducer |
         paraformer | ctl_model | bestrq | wav2vec2 | w2vbert | whisper
  encoder: conformer | transformer | branchformer | e_branchformer |
           squeezeformer | efficient_conformer  (asr_model families);
           sanm_encoder | conformer  (paraformer)

Each entry returns a `ModelBundle` — (kind, cfg, model, loss_fn) — with a
uniform `loss_fn(model, batch, generator=None) → {'loss': ..., ...}`, so
the trainer is model-agnostic; dropout draws from `generator` (none
without one, as rng=None in JAX).  An unknown name raises ValueError, as
there.  The SSL objectives and the CTL model also draw their masks,
noise, gumbels and negatives from `generator` (from seed 0 without one,
as the JAX bundles' PRNGKey(0)); the SSL losses read `batch['steps']`
(0 when absent, as the JAX package never sets it: the gumbel temperature
stays at its maximum and w2v-BERT's MLM weight at 0.1).

A paraformer is the Ali-Paraformer SANM stack (`encoder: sanm_encoder`,
models/sanm.py) or the conformer encoder with the CIF head
(models/paraformer.py).  The SANM loss's glancing sampler draws its
uniforms from the loss's generator (from seed 0 without one, as JAX's
PRNGKey(0)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from reverb_tpu_torch.models import ctc as ctc_mod
from reverb_tpu_torch.models import encoders_alt as alt
from reverb_tpu_torch.models.asr_model import (ASRModel, ModelConfig,
                                               build_model, compute_loss)
from reverb_tpu_torch.models.ctc import CTC
from reverb_tpu_torch.models.decoder import DecoderConfig, build_decoder
from reverb_tpu_torch.models.modules import reset_parameters
from reverb_tpu_torch.models.transducer import (TransducerConfig,
                                                TransducerModel,
                                                transducer_loss)
from reverb_tpu_torch.parallel import global_batch as gb
from reverb_tpu_torch.utils.common import (add_sos_eos, resolve_device,
                                           reverse_sequence, th_accuracy)

PORTED = ('asr_model', 'k2_model', 'transducer', 'bitransducer',
          'paraformer', 'ctl_model', 'bestrq', 'wav2vec2', 'w2vbert',
          'whisper')
UNPORTED = ()
ALT_ENCODERS = tuple(alt.ALT_ENCODERS)


@dataclasses.dataclass
class ModelBundle:
    kind: str
    cfg: Any
    model: nn.Module
    loss_fn: Callable        # (model, batch, generator) -> metrics w/ 'loss'


def _dataclass_kwargs(cls, conf: Dict) -> Dict:
    fields = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in conf.items() if k in fields}


def _compute_dtype(configs) -> torch.dtype:
    """The activation dtype of the config's `dtype` (bf16 for the half
    types, else f32)."""
    dtype = str(configs.get('dtype', 'fp32')).lower()
    return torch.bfloat16 if dtype in ('bf16', 'bfloat16', 'fp16',
                                       'float16') else torch.float32


def model_kind(configs: Dict) -> str:
    """The family `init_model` builds for `configs`: an alternative
    encoder's name for an asr_model with one, else configs['model'].
    Raises ValueError for an unknown one."""
    kind = configs.get('model', 'asr_model')
    if kind == 'asr_model' and configs.get('encoder') in ALT_ENCODERS:
        return configs['encoder']
    if kind not in PORTED:
        raise ValueError(f'unknown model type {kind!r}; choose from '
                         f'{sorted(PORTED)}')
    return kind


def _materialise(make, device, generator, state_dict):
    """Build `make()` on the meta device, then on `device` from the state
    dict (strict) or from `generator`; trainable, in training mode."""
    with torch.device('meta'):
        model = make()
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        reset_parameters(model, generator)
    return model.train().requires_grad_(True)


def _has_cmvn(state_dict, cmvn) -> bool:
    """Whether the encoder holds global CMVN stats: as the state dict
    decides, else when stats are given."""
    if state_dict is not None:
        return 'encoder.global_cmvn.mean' in state_dict
    return cmvn is not None


def _fill_cmvn(model, state_dict, cmvn):
    """Copy the CMVN stats into a model built from a generator."""
    if state_dict is None and cmvn is not None:
        with torch.no_grad():
            for t, v in zip((model.encoder.global_cmvn.mean,
                             model.encoder.global_cmvn.istd), cmvn):
                t.copy_(torch.as_tensor(np.asarray(v, np.float32)))


def _seeded(generator, device):
    """`generator`, or one seeded 0 on `device` (the JAX bundles'
    PRNGKey(0) where no rng is given)."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def _freeze_lstm_second_bias(model: nn.Module):
    """nn.LSTM's bias_hh stays zero and takes no gradient: the JAX LSTM
    has one bias, held in bias_ih (convert.py)."""
    for m in model.modules():
        if isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith('bias_hh'):
                    p.requires_grad_(False)
            m.flatten_parameters()


# ------------------------- hybrid loss over alt encoders -------------------

class AltEncoderModel(nn.Module):
    """An alternative encoder, a (bi)transformer decoder and a CTC head
    under the JAX tree's names (`encoder.*`, `decoder.*`, `ctc.ctc_lo`)."""

    def __init__(self, ecfg, mcfg: ModelConfig, encoder_cls):
        super().__init__()
        self.ecfg = ecfg
        self.cfg = mcfg
        self.encoder = encoder_cls(ecfg)
        self.decoder = build_decoder(mcfg.decoder)
        self.ctc = CTC(mcfg.vocab_size, ecfg.output_size)


def hybrid_loss(model: AltEncoderModel, batch: Dict, generator=None) -> Dict:
    """CTC + label-smoothed attention loss over the alternative encoder
    (reverb_tpu/models/registry.py:_hybrid_loss): the left decoder only,
    not length-normalised.  The features enter in the config's dtype (f32
    by default, as JAX's)."""
    mcfg = model.cfg
    enc, mask = model.encoder(batch['feats'].to(mcfg.compute_dtype),
                              batch['feats_lengths'], generator)
    enc_lens = mask[:, 0, :].sum(-1)
    text, text_lens = batch['target'], batch['target_lengths']
    norm = gb.norms(batch) or {'rows': None, 'tokens': None}
    loss_ctc = loss_att = acc = None
    if mcfg.ctc_weight != 0.0:
        loss_ctc = ctc_mod.ctc_loss(
            model.ctc, enc, enc_lens,
            torch.where(text == mcfg.ignore_id, torch.zeros_like(text),
                        text), text_lens, mcfg.blank_id, denom=norm['rows'])
    if mcfg.ctc_weight != 1.0:
        ys_in, ys_out = add_sos_eos(text, text_lens, mcfg.sos, mcfg.eos,
                                    mcfg.ignore_id)
        # the JAX loss reads only the left decoder's output
        l_x, _ = model.decoder(enc, mask, ys_in, text_lens + 1, None, 0.0,
                               generator=generator)
        loss_att = ctc_mod.label_smoothing_loss(
            l_x, ys_out, mcfg.lsm_weight, mcfg.vocab_size, mcfg.ignore_id,
            mcfg.length_normalized_loss,
            norm['tokens' if mcfg.length_normalized_loss else 'rows'])
        acc = th_accuracy(l_x, ys_out, mcfg.ignore_id, norm['tokens'])
    if loss_ctc is None:
        total = loss_att
    elif loss_att is None:
        total = loss_ctc
    else:
        total = mcfg.ctc_weight * loss_ctc + (1 - mcfg.ctc_weight) * loss_att
    return {'loss': total, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
            'th_accuracy': acc}


def _alt_encoder_bundle(configs, device, generator, cmvn, state_dict,
                        kind: str) -> ModelBundle:
    enc_conf = dict(configs.get('encoder_conf', {}) or {})
    enc_conf['input_size'] = configs.get('input_dim', 80)
    for k in ('group_layer_idx', 'stride_layer_idx', 'stride'):
        if isinstance(enc_conf.get(k), list):
            enc_conf[k] = tuple(enc_conf[k])
    cfg_cls, enc_cls = alt.ALT_ENCODERS[kind]
    kwargs = _dataclass_kwargs(cfg_cls, enc_conf)
    if cfg_cls is alt.BranchformerConfig:
        kwargs['e_branchformer'] = kind == 'e_branchformer'
    ecfg = cfg_cls(**kwargs)
    vocab = configs.get('output_dim') or configs['vocab_size']
    model_conf = configs.get('model_conf', {}) or {}
    compute_dtype = _compute_dtype(configs)
    dcfg = DecoderConfig(
        vocab_size=vocab, encoder_output_size=ecfg.output_size,
        decoder_type=('bitransformer' if 'bitransformer' in configs.get(
            'decoder', '') else 'transformer'),
        **dict(_dataclass_kwargs(DecoderConfig,
                                 dict(configs.get('decoder_conf', {}) or {})),
               compute_dtype=compute_dtype))
    mcfg = ModelConfig(
        vocab_size=vocab, encoder=None, decoder=dcfg,
        ctc_weight=model_conf.get('ctc_weight', 0.3),
        lsm_weight=model_conf.get('lsm_weight', 0.1),
        reverse_weight=model_conf.get('reverse_weight', 0.0),
        sos=vocab - 1, eos=vocab - 1, compute_dtype=compute_dtype)
    model = _materialise(lambda: AltEncoderModel(ecfg, mcfg, enc_cls),
                         device, generator, state_dict)
    if cmvn is not None:
        model.encoder.set_cmvn(*cmvn)
    return ModelBundle(kind, (ecfg, mcfg), model, hybrid_loss)


# ------------------------------ families ------------------------------

def _asr_bundle(configs, device, generator, cmvn, state_dict) -> ModelBundle:
    cfg = ModelConfig.from_config(configs)
    model = build_model(cfg, device, state_dict, generator, train=True,
                        cmvn=cmvn)

    def loss(model, batch, generator=None):
        return compute_loss(model, batch, generator, norm=gb.norms(batch))

    return ModelBundle('asr_model', cfg, model, loss)


def transducer_config(configs: Dict, acfg: ModelConfig) -> TransducerConfig:
    """The TransducerConfig of a transducer config.yaml: `predictor`,
    `predictor_conf` and `joint_conf` over the JAX defaults."""
    return TransducerConfig(
        vocab_size=acfg.vocab_size, blank_id=acfg.blank_id,
        encoder_output_size=acfg.encoder.output_size,
        predictor=configs.get('predictor', 'rnn'),
        **_dataclass_kwargs(TransducerConfig, {
            **(configs.get('predictor_conf', {}) or {}),
            **(configs.get('joint_conf', {}) or {})}))


def transducer_loss_fn(model: TransducerModel, batch: Dict,
                       generator=None) -> Dict:
    """transducer_weight·rnnt + ctc_weight·ctc; the bidirectional model's
    rnnt term is (1 − w_r)·L2R + w_r·R2L, the R2L pair scoring the
    time-reversed encoder stream against the reversed labels
    (reverb_tpu/models/registry.py:_transducer_bundle)."""
    acfg, tcfg = model.cfg, model.tcfg
    w = model.loss_weights
    enc, mask = model.forward_encoder(batch['feats'],
                                      batch['feats_lengths'],
                                      batch.get('cat_embs'), generator)
    enc_lens = mask[:, 0, :].sum(-1).to(torch.int32)
    text, text_lens = batch['target'], batch['target_lengths']
    labels = torch.where(text == acfg.ignore_id, torch.zeros_like(text),
                         text)
    l_rnnt = transducer_loss(model.predictor, model.joint, enc, enc_lens,
                             labels, text_lens, tcfg.blank_id)
    if hasattr(model, 'predictor_r'):
        l_r = transducer_loss(
            model.predictor_r, model.joint_r,
            reverse_sequence(enc, enc_lens, 0.0), enc_lens,
            reverse_sequence(labels, text_lens, 0), text_lens,
            tcfg.blank_id)
        l_rnnt = (1.0 - w['r']) * l_rnnt + w['r'] * l_r
    l_ctc = (ctc_mod.ctc_loss(model.ctc, enc, enc_lens, labels, text_lens,
                              acfg.blank_id, denom=gb.total(labels.shape[0]))
             if w['ctc'] else 0.0)
    return {'loss': w['t'] * l_rnnt + w['ctc'] * l_ctc, 'loss_rnnt': l_rnnt,
            'loss_ctc': l_ctc}


def _transducer_bundle(configs, device, generator, cmvn,
                       state_dict) -> ModelBundle:
    acfg = ModelConfig.from_config(configs)
    tcfg = transducer_config(configs, acfg)
    model_conf = configs.get('model_conf', {}) or {}
    bi = (configs.get('model') == 'bitransducer'
          or bool(model_conf.get('use_bitransducer')))
    with_cmvn = _has_cmvn(state_dict, cmvn)
    weights = {'t': model_conf.get('transducer_weight', 0.75),
               'ctc': model_conf.get('ctc_weight', 0.25),
               'r': model_conf.get('bitransducer_r_weight', 0.3)}
    model = _materialise(
        lambda: TransducerModel(acfg, tcfg, bi, with_cmvn, weights), device,
        generator, state_dict)
    _fill_cmvn(model, state_dict, cmvn)
    _freeze_lstm_second_bias(model)
    return ModelBundle('bitransducer' if bi else 'transducer', (acfg, tcfg),
                       model, transducer_loss_fn)


# ------------------------------ paraformer ------------------------------

def sanm_configs(configs):
    """(SanmConfig, CifConfig) of a WeNet-converted paraformer config:
    shared by the training bundle and the serving CLI
    (reverb_tpu/models/registry.py:sanm_configs).  `sanm_shift` is read
    from the reference's key `sanm_shfit` first."""
    from reverb_tpu_torch.models.paraformer import CifConfig
    from reverb_tpu_torch.models.sanm import SanmConfig
    enc_conf = dict(configs.get('encoder_conf', {}) or {})
    dec_conf = dict(configs.get('decoder_conf', {}) or {})
    vocab = configs.get('output_dim') or configs['vocab_size']
    lfr_conf = configs.get('lfr_conf', {}) or {}
    m = int(lfr_conf.get('lfr_m', 7))
    scfg = SanmConfig(
        input_size=configs.get('input_dim', 80) * m,
        output_size=enc_conf.get('output_size', 512),
        attention_heads=enc_conf.get('attention_heads', 4),
        linear_units=enc_conf.get('linear_units', 2048),
        num_blocks=enc_conf.get('num_blocks', 50),
        decoder_blocks=dec_conf.get('num_blocks', 16),
        vocab_size=vocab,
        kernel_size=enc_conf.get('kernel_size', 11),
        sanm_shift=enc_conf.get('sanm_shfit', enc_conf.get('sanm_shift', 0)),
        dropout_rate=enc_conf.get('dropout_rate', 0.1),
        lfr_m=m, lfr_n=int(lfr_conf.get('lfr_n', 6)))
    cif_kwargs = _dataclass_kwargs(
        CifConfig, dict(configs.get('cif_conf',
                                    configs.get('predictor_conf', {})) or {}))
    cif_kwargs['idim'] = scfg.output_size
    return scfg, CifConfig(**cif_kwargs)


@dataclasses.dataclass(frozen=True)
class SanmTrainConfig:
    """What the SANM Paraformer's loss reads besides the model's shapes
    (the config's model_conf, and its dtype)."""
    ctc_weight: float = 0.0
    sampling_ratio: float = 0.75
    sampler: bool = True
    lsm_weight: float = 0.1
    length_normalized_loss: bool = False
    compute_dtype: torch.dtype = torch.float32


def glancing_replace(tgt_mask, target_num, generator, device, u=None):
    """The glancing sampler's choice (reverb_tpu/models/registry.py:
    _sanm_paraformer_bundle): uniforms drawn from `generator` (or `u`,
    (B, U), given), set to inf on padding, ranked by argsort of argsort;
    a valid position is replaced where its rank is below its row's
    target_num.  (B, U) bool."""
    r = u if u is not None else torch.rand(tgt_mask.shape,
                                           generator=generator,
                                           device=device)
    r = torch.where(tgt_mask, r, math.inf)
    ranks = torch.argsort(torch.argsort(r, dim=1, stable=True), dim=1,
                          stable=True)
    return (ranks < target_num[:, None]) & tgt_mask


def sanm_paraformer_loss(model, batch: Dict, generator=None) -> Dict:
    """LFR → SANM encoder → CIF (α scaled to the target length) →
    glancing sampler (its uniforms from the batch's `glance_u` when it
    carries them) → SANM decoder; loss = label-smoothed decoder loss +
    the quantity L1 (+ ctc_weight · CTC)."""
    from reverb_tpu_torch.models.paraformer import cif_alphas, cif_fire
    tc = model.train_cfg
    enc, mask = model.encoder(batch['feats'].to(tc.compute_dtype),
                              batch['feats_lengths'], generator)
    text, text_lens = batch['target'], batch['target_lengths']
    dev = enc.device
    labels = torch.where(text == -1, torch.zeros_like(text), text)
    B, U = labels.shape
    tgt_mask = torch.arange(U, device=dev)[None, :] < text_lens[:, None]
    alphas = cif_alphas(model.predictor, enc, mask)
    token_num = alphas.sum(1)
    scale = text_lens.to(torch.float32) / torch.clamp(token_num, min=1e-4)
    acoustic, _ = cif_fire(enc, alphas * scale[:, None], U,
                           model.cif.threshold)
    zero = torch.zeros((), dtype=acoustic.dtype, device=dev)
    if tc.sampler:
        # where the frozen decoder errs, mix in the ground-truth embeddings
        with torch.no_grad():
            dec0 = model.decoder(enc, mask, acoustic, text_lens)
        same = ((dec0.argmax(-1) == labels) & tgt_mask).sum(1)
        target_num = ((text_lens - same).to(torch.float32)
                      * tc.sampling_ratio).to(torch.int32)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        given = {'u': batch['glance_u']} if 'glance_u' in batch else {}
        replace = glancing_replace(tgt_mask, target_num, generator, dev,
                                   **given)
        # the embedding layer's lookup (its rows are a 'model' rank's
        # block of the vocabulary under tensor parallelism)
        gt_emb = model.decoder.embed['0'](labels.to(torch.int64))
        sematic = torch.where(replace[:, :, None], gt_emb.to(acoustic.dtype),
                              acoustic)
        sematic = torch.where(tgt_mask[:, :, None], sematic, zero)
    else:
        sematic = torch.where(tgt_mask[:, :, None], acoustic, zero)
    dec_out = model.decoder(enc, mask, sematic, text_lens, generator)
    denom = gb.total(tgt_mask.sum() if tc.length_normalized_loss else B)
    loss_att = ctc_mod.label_smoothing_loss(
        dec_out, torch.where(tgt_mask, labels, torch.full_like(labels, -1)),
        tc.lsm_weight, model.scfg.vocab_size, -1, tc.length_normalized_loss,
        denom)
    loss_quantity = ((token_num - text_lens.to(torch.float32)).abs().sum()
                     / torch.clamp(gb.total(text_lens.sum()), min=1))
    out = {'loss_decoder': loss_att, 'loss_quantity': loss_quantity}
    total = loss_att + loss_quantity
    if tc.ctc_weight:
        l_ctc = ctc_mod.ctc_loss(model.ctc, enc, mask[:, 0, :].sum(-1),
                                 labels, text_lens, denom=gb.total(B))
        total = total + tc.ctc_weight * l_ctc
        out['loss_ctc'] = l_ctc
    out['loss'] = total
    return out


def _sanm_paraformer_bundle(configs, device, generator, cmvn,
                            state_dict) -> ModelBundle:
    """Ali-Paraformer (reverb_tpu/models/registry.py:
    _sanm_paraformer_bundle): the SANM encoder and decoder, the CIF head
    (and the timestamp branch when the state dict holds it), a CTC head at
    ctc_weight > 0.  The CMVN stats count where their dim is the post-LFR
    one.  The features enter in the config's dtype (f32 by default, as
    JAX's, which has no other)."""
    from reverb_tpu_torch.models.paraformer import SanmParaformer
    scfg, cif = sanm_configs(configs)
    model_conf = configs.get('model_conf', {}) or {}
    tc = SanmTrainConfig(
        ctc_weight=model_conf.get('ctc_weight', 0.0),
        sampling_ratio=model_conf.get('sampling_ratio', 0.75),
        sampler=model_conf.get('sampler', True),
        lsm_weight=model_conf.get('lsm_weight', 0.1),
        length_normalized_loss=model_conf.get('length_normalized_loss',
                                              False),
        compute_dtype=_compute_dtype(configs))
    with_tp = (state_dict is not None
               and 'predictor.tp_output.weight' in state_dict)
    model = _materialise(
        lambda: SanmParaformer(scfg, cif, with_tp, bool(tc.ctc_weight)),
        device, generator, state_dict)
    model.train_cfg = tc
    if cmvn is not None and np.asarray(cmvn[0]).shape[-1] == \
            scfg.input_size:
        model.encoder.set_cmvn(*cmvn)
    _freeze_lstm_second_bias(model)
    return ModelBundle('paraformer', scfg, model, sanm_paraformer_loss)


class ConformerParaformer(ASRModel):
    """The conformer ASRModel (encoder, decoder, CTC, as init_params
    builds them) with a CIF head (`predictor.*`) and its own
    `output_layer` (reverb_tpu/models/registry.py:_paraformer_bundle)."""

    def __init__(self, cfg: ModelConfig, pcfg, with_cmvn: bool):
        super().__init__(cfg, with_cmvn)
        from reverb_tpu_torch.models.modules import Linear
        from reverb_tpu_torch.models.paraformer import Predictor
        self.pcfg = pcfg
        self.predictor = Predictor(pcfg.cif)
        self.output_layer = Linear(pcfg.encoder_output_size,
                                   pcfg.vocab_size)


def conformer_paraformer_loss(model: ConformerParaformer, batch: Dict,
                              generator=None) -> Dict:
    """`paraformer_loss` over the conformer encoder's output, the targets'
    ignore_id turned to 0 first (so every position counts, as in JAX);
    `pred_count` is reported as its batch mean."""
    from reverb_tpu_torch.models.paraformer import paraformer_loss
    cfg = model.cfg
    enc, mask = model.forward_encoder(batch['feats'], batch['feats_lengths'],
                                      None, generator)
    text = batch['target']
    out = paraformer_loss(
        model.predictor, model.output_layer, enc, mask,
        torch.where(text == cfg.ignore_id, torch.zeros_like(text), text),
        batch['target_lengths'], cfg.ignore_id)
    out['pred_count'] = gb.mean(out['pred_count'])
    return out


def _paraformer_bundle(configs, device, generator, cmvn,
                       state_dict) -> ModelBundle:
    from reverb_tpu_torch.models.paraformer import CifConfig, ParaformerConfig
    if configs.get('encoder') == 'sanm_encoder':
        return _sanm_paraformer_bundle(configs, device, generator, cmvn,
                                       state_dict)
    acfg = ModelConfig.from_config(configs)
    pconf = dict(configs.get('paraformer_conf', {}) or {})
    cif_kwargs = _dataclass_kwargs(CifConfig, pconf.pop('cif_conf', {}) or {})
    cif_kwargs['idim'] = acfg.encoder.output_size
    pcfg = ParaformerConfig(
        vocab_size=acfg.vocab_size, cif=CifConfig(**cif_kwargs),
        **_dataclass_kwargs(ParaformerConfig, dict(
            pconf, encoder_output_size=acfg.encoder.output_size)))
    model = _materialise(
        lambda: ConformerParaformer(acfg, pcfg, _has_cmvn(state_dict, cmvn)),
        device, generator, state_dict)
    _fill_cmvn(model, state_dict, cmvn)
    return ModelBundle('paraformer', (acfg, pcfg), model,
                       conformer_paraformer_loss)


# ------------------- k2_model, ctl_model, SSL, whisper -------------------

def _k2_bundle(configs, device, generator, cmvn, state_dict) -> ModelBundle:
    """The asr_model with its CTC term replaced by the LF-MMI loss of
    model_conf.lfmmi_dir (models/k2_model.py); without a lfmmi_dir it is
    the asr_model's loss, as in the JAX package."""
    from reverb_tpu_torch.models.k2_model import (LfmmiResources,
                                                  lfmmi_ctc_loss_fn)
    cfg = ModelConfig.from_config(configs)
    model = build_model(cfg, device, state_dict, generator, train=True,
                        cmvn=cmvn)
    lfmmi_dir = (configs.get('model_conf', {}) or {}).get('lfmmi_dir', '')
    override = (lfmmi_ctc_loss_fn(LfmmiResources(lfmmi_dir, cfg.vocab_size,
                                                 cfg.blank_id))
                if lfmmi_dir else None)

    def loss(model, batch, generator=None):
        return compute_loss(model, batch, generator, norm=gb.norms(batch),
                            ctc_loss_fn=override)

    return ModelBundle('k2_model', cfg, model, loss)


def _ctl_bundle(configs, device, generator, cmvn, state_dict) -> ModelBundle:
    from reverb_tpu_torch.models.ctl import ctl_compute_loss
    cfg = ModelConfig.from_config(configs)
    model = build_model(cfg, device, state_dict, generator, train=True,
                        cmvn=cmvn)
    mc = configs.get('model_conf', {}) or {}
    kwargs = {'ctl_weight': mc.get('ctl_weight', 1.0),
              'temperature': mc.get('logit_temp', mc.get('temperature', 0.1)),
              'n_negatives': mc.get('n_negatives', 0)}

    def loss(model, batch, generator=None):
        return ctl_compute_loss(model, batch, generator, **kwargs)

    return ModelBundle('ctl_model', cfg, model, loss)


def _bestrq_bundle(configs, device, generator, cmvn,
                   state_dict) -> ModelBundle:
    """BEST-RQ over the asr_model's encoder: the features are normalised
    by the encoder's CMVN stats (whose gradient flows through the
    normalisation, as in the JAX package), then encoded without them."""
    from reverb_tpu_torch.models import ssl
    acfg = ModelConfig.from_config(configs)
    stack, stride = ssl.quantizer_window(acfg.encoder.subsampling_rate)
    bcfg = ssl.BestRQConfig(**_dataclass_kwargs(ssl.BestRQConfig, dict(
        {'stack_frames': stack, 'stride': stride},
        **(configs.get('bestrq_conf', {}) or {}),
        input_dim=configs.get('input_dim', 80),
        encoder_output_size=acfg.encoder.output_size)))
    model = _materialise(
        lambda: ssl.BestRQModel(acfg, bcfg, _has_cmvn(state_dict, cmvn)),
        device, generator, state_dict)
    _fill_cmvn(model, state_dict, cmvn)

    def loss(model, batch, generator=None):
        feats = batch['feats']
        if model.encoder.global_cmvn is not None:
            feats = model.encoder.global_cmvn(feats)
        return ssl.bestrq_loss(model, feats, batch['feats_lengths'], bcfg,
                               _seeded(generator, feats.device),
                               **_draws(batch, ssl.BESTRQ_DRAWS))

    return ModelBundle('bestrq', (acfg, bcfg), model, loss)


def _draws(batch, names) -> Dict:
    """The draws a batch carries in place of the generator's (the SSL
    losses' `mask`, `noise`, `span_mask`, ...; a test's injected draws,
    cut to a data rank's rows with the rest of the batch)."""
    return {k: batch[k] for k in names if k in batch}


def _wav2vec2_config(configs, acfg, extra=None):
    from reverb_tpu_torch.models import ssl
    wconf = dict(configs.get('wav2vec2_conf', {}) or {}, **(extra or {}))
    wconf.setdefault('codebook_size', wconf.pop('num_embeddings',
                                                wconf.get('codebook_size',
                                                          320)))
    wconf.setdefault('embedding_dim', acfg.encoder.output_size)
    return wconf, ssl.Wav2vec2Config(**_dataclass_kwargs(
        ssl.Wav2vec2Config,
        dict(wconf, encoder_output_size=acfg.encoder.output_size)))


def _wav2vec2_bundle(configs, device, generator, cmvn,
                     state_dict) -> ModelBundle:
    from reverb_tpu_torch.models import ssl
    acfg = ModelConfig.from_config(configs)
    _, wcfg = _wav2vec2_config(configs, acfg)
    model = _materialise(
        lambda: ssl.Wav2vec2Model(acfg, wcfg, None,
                                  _has_cmvn(state_dict, cmvn)),
        device, generator, state_dict)
    _fill_cmvn(model, state_dict, cmvn)

    def loss(model, batch, generator=None):
        feats = batch['feats']
        return ssl.wav2vec2_loss(model, feats, batch['feats_lengths'], wcfg,
                                 batch.get('steps', 0),
                                 _seeded(generator, feats.device),
                                 **_draws(batch, ssl.WAV2VEC2_DRAWS))

    return ModelBundle('wav2vec2', (acfg, wcfg), model, loss)


def _w2vbert_bundle(configs, device, generator, cmvn,
                    state_dict) -> ModelBundle:
    from reverb_tpu_torch.models import ssl
    acfg = ModelConfig.from_config(configs)
    wconf, wcfg = _wav2vec2_config(configs,
                                   acfg, configs.get('w2vbert_conf'))
    nb = acfg.encoder.num_blocks
    bcfg = ssl.W2VBertConfig(**_dataclass_kwargs(ssl.W2VBertConfig, dict(
        {'contrastive_blocks': nb // 2, 'masked_blocks': nb - nb // 2},
        **wconf)))
    if bcfg.contrastive_blocks + bcfg.masked_blocks != nb:
        raise ValueError(f'w2vbert_conf: contrastive_blocks '
                         f'{bcfg.contrastive_blocks} + masked_blocks '
                         f'{bcfg.masked_blocks} != num_blocks {nb}')
    model = _materialise(
        lambda: ssl.Wav2vec2Model(acfg, wcfg, bcfg,
                                  _has_cmvn(state_dict, cmvn)),
        device, generator, state_dict)
    _fill_cmvn(model, state_dict, cmvn)

    def loss(model, batch, generator=None):
        feats = batch['feats']
        return ssl.w2vbert_loss(model, feats, batch['feats_lengths'], wcfg,
                                bcfg, batch.get('steps', 0),
                                _seeded(generator, feats.device),
                                **_draws(batch, ssl.W2VBERT_DRAWS))

    return ModelBundle('w2vbert', (acfg, wcfg, bcfg), model, loss)


def whisper_loss(model, batch: Dict, generator=None) -> Dict:
    """Whisper's mean token NLL (reverb_tpu/models/registry.py:
    _whisper_bundle): over prebuilt `ys_in`/`ys_out` (the multitask
    prompt of utils/common.py:add_whisper_tokens; -1 pads ys_out), or over
    `target` as its own prompt (tokens[:-1] in, tokens[1:] out, the first
    target_lengths − 1 positions counted).  No dropout."""
    from reverb_tpu_torch.models.whisper import whisper_decode
    feats = model.encoder(batch['feats'])
    if 'ys_in' in batch:
        ys_in, ys_out = batch['ys_in'], batch['ys_out']
        valid = ys_out != -1
    else:
        text, text_lens = batch['target'], batch['target_lengths']
        tokens = torch.where(text == -1, torch.zeros_like(text), text)
        ys_in, ys_out = tokens[:, :-1], tokens[:, 1:]
        valid = (torch.arange(ys_out.shape[1], device=text.device)[None, :]
                 < (text_lens - 1)[:, None])
    logits = whisper_decode(model, ys_in, feats)
    logp = torch.log_softmax(logits.to(torch.float32), -1)
    tgt = torch.where(valid, ys_out, torch.zeros_like(ys_out))
    nll = -torch.gather(logp, -1, tgt[..., None].to(torch.int64))[..., 0]
    total = (torch.where(valid, nll, torch.zeros_like(nll)).sum()
             / torch.clamp(gb.total(valid.sum()), min=1))
    return {'loss': total}


def _whisper_bundle(configs, device, generator, cmvn,
                    state_dict) -> ModelBundle:
    """Whisper on log-mel features without CMVN (models/whisper.py); the
    config's encoder_conf and whisper_conf give WhisperConfig's fields."""
    from reverb_tpu_torch.models.whisper import (Whisper, WhisperConfig,
                                                 whisper_layout)
    wcfg = WhisperConfig(**_dataclass_kwargs(
        WhisperConfig, dict(configs.get('encoder_conf', {}) or {},
                            **(configs.get('whisper_conf', {}) or {}))))
    model = _materialise(lambda: Whisper(wcfg, **whisper_layout(state_dict)),
                         device, generator, state_dict)
    return ModelBundle('whisper', wcfg, model, whisper_loss)


_BUNDLES = {'asr_model': _asr_bundle, 'k2_model': _k2_bundle,
            'transducer': _transducer_bundle,
            'bitransducer': _transducer_bundle,
            'paraformer': _paraformer_bundle, 'ctl_model': _ctl_bundle,
            'bestrq': _bestrq_bundle, 'wav2vec2': _wav2vec2_bundle,
            'w2vbert': _w2vbert_bundle, 'whisper': _whisper_bundle}


def init_model(configs: Dict, generator: Optional[torch.Generator] = None,
               device='cuda', cmvn: Optional[tuple] = None,
               state_dict: Optional[Dict] = None) -> ModelBundle:
    """Registry dispatch (reverb_tpu/models/registry.py:init_model): the
    bundle of the family `model_kind(configs)` names, its model on
    `device` (default cuda; raises without a card), trainable and in
    training mode — from `state_dict` (strict) when given, else randomly
    initialized from `generator` (default: seed 777 on the device, as the
    JAX package's PRNGKey(777)).  `cmvn` = (mean, istd) defaults to the
    config's global CMVN stats: inside the parameters of an asr_model, a
    transducer or the other families over its encoder (unless a state
    dict decides), a constant of an alternative encoder, unused by
    Whisper, as in the JAX package."""
    kind = model_kind(configs)
    dev = resolve_device(device)
    if generator is None and state_dict is None:
        generator = torch.Generator(device=dev).manual_seed(777)
    if cmvn is None:
        from reverb_tpu_torch.frontend.cmvn import load_cmvn_from_configs
        cmvn = load_cmvn_from_configs(configs)
    if kind in ALT_ENCODERS:
        return _alt_encoder_bundle(configs, dev, generator, cmvn, state_dict,
                                   kind)
    return _BUNDLES[kind](configs, dev, generator, cmvn, state_dict)
