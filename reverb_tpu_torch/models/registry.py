"""Model registry: config-driven model construction, the `init_model` API.

Counterpart of reverb_tpu/models/registry.py (`ModelBundle`,
`_hybrid_loss`, `_alt_encoder_bundle`, `_asr_bundle`,
`_transducer_bundle`, `init_model`): a dispatch on configs['model'] and,
for `asr_model`, configs['encoder'], so a model family is reachable from
a config alone:

  model: asr_model (default) | transducer | bitransducer
  encoder: conformer | branchformer | e_branchformer | squeezeformer |
           efficient_conformer  (asr_model families)

Each entry returns a `ModelBundle` — (kind, cfg, model, loss_fn) — with a
uniform `loss_fn(model, batch, generator=None) → {'loss': ..., ...}`, so
the trainer is model-agnostic; dropout draws from `generator` (none
without one, as rng=None in JAX).  The JAX package's other families
(k2_model, paraformer, ctl_model, bestrq, wav2vec2, w2vbert, whisper)
raise NotImplementedError naming ROADMAP item 15; an unknown name raises
ValueError, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from reverb_tpu_torch.models import ctc as ctc_mod
from reverb_tpu_torch.models import encoders_alt as alt
from reverb_tpu_torch.models.asr_model import (ModelConfig, build_model,
                                               compute_loss)
from reverb_tpu_torch.models.ctc import CTC
from reverb_tpu_torch.models.decoder import DecoderConfig, build_decoder
from reverb_tpu_torch.models.modules import reset_parameters
from reverb_tpu_torch.models.transducer import (TransducerConfig,
                                                TransducerModel,
                                                transducer_loss)
from reverb_tpu_torch.utils.common import (add_sos_eos, resolve_device,
                                           reverse_sequence, th_accuracy)

PORTED = ('asr_model', 'transducer', 'bitransducer')
UNPORTED = ('k2_model', 'paraformer', 'ctl_model', 'bestrq', 'wav2vec2',
            'w2vbert', 'whisper')
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


def model_kind(configs: Dict) -> str:
    """The family `init_model` builds for `configs`: an alternative
    encoder's name for an asr_model with one, else configs['model'].
    Raises NotImplementedError for a family the port lacks, ValueError for
    an unknown one."""
    kind = configs.get('model', 'asr_model')
    if kind == 'asr_model' and configs.get('encoder') in ALT_ENCODERS:
        return configs['encoder']
    if kind in UNPORTED:
        raise NotImplementedError(
            f'model {kind!r} is not ported yet (ROADMAP item 15); the port '
            f'builds {PORTED} and the asr_model encoders {ALT_ENCODERS}')
    if kind not in PORTED:
        raise ValueError(f'unknown model type {kind!r}; choose from '
                         f'{sorted(PORTED + UNPORTED)}')
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
    loss_ctc = loss_att = acc = None
    if mcfg.ctc_weight != 0.0:
        loss_ctc = ctc_mod.ctc_loss(
            model.ctc, enc, enc_lens,
            torch.where(text == mcfg.ignore_id, torch.zeros_like(text),
                        text), text_lens, mcfg.blank_id)
    if mcfg.ctc_weight != 1.0:
        ys_in, ys_out = add_sos_eos(text, text_lens, mcfg.sos, mcfg.eos,
                                    mcfg.ignore_id)
        # the JAX loss reads only the left decoder's output
        l_x, _ = model.decoder(enc, mask, ys_in, text_lens + 1, None, 0.0,
                               generator=generator)
        loss_att = ctc_mod.label_smoothing_loss(
            l_x, ys_out, mcfg.lsm_weight, mcfg.vocab_size, mcfg.ignore_id,
            mcfg.length_normalized_loss)
        acc = th_accuracy(l_x, ys_out, mcfg.ignore_id)
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
    dtype = str(configs.get('dtype', 'fp32')).lower()
    compute_dtype = torch.bfloat16 if dtype in (
        'bf16', 'bfloat16', 'fp16', 'float16') else torch.float32
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
        return compute_loss(model, batch, generator)

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
                              acfg.blank_id) if w['ctc'] else 0.0)
    return {'loss': w['t'] * l_rnnt + w['ctc'] * l_ctc, 'loss_rnnt': l_rnnt,
            'loss_ctc': l_ctc}


def _transducer_bundle(configs, device, generator, cmvn,
                       state_dict) -> ModelBundle:
    acfg = ModelConfig.from_config(configs)
    tcfg = transducer_config(configs, acfg)
    model_conf = configs.get('model_conf', {}) or {}
    bi = (configs.get('model') == 'bitransducer'
          or bool(model_conf.get('use_bitransducer')))
    with_cmvn = ('encoder.global_cmvn.mean' in state_dict
                 if state_dict is not None else cmvn is not None)
    weights = {'t': model_conf.get('transducer_weight', 0.75),
               'ctc': model_conf.get('ctc_weight', 0.25),
               'r': model_conf.get('bitransducer_r_weight', 0.3)}
    model = _materialise(
        lambda: TransducerModel(acfg, tcfg, bi, with_cmvn, weights), device,
        generator, state_dict)
    if state_dict is None and cmvn is not None:
        with torch.no_grad():
            for t, v in zip((model.encoder.global_cmvn.mean,
                             model.encoder.global_cmvn.istd), cmvn):
                t.copy_(torch.as_tensor(np.asarray(v, np.float32)))
    _freeze_lstm_second_bias(model)
    return ModelBundle('bitransducer' if bi else 'transducer', (acfg, tcfg),
                       model, transducer_loss_fn)


def init_model(configs: Dict, generator: Optional[torch.Generator] = None,
               device='cuda', cmvn: Optional[tuple] = None,
               state_dict: Optional[Dict] = None) -> ModelBundle:
    """Registry dispatch (reverb_tpu/models/registry.py:init_model): the
    bundle of the family `model_kind(configs)` names, its model on
    `device` (default cuda; raises without a card), trainable and in
    training mode — from `state_dict` (strict) when given, else randomly
    initialized from `generator` (default: seed 777 on the device, as the
    JAX package's PRNGKey(777)).  `cmvn` = (mean, istd) defaults to the
    config's global CMVN stats: inside the parameters of an asr_model or
    a transducer (unless a state dict decides), a constant of an
    alternative encoder, as in the JAX package."""
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
    if kind == 'asr_model':
        return _asr_bundle(configs, dev, generator, cmvn, state_dict)
    return _transducer_bundle(configs, dev, generator, cmvn, state_dict)
