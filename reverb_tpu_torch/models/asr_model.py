"""ASRModel: hybrid CTC/attention conformer — config, construction, encoder,
training loss.

Counterpart of reverb_tpu/models/asr_model.py (`ModelConfig.from_config`,
`forward_encoder`, `filter_blank_embedding`, init, `compute_loss`,
`loss_from_encoder`, `forward_attention_decoder`).  The model is
an `nn.Module` whose state-dict keys are WeNet's (`encoder.*`,
`decoder.left_decoder.*`, `ctc.ctc_lo.*`; a deep-biasing model's
`context_adaptor.*` as the JAX tree's), so a reverb checkpoint loads into
it by name (convert.py).  It is built on the
meta device and then either filled from a state dict or initialized from an
explicit `torch.Generator` on its target device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from reverb_tpu_torch.convert import tree_key
from reverb_tpu_torch.models import ctc as ctc_mod
from reverb_tpu_torch.models.context_adaptor import (ContextAdaptor,
                                                     ContextAdaptorConfig)
from reverb_tpu_torch.models.ctc import CTC
from reverb_tpu_torch.models.decoder import DecoderConfig, build_decoder
from reverb_tpu_torch.models.encoder import ConformerEncoder, EncoderConfig
from reverb_tpu_torch.models.modules import reset_parameters
from reverb_tpu_torch.ops import quant
from reverb_tpu_torch.utils.common import (IGNORE_ID, add_sos_eos,
                                           reverse_sequence, th_accuracy)


# Keys the JAX package's EncoderConfig / DecoderConfig read that the port's
# configs do not hold (reverb_tpu/models/{encoder,decoder}.py).  Each one is
# handled by `_check_jax_only_keys`: refused where the port would build
# another model, and accepted where it only tunes a refused feature.  Any
# other unknown key is dropped, as the JAX package drops it.
_JAX_ONLY_ENCODER_KEYS = ('positionwise_layer_type', 'n_expert',
                          'n_expert_per_token', 'pipeline_stages',
                          'pipeline_microbatches')
_JAX_ONLY_DECODER_KEYS = ('tie_word_embedding',)


def _check_jax_only_keys(enc_conf: Dict):
    """Raise for the encoder options the port cannot build: a MoE
    feed-forward (ROADMAP item 15) or a GPipe pipeline (item 14)."""
    if (enc_conf.get('positionwise_layer_type',
                     'position_wise_feed_forward') == 'moe'
            or (enc_conf.get('n_expert') or 0) > 0):
        raise NotImplementedError(
            'encoder_conf positionwise_layer_type: moe / n_expert (a MoE '
            'feed-forward) is not ported: ROADMAP item 15')
    if (enc_conf.get('pipeline_stages') or 0) > 1:
        raise NotImplementedError(
            f"encoder_conf pipeline_stages: {enc_conf['pipeline_stages']} "
            f"(GPipe) is not ported: ROADMAP item 14")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    encoder: EncoderConfig
    decoder: DecoderConfig
    ctc_weight: float = 0.5
    reverse_weight: float = 0.0
    lsm_weight: float = 0.0
    length_normalized_loss: bool = False
    ignore_id: int = IGNORE_ID
    blank_id: int = 0
    sos: int = -1
    eos: int = -1
    lsl_enc: bool = False
    lsl_dec: bool = False
    apply_non_blank_embedding: bool = False
    focal_ctc: bool = False
    focal_alpha: float = 0.5
    focal_gamma: float = 2.0
    compute_dtype: torch.dtype = torch.float32
    # the lexicon constraint of joint decoding: lexicon lines 'word sw1 sw2
    # ...' and token lines 'token id' (decode/joint.py:load_lexicon)
    lexicon_path: Optional[str] = None
    token_path: Optional[str] = None
    # a context adaptor (deep biasing) beside the encoder: set by
    # dataset_conf.deep_bias_conf.deep_biasing, as reverb_tpu's registry
    # decides (reverb_tpu/models/registry.py:_asr_bundle)
    context_adaptor: bool = False

    @staticmethod
    def from_config(configs: Dict) -> 'ModelConfig':
        """Build from a reference-schema config.yaml dict, as
        reverb_tpu.models.asr_model.ModelConfig.from_config does."""
        vocab_size = configs.get('output_dim') or configs['vocab_size']
        enc_conf = dict(configs.get('encoder_conf', {}))
        input_dim = configs.get('input_dim', 80)
        num_langs = enc_conf.pop('num_langs', 0)
        ds_conf = configs.get('dataset_conf', {}) or {}
        cat_conf = ds_conf.get('cat_emb_conf', {}) or {}
        if ds_conf.get('pass_cat_emb') and not num_langs:
            num_langs = int(cat_conf.get('emb_len', 2))
        enc_type = configs.get('encoder', 'conformer')
        if enc_type in ('lsl_conformer', 'language_specific_conformer') \
                and not num_langs:
            num_langs = int(enc_conf.get('num_langs', 3) or 3)
        _check_jax_only_keys(enc_conf)
        enc_fields = {f.name for f in dataclasses.fields(EncoderConfig)}
        encoder = EncoderConfig(
            input_size=input_dim,
            encoder_type=('conformer' if 'conformer' in enc_type
                          else 'transformer'),
            num_langs=num_langs,
            **{k: v for k, v in enc_conf.items() if k in enc_fields})

        dtype = str(configs.get('dtype', 'fp32')).lower()
        compute_dtype = torch.bfloat16 if dtype in (
            'bf16', 'bfloat16', 'fp16', 'float16') else torch.float32

        dec_type = configs.get('decoder', 'bitransformer')
        dec_conf = dict(configs.get('decoder_conf', {}))
        dec_fields = {f.name for f in dataclasses.fields(DecoderConfig)}
        dec_num_langs = (num_langs if 'lsl' in dec_type
                         or 'language' in dec_type
                         else dec_conf.pop('num_langs', 0))
        dec_kwargs = {k: v for k, v in dec_conf.items() if k in dec_fields}
        dec_kwargs.setdefault('compute_dtype', compute_dtype)
        decoder = DecoderConfig(
            vocab_size=vocab_size, encoder_output_size=encoder.output_size,
            decoder_type=('bitransformer' if 'bitransformer' in dec_type
                          else 'transformer'),
            num_langs=dec_num_langs, **dec_kwargs)

        model_conf = configs.get('model_conf', {}) or {}
        special = (configs.get('tokenizer_conf', {}) or {}).get(
            'special_tokens') or model_conf.get('special_tokens')
        sos = eos = vocab_size - 1
        if special:
            sos = special.get('<sos>', sos)
            eos = special.get('<eos>', eos)
        focal = configs.get('focal_ctc', {}) or {}
        return ModelConfig(
            vocab_size=vocab_size, encoder=encoder, decoder=decoder,
            ctc_weight=model_conf.get('ctc_weight', 0.5),
            reverse_weight=model_conf.get('reverse_weight', 0.0),
            lsm_weight=model_conf.get('lsm_weight', 0.0),
            length_normalized_loss=model_conf.get('length_normalized_loss',
                                                  False),
            focal_ctc=bool(focal.get('enabled', False)),
            focal_alpha=focal.get('alpha', 0.5),
            focal_gamma=focal.get('gamma', 2.0),
            blank_id=(configs.get('ctc_conf', {}) or {}).get('ctc_blank_id',
                                                              0),
            sos=sos, eos=eos, lsl_enc=num_langs > 0,
            lsl_dec=dec_num_langs > 0,
            apply_non_blank_embedding=model_conf.get(
                'apply_non_blank_embedding', False),
            compute_dtype=compute_dtype,
            lexicon_path=model_conf.get('lexicon_path'),
            token_path=model_conf.get('token_path'),
            context_adaptor=bool((ds_conf.get('deep_bias_conf') or {})
                                 .get('deep_biasing', False)))

    def with_compute_dtype(self, dtype: torch.dtype) -> 'ModelConfig':
        """Set the activation dtype of the encoder input and the decoder."""
        return dataclasses.replace(
            self, compute_dtype=dtype,
            decoder=dataclasses.replace(self.decoder, compute_dtype=dtype))


class ASRModel(nn.Module):
    """Conformer encoder + bitransformer decoder + CTC head, and a context
    adaptor when the config asks for deep biasing."""

    def __init__(self, cfg: ModelConfig, with_cmvn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg.encoder, with_cmvn)
        self.decoder = build_decoder(cfg.decoder)
        self.ctc = CTC(cfg.vocab_size, cfg.encoder.output_size)
        self.context_adaptor = (ContextAdaptor(ContextAdaptorConfig(
            vocab_size=cfg.vocab_size, output_size=cfg.encoder.output_size))
            if cfg.context_adaptor else None)

    def forward_encoder(self, feats, feats_lens, cat_embs=None,
                        generator=None, decoding_chunk_size: int = -1,
                        num_decoding_left_chunks: int = -1,
                        chunk_generator=None, return_layers: bool = False):
        """(B,T,F) features → (encoder_out (B,T',D), masks (B,1,T'));
        dropout when a generator is given; the chunk arguments as
        reverb_tpu/models/asr_model.py:forward_encoder passes them on
        (`chunk_generator`, `return_layers`: ConformerEncoder.forward)."""
        feats = feats.to(self.cfg.compute_dtype)
        return self.encoder(feats, feats_lens,
                            cat_embs if self.cfg.lsl_enc else None, generator,
                            decoding_chunk_size, num_decoding_left_chunks,
                            chunk_generator, return_layers)


def filter_blank_embedding(cfg: ModelConfig, ctc_probs, encoder_out,
                           encoder_mask):
    """Keep only the encoder frames whose CTC argmax is non-blank, moved to
    the front in order (a stable compaction), the rest zeroed: returns
    (encoder_out (B, T, D), mask (B, 1, T)) with the kept counts as the
    new lengths."""
    T = encoder_out.shape[1]
    keep = (torch.argmax(ctc_probs, dim=-1) != cfg.blank_id) \
        & encoder_mask[:, 0, :].to(torch.bool)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    new_out = torch.gather(encoder_out, 1, order[:, :, None].expand(
        -1, -1, encoder_out.shape[2]))
    new_mask = (torch.arange(T, device=keep.device)[None, :]
                < keep.sum(1)[:, None])
    new_out = torch.where(new_mask[:, :, None], new_out,
                          torch.zeros((), dtype=new_out.dtype,
                                      device=new_out.device))
    return new_out, new_mask[:, None, :]


def forward_attention_decoder(model: ASRModel, hyps_pad, hyps_lens,
                              encoder_out, reverse_weight: float = 0.0,
                              cat_embs=None, encoder_lens=None):
    """Batched rescoring decoder pass over one utterance
    (reverb_tpu/models/asr_model.py:forward_attention_decoder): hyps_pad
    (N, L) sos-prefixed and eos-padded, hyps_lens (N,) counting sos,
    encoder_out (1, T, D) shared by the N rows, encoder_lens (a 0-d or
    (1,) count of valid frames, or None for all T).  Returns (log-softmax
    l_x (N, L, V) f32, r_x (N, L, V): the right decoder's, or zeros when
    reverse_weight is 0)."""
    cfg = model.cfg
    N = hyps_pad.shape[0]
    T = encoder_out.shape[1]
    dev = encoder_out.device
    if encoder_lens is None:
        enc_mask = torch.ones((1, 1, T), dtype=torch.bool, device=dev)
    else:
        enc_mask = (torch.arange(T, device=dev)
                    < encoder_lens.reshape(()))[None, None]
    r_body = reverse_sequence(hyps_pad[:, 1:], hyps_lens - 1, cfg.eos)
    r_hyps = torch.cat([hyps_pad[:, :1], r_body], 1)
    l_x, r_x = model.decoder(encoder_out, enc_mask, hyps_pad, hyps_lens,
                             r_hyps, reverse_weight,
                             cat_embs if cfg.lsl_dec else None, mem_group=N)
    l_x = torch.log_softmax(l_x.to(torch.float32), -1)
    if r_x is not None:
        r_x = torch.log_softmax(r_x.to(torch.float32), -1)
    else:
        r_x = torch.zeros_like(l_x)
    return l_x, r_x


def compute_loss(model: ASRModel, batch: Dict, generator=None,
                 chunk_generator=None) -> Dict:
    """Training loss (reverb_tpu/models/asr_model.py:compute_loss).

    batch: feats (B,T,F), feats_lengths (B,), target (B,L) padded with
    ignore_id, target_lengths (B,), optional cat_embs (B, num_langs), and
    for a model with a context adaptor optional cv_list (N, Lc) with
    cv_list_lengths (N,): the adaptor's bias is added to the encoder output.
    `generator` plays the part of the JAX rng: dropout runs only with one,
    and a use_dynamic_chunk encoder draws its chunk from it, or from
    `chunk_generator` when that is given (evaluation: a chunk, no dropout).
    Returns {loss, loss_att, loss_ctc, th_accuracy} (None where a weight
    switches a term off)."""
    use_adaptor = model.context_adaptor is not None and 'cv_list' in batch
    out = model.forward_encoder(
        batch['feats'], batch['feats_lengths'], batch.get('cat_embs'),
        generator, decoding_chunk_size=0, chunk_generator=chunk_generator,
        return_layers=use_adaptor)
    encoder_out, encoder_mask = out[0], out[1]
    if use_adaptor:
        ca = model.context_adaptor
        cv_emb = ca.encode_cv(batch['cv_list'], batch['cv_list_lengths'])
        encoder_out = encoder_out + ca(out[2], cv_emb)
    return loss_from_encoder(model, encoder_out, encoder_mask, batch,
                             generator)


def loss_from_encoder(model: ASRModel, encoder_out, encoder_mask,
                      batch: Dict, generator=None) -> Dict:
    """The post-encoder half of `compute_loss`: CTC and the label-smoothed
    attention loss of both decoder directions, mixed by ctc_weight and
    reverse_weight; with apply_non_blank_embedding the decoders see only
    the frames whose CTC argmax is not blank."""
    cfg = model.cfg
    cat_embs = batch.get('cat_embs')
    encoder_out_lens = encoder_mask[:, 0, :].sum(-1)
    text, text_lens = batch['target'], batch['target_lengths']
    loss_ctc = None
    if cfg.ctc_weight != 0.0:
        loss_ctc = ctc_mod.ctc_loss(
            model.ctc, encoder_out, encoder_out_lens,
            torch.where(text == cfg.ignore_id, torch.zeros_like(text), text),
            text_lens, cfg.blank_id, cfg.focal_ctc, cfg.focal_alpha,
            cfg.focal_gamma)
    if cfg.apply_non_blank_embedding:
        # the decoder attends to the frames whose CTC argmax is not blank
        # (reverb_tpu/models/asr_model.py:443-447); the gradient flows
        # through the gather
        encoder_out, encoder_mask = filter_blank_embedding(
            cfg, ctc_mod.ctc_logprobs(model.ctc, encoder_out), encoder_out,
            encoder_mask)
    loss_att = acc_att = None
    if cfg.ctc_weight != 1.0:
        ys_in, ys_out = add_sos_eos(text, text_lens, cfg.sos, cfg.eos,
                                    cfg.ignore_id)
        r_text = reverse_sequence(text, text_lens, cfg.ignore_id)
        r_ys_in, r_ys_out = add_sos_eos(r_text, text_lens, cfg.sos, cfg.eos,
                                        cfg.ignore_id)
        l_x, r_x = model.decoder(encoder_out, encoder_mask, ys_in,
                                 text_lens + 1, r_ys_in, cfg.reverse_weight,
                                 cat_embs if cfg.lsl_dec else None,
                                 generator=generator)
        loss_att = ctc_mod.label_smoothing_loss(
            l_x, ys_out, cfg.lsm_weight, cfg.vocab_size, cfg.ignore_id,
            cfg.length_normalized_loss)
        if r_x is not None:
            r_loss = ctc_mod.label_smoothing_loss(
                r_x, r_ys_out, cfg.lsm_weight, cfg.vocab_size, cfg.ignore_id,
                cfg.length_normalized_loss)
            loss_att = (loss_att * (1 - cfg.reverse_weight)
                        + r_loss * cfg.reverse_weight)
        acc_att = th_accuracy(l_x, ys_out, cfg.ignore_id)
    if loss_ctc is None:
        loss = loss_att
    elif loss_att is None:
        loss = loss_ctc
    else:
        loss = cfg.ctc_weight * loss_ctc + (1 - cfg.ctc_weight) * loss_att
    return {'loss': loss, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
            'th_accuracy': acc_att}


def build_model(cfg: ModelConfig, device, state_dict: Optional[dict] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, cmvn=None) -> ASRModel:
    """Build an ASRModel on `device`: from `state_dict` (strict; the encoder
    gets global CMVN when the state dict carries it) when given, else
    randomly initialized from `generator` (a generator on `device`), with
    the global CMVN stats `cmvn` = (mean, istd) inside the parameters when
    given (as reverb_tpu's init_params(..., cmvn=)).  Serving models come
    back in eval mode with gradients off; `train=True` gives a trainable
    model in training mode.  A state dict of `quant.quantize_params_int8`
    (or of a JAX-quantized tree) builds each layer that holds `weight_q8`
    in its int8 form: attention q/k/v/out/pos, the FFNs, the decoders with
    their output layers and the subsampling convs, where the JAX package
    quantizes."""
    if state_dict is not None:
        with_cmvn = 'encoder.global_cmvn.mean' in state_dict
    else:
        with_cmvn = cmvn is not None
    with torch.device('meta'):
        model = ASRModel(cfg, with_cmvn)
        if state_dict is not None:
            _int8_modules(model, state_dict)
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        if generator is None:
            raise ValueError('build_model needs a state_dict or a generator')
        reset_parameters(model, generator)
        if cmvn is not None:
            with torch.no_grad():
                for t, v in zip((model.encoder.global_cmvn.mean,
                                 model.encoder.global_cmvn.istd), cmvn):
                    t.copy_(torch.as_tensor(np.asarray(v, np.float32)))
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


def _int8_modules(model: ASRModel, state_dict):
    """Switch the layers whose `weight_q8` the state dict holds to their
    int8 form (models/modules.py:_Int8Form), each with its JAX path."""
    for name, m in model.named_modules():
        if f'{name}.weight_q8' in state_dict:
            if not hasattr(m, 'to_int8'):
                raise ValueError(f'{name}: no int8 form for '
                                 f'{type(m).__name__}')
            m.to_int8(tree_key(name), f'{name}.a_scale' in state_dict)


def quantize_model_int8(model: ASRModel) -> ASRModel:
    """Serving PTQ of a built model (reverb_tpu/cli/reverb.py:100-104):
    `quant.quantize_params_int8` of its state dict, on the model's device,
    then the model rebuilt from it in eval mode."""
    device = next(model.parameters()).device
    return build_model(model.cfg, device,
                       quant.quantize_params_int8(model.state_dict()))
