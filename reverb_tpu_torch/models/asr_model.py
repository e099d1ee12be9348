"""ASRModel: hybrid CTC/attention conformer — config, construction, encoder.

Counterpart of reverb_tpu/models/asr_model.py (`ModelConfig.from_config`,
`forward_encoder`, init).  The model is an `nn.Module` whose state-dict keys
are WeNet's (`encoder.*`, `decoder.left_decoder.*`, `ctc.ctc_lo.*`), so a
reverb checkpoint loads into it by name (convert.py).  It is built on the
meta device and then either filled from a state dict or initialized from an
explicit `torch.Generator` on its target device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from reverb_tpu_torch.models.ctc import CTC
from reverb_tpu_torch.models.decoder import DecoderConfig, build_decoder
from reverb_tpu_torch.models.encoder import ConformerEncoder, EncoderConfig
from reverb_tpu_torch.models.modules import reset_parameters


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    encoder: EncoderConfig
    decoder: DecoderConfig
    blank_id: int = 0
    sos: int = -1
    eos: int = -1
    lsl_enc: bool = False
    lsl_dec: bool = False
    apply_non_blank_embedding: bool = False
    compute_dtype: torch.dtype = torch.float32

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
        return ModelConfig(
            vocab_size=vocab_size, encoder=encoder, decoder=decoder,
            blank_id=(configs.get('ctc_conf', {}) or {}).get('ctc_blank_id',
                                                              0),
            sos=sos, eos=eos, lsl_enc=num_langs > 0,
            lsl_dec=dec_num_langs > 0,
            apply_non_blank_embedding=model_conf.get(
                'apply_non_blank_embedding', False),
            compute_dtype=compute_dtype)

    def with_compute_dtype(self, dtype: torch.dtype) -> 'ModelConfig':
        """Set the activation dtype of the encoder input and the decoder."""
        return dataclasses.replace(
            self, compute_dtype=dtype,
            decoder=dataclasses.replace(self.decoder, compute_dtype=dtype))


class ASRModel(nn.Module):
    """Conformer encoder + bitransformer decoder + CTC head."""

    def __init__(self, cfg: ModelConfig, with_cmvn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg.encoder, with_cmvn)
        self.decoder = build_decoder(cfg.decoder)
        self.ctc = CTC(cfg.vocab_size, cfg.encoder.output_size)

    def forward_encoder(self, feats, feats_lens, cat_embs=None):
        """(B,T,F) features → (encoder_out (B,T',D), masks (B,1,T'))."""
        feats = feats.to(self.cfg.compute_dtype)
        return self.encoder(feats, feats_lens,
                            cat_embs if self.cfg.lsl_enc else None)


def build_model(cfg: ModelConfig, device, state_dict: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> ASRModel:
    """Build an ASRModel on `device`: from `state_dict` (strict; the encoder
    gets global CMVN when the state dict carries it) when given, else
    randomly initialized from `generator` (a generator on `device`)."""
    with_cmvn = state_dict is not None and \
        'encoder.global_cmvn.mean' in state_dict
    with torch.device('meta'):
        model = ASRModel(cfg, with_cmvn)
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        if generator is None:
            raise ValueError('build_model needs a state_dict or a generator')
        reset_parameters(model, generator)
    return model.eval().requires_grad_(False)
