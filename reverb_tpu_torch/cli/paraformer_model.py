"""Paraformer serving wrapper, the `transcribe --paraformer` runtime.

Counterpart of reverb_tpu/cli/paraformer_model.py (reference
asr/wenet/cli/paraformer_model.py): load a WeNet-converted Ali-Paraformer
model directory (config.yaml, units.txt, a `.pt` or `.npz` checkpoint,
optional post-LFR CMVN), fbank the audio, run the NAR forward (encoder →
CIF predictor with the inference tail → decoder, and the timestamp
branch), greedy-search with CIF-peak timestamps, and return {text,
confidence[, tokens]}.

The fbank frames are zero-padded to a multiple of `_FEAT_BUCKET` and the
decoder's token buffer holds `_MAX_TOKENS`, as in the JAX package: the
timestamp BiLSTM and the CIF conv read the padded tail, so other paddings
would give other times and token counts.  The model runs on `device`
(default cuda; raises without a card), in f32.  Under a torch profiler a
`transcribe` shows its encoder, CIF loop, decoder (with the tp branch)
and the tp peaks' loop with the greedy search as the spans
`paraformer.encoder`, `.cif`, `.decoder` and `.search`
(utils/profiling.py:span).
"""

from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np
import torch

from reverb_tpu_torch.frontend.audio import load_for_asr
from reverb_tpu_torch.frontend.fbank import (FbankConfig, compute_fbank,
                                             num_frames)
from reverb_tpu_torch.utils.profiling import span

# the decoder's token buffer; ~20 tokens/s of speech headroom
_MAX_TOKENS = 512
_FEAT_BUCKET = 512   # fbank frames round up to a multiple of this


def build_sanm_paraformer(scfg, cif_cfg, state_dict, device):
    """A SanmParaformer on `device` from a state dict (strict), in eval
    mode without gradients; the timestamp branch and the CTC head where
    the state dict holds them."""
    from reverb_tpu_torch.models.paraformer import SanmParaformer
    with torch.device('meta'):
        model = SanmParaformer(
            scfg, cif_cfg, 'predictor.tp_output.weight' in state_dict,
            any(k.startswith('ctc.') for k in state_dict))
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.LSTM):
            m.flatten_parameters()
    return model.eval().requires_grad_(False)


class Paraformer:

    def __init__(self, model_dir: str, gpu: int = -1,
                 resample_rate: int = 16000, device='cuda') -> None:
        del gpu  # the reference's argument; the device is `device`
        from reverb_tpu_torch.convert import (load_paraformer_flat,
                                              state_dict_from_jax)
        from reverb_tpu_torch.models.registry import sanm_configs
        from reverb_tpu_torch.text.paraformer_tokenizer import \
            ParaformerTokenizer
        from reverb_tpu_torch.utils.common import resolve_device
        from reverb_tpu_torch.utils.config import load_config

        model_dir = Path(model_dir)
        self.device = resolve_device(device)
        self.configs = load_config(model_dir / 'config.yaml')
        self.tokenizer = ParaformerTokenizer(
            symbol_table=str(model_dir / 'units.txt'))
        self.configs.setdefault('output_dim',
                                len(self.tokenizer.symbol_table))
        self.scfg, self.cif_cfg = sanm_configs(self.configs)
        ckpt = self._find_checkpoint(model_dir)
        self.model = build_sanm_paraformer(
            self.scfg, self.cif_cfg,
            state_dict_from_jax(load_paraformer_flat(str(ckpt))),
            self.device)
        cmvn = self._load_cmvn(model_dir)
        if cmvn is not None:
            self.model.encoder.set_cmvn(*cmvn)
        self.resample_rate = resample_rate
        self.fbank = FbankConfig(sample_rate=resample_rate)
        # 10 ms mel frames → LFR n → ×upsample_times tp frames
        self.tp_frame_rate = (0.01 * self.scfg.lfr_n
                              / self.cif_cfg.upsample_times)

    @staticmethod
    def _find_checkpoint(model_dir: Path) -> Path:
        p = model_dir / 'final.pt'
        if p.exists():
            return p
        for pat in ('*.npz', '*.pt'):
            hits = sorted(model_dir.glob(pat))
            if hits:
                return hits[0]
        raise FileNotFoundError(f'no checkpoint (*.pt/*.npz) in {model_dir}')

    def _load_cmvn(self, model_dir: Path):
        """The config's CMVN file (kaldi format unless is_json_cmvn), or
        None where it is absent or not over the post-LFR dim."""
        cm = self.configs.get('cmvn_conf', {}) or {}
        cmvn_file = cm.get('cmvn_file')
        if cmvn_file and not os.path.isabs(cmvn_file):
            cmvn_file = str(model_dir / Path(cmvn_file).name)
        if not cmvn_file or not os.path.exists(cmvn_file):
            return None
        from reverb_tpu_torch.frontend.cmvn import load_cmvn
        mean, istd = load_cmvn(cmvn_file, cm.get('is_json_cmvn', False))
        if np.asarray(mean).shape[-1] != self.scfg.input_size:
            return None
        return mean, istd

    def transcribe(self, audio_file: str, tokens_info: bool = False) -> dict:
        from reverb_tpu_torch.decode.paraformer_search import (
            gen_timestamps_from_peak, paraformer_beautify_result,
            paraformer_greedy_search)
        from reverb_tpu_torch.models.paraformer import cif_peaks_from_tp

        wave = load_for_asr(audio_file, self.resample_rate)
        T = num_frames(len(wave), self.fbank)
        with torch.inference_mode():
            feats = compute_fbank(torch.from_numpy(wave).to(self.device),
                                  self.fbank, n_frames=T)
            Tb = max(math.ceil(T / _FEAT_BUCKET), 1) * _FEAT_BUCKET
            feats = torch.nn.functional.pad(feats, (0, 0, 0, Tb - T))[None]
            lens = torch.tensor([T], dtype=torch.int32, device=self.device)
            logp, out_lens, tp_alphas = self.model.forward_paraformer(
                feats, lens, _MAX_TOKENS)
            with span('paraformer.search'):
                peaks = cif_peaks_from_tp(tp_alphas, out_lens,
                                          self.cif_cfg.threshold)
                res = paraformer_greedy_search(logp, out_lens,
                                               cif_peaks=peaks)[0]
        tokens = self.tokenizer.ids2tokens(res.tokens)
        result = {'confidence': res.confidence,
                  'text': paraformer_beautify_result(tokens)}
        if tokens_info:
            # valid tp frames: ⌈T/lfr_n⌉ encoder frames × upsample_times
            n_tp = (-(-T // self.scfg.lfr_n)) * self.cif_cfg.upsample_times
            times = gen_timestamps_from_peak(res.times,
                                             num_frames=max(n_tp, 1),
                                             frame_rate=self.tp_frame_rate)
            result['tokens'] = [
                {'token': tok, 'start': round(t[0], 3),
                 'end': round(t[1], 3), 'confidence': conf}
                for tok, t, conf in zip(tokens, times,
                                        res.tokens_confidence)]
        return result

    def align(self, audio_file: str, label: str) -> dict:
        raise NotImplementedError('Align is currently not supported')


def load_model(model_dir: str = None, gpu: int = -1,
               device='cuda') -> Paraformer:
    """A local Paraformer model directory; None (the hub route) raises:
    downloading is not supported."""
    if model_dir is None:
        raise ValueError('a Paraformer model directory is required: the hub '
                         'route downloads, which is not supported')
    return Paraformer(model_dir, gpu, device=device)
