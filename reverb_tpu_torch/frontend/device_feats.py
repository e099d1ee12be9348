"""The training frontend inside the step: fbank, dither and SpecAugment on
the device.

Counterpart of reverb_tpu/frontend/device_feats.py (`FrontendSpec`,
`frontend_from_configs`, `apply_frontend`).  With `dataset_conf:
{device_feats: true}` the host pipeline only decodes, resamples and pads
the audio: its samples carry a zero-width `feat` of (n_frames, 0), so the
sort, filter and batch stages still see frame counts, and `padding` ships
the padded waveforms as `pcm` (data/dataset.py, data/processor.py).  The
train and eval steps (train/trainer.py) call `apply_frontend` on the
device batch, which replaces the zero-width `feats` with the fbank of
`pcm` (frontend/fbank.py:compute_fbank_batch), dithered and SpecAugmented
from the step's generator when training, deterministic without one (CV).

SpecAugment's draws are taken apart from the masking (`draw_spec_aug`,
`apply_spec_aug`), so the masks of given draws can be compared with the
JAX package's.  Per sample: num_t_mask time masks, start uniform in
[0, length) and width uniform in [1, max_t]; num_f_mask mel masks, start
uniform in [0, M) and width uniform in [1, max_f].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from reverb_tpu_torch.frontend.fbank import (FbankConfig, compute_fbank_batch,
                                             num_frames)


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    fbank: FbankConfig
    dither: float = 0.0
    num_t_mask: int = 0
    num_f_mask: int = 0
    max_t: int = 50
    max_f: int = 10


def frontend_from_configs(configs: Dict) -> Optional[FrontendSpec]:
    """A FrontendSpec when `dataset_conf.device_feats` is set, else None.
    spec_sub and spec_trim have no device formulation and raise with it.
    SpecAugment is on unless `spec_aug: false`, as on the host path; the
    fbank's rate is the configured resample rate (default 16000), which
    every waveform has after the resample stage."""
    ds_conf = configs.get('dataset_conf', {}) or {}
    if not ds_conf.get('device_feats', False):
        return None
    if ds_conf.get('spec_sub') or ds_conf.get('spec_trim'):
        raise ValueError('device_feats supports spec_aug only; '
                         'spec_sub/spec_trim run on host features')
    fb = ds_conf.get('fbank_conf', {}) or {}
    aug_on = bool(ds_conf.get('spec_aug', True))
    aug = ds_conf.get('spec_aug_conf', {}) or {}
    rs = ds_conf.get('resample_conf', {}) or {}
    return FrontendSpec(
        fbank=FbankConfig(sample_rate=int(rs.get('resample_rate', 16000)),
                          num_mel_bins=fb.get('num_mel_bins', 80),
                          frame_length_ms=fb.get('frame_length', 25),
                          frame_shift_ms=fb.get('frame_shift', 10)),
        dither=float(fb.get('dither', 0.0)),
        num_t_mask=int(aug.get('num_t_mask', 2)) if aug_on else 0,
        num_f_mask=int(aug.get('num_f_mask', 2)) if aug_on else 0,
        max_t=int(aug.get('max_t', 50)),
        max_f=int(aug.get('max_f', 10)))


def draw_spec_aug(lengths: torch.Tensor, n_mel: int, spec: FrontendSpec,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """SpecAugment's draws for a batch of `lengths` (B,) frames: {t_start,
    t_width (B, num_t_mask), f_start, f_width (B, num_f_mask)} int64 on
    the lengths' device."""
    dev = lengths.device
    B = lengths.shape[0]
    hi = torch.clamp(lengths.to(torch.int64), min=1)[:, None]
    nt, nf = spec.num_t_mask, spec.num_f_mask
    t_start = (torch.rand((B, nt), generator=generator, device=dev,
                          dtype=torch.float64) * hi).to(torch.int64)
    t_width = torch.randint(1, spec.max_t + 1, (B, nt), generator=generator,
                            device=dev)
    f_start = torch.randint(0, n_mel, (B, nf), generator=generator,
                            device=dev)
    f_width = torch.randint(1, spec.max_f + 1, (B, nf), generator=generator,
                            device=dev)
    return {'t_start': t_start, 't_width': t_width, 'f_start': f_start,
            'f_width': f_width}


def spec_aug_masks(draws: Dict[str, torch.Tensor], T: int, M: int):
    """(time mask (B, T), mel mask (B, M)) bool, True where zeroed."""
    dev = draws['t_start'].device
    t = torch.arange(T, device=dev)[None, :, None]
    f = torch.arange(M, device=dev)[None, :, None]
    ts, tw = draws['t_start'][:, None], draws['t_width'][:, None]
    fs, fw = draws['f_start'][:, None], draws['f_width'][:, None]
    return (((t >= ts) & (t < ts + tw)).any(-1),
            ((f >= fs) & (f < fs + fw)).any(-1))


def apply_spec_aug(feats: torch.Tensor, draws: Dict[str, torch.Tensor]):
    """feats (B, T, M) with the masks of `draws` zeroed."""
    t_mask, f_mask = spec_aug_masks(draws, feats.shape[1], feats.shape[2])
    zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
    return torch.where(t_mask[:, :, None] | f_mask[:, None, :], zero, feats)


def apply_frontend(batch: Dict, spec: FrontendSpec,
                   generator: Optional[torch.Generator] = None) -> Dict:
    """Replace a zero-width `feats` (B, T, 0) with the fbank of `pcm` (B,
    S) in [-1, 1), cut or zero-padded to the batch's T frames; with a
    generator, dither and SpecAugment drawn from it; frames past each
    `feats_lengths` zeroed (the host path pads with zeros, and the fbank
    of padding is not zero).  A batch with features is returned as is."""
    if 'feats' in batch and batch['feats'].shape[-1] != 0:
        return batch
    wav = batch['pcm'].to(torch.float32) * 32768.0
    if generator is not None and spec.dither > 0:
        wav = wav + spec.dither * torch.randn(
            wav.shape, generator=generator, device=wav.device)
    feats = compute_fbank_batch(wav, spec.fbank,
                                num_frames(wav.shape[1], spec.fbank))
    T = batch['feats'].shape[1] if 'feats' in batch else feats.shape[1]
    if feats.shape[1] >= T:
        feats = feats[:, :T]
    else:
        feats = torch.nn.functional.pad(feats,
                                        (0, 0, 0, T - feats.shape[1]))
    lengths = batch['feats_lengths'].to(feats.device)
    if generator is not None and (spec.num_t_mask or spec.num_f_mask):
        feats = apply_spec_aug(feats, draw_spec_aug(
            lengths, feats.shape[2], spec, generator))
    valid = (torch.arange(T, device=feats.device)[None, :]
             < lengths[:, None])[:, :, None]
    feats = torch.where(valid, feats, torch.zeros((), device=feats.device))
    return dict(batch, feats=feats)
