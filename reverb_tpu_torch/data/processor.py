"""Per-sample transforms for the input pipeline (numpy, on the host): the
port's copy of reverb_tpu/data/processor.py, on the port's own
frontend/audio.py and the numpy fbank of frontend/fbank.py.

Parity targets (asr/wenet/dataset/processor.py):
  - decode_wav (:179-211, start/end sub-segments)
  - resample (:294-314), speed_perturb (:316-340, sox `speed` ≙ playback-rate
    resample)
  - compute_fbank (:343-371, wave·(1<<15), kaldi fbank)
  - compute_log_mel_spectrogram (:419-458, whisper-style)
  - tokenize (:461-475), filter (:510-556)
  - spec_aug (:559-593), spec_sub (:596-622), spec_trim (:625-644)
  - detect_language/detect_task (:95-117) — config-driven (no langid dep)
  - padding (:681-754), DynamicBatchWindow (:757-773)

Samples are dicts: {key, wav (np float32 [-1,1] (C,T) or raw bytes), txt,
sample_rate, ...} → feat (T,80 np.float32) → padded batch dict of np arrays.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from reverb_tpu_torch import native
from reverb_tpu_torch.data.pipeline import mystats
from reverb_tpu_torch.frontend.audio import (_parse_wav,
                                             resample as _resample_fn)
from reverb_tpu_torch.frontend.fbank import (FbankConfig, fbank_numpy,
                                             mfcc_numpy)


def decode_wav(sample: Dict) -> Dict:
    """Decode wav bytes/path → float32 (C, T) in [-1, 1) + sample_rate.
    Supports start/end sub-segment fields (processor.py:179-211).  Bytes
    go through the native C++ decoder (reverb_tpu_torch.native) where it
    builds, else through the numpy parser, as in the JAX package."""
    wav = sample['wav']
    if isinstance(wav, (bytes, bytearray)):
        decoded = None
        try:
            decoded = native.decode_wav(bytes(wav))
        except ValueError:
            decoded = None
        data, sr = decoded if decoded is not None else _parse_wav(bytes(wav))
    elif isinstance(wav, str):
        from reverb_tpu_torch.frontend.audio import load_audio
        data, sr = load_audio(wav)
    else:
        data = np.asarray(wav, dtype=np.float32)
        if data.ndim == 1:
            data = data[:, None]
        sr = sample.get('sample_rate', 16000)
    if 'start' in sample:
        start = int(float(sample['start']) * sr)
        end = int(float(sample.get('end', data.shape[0] / sr)) * sr)
        data = data[start:end]
    sample['wav'] = data.T.astype(np.float32)   # (C, T) torch-layout
    sample['sample_rate'] = sr
    return sample


def resample(sample: Dict, resample_rate: int = 16000) -> Dict:
    if sample['sample_rate'] != resample_rate:
        sample['wav'] = _resample_fn(sample['wav'].T,
                                     sample['sample_rate'],
                                     resample_rate).T
        sample['sample_rate'] = resample_rate
    return sample


def speed_perturb(sample: Dict, speeds=None) -> Dict:
    """sox `speed s` = play the signal s× faster (pitch+tempo): resample the
    waveform by factor 1/s at fixed sample rate."""
    speeds = speeds or [0.9, 1.0, 1.1]
    speed = random.choice(speeds)
    if speed != 1.0:
        wav = sample['wav']
        up, down = 1000, int(1000 * speed)
        sample['wav'] = _resample_fn(wav.T, down, up).T
    return sample


def compute_fbank(sample: Dict, num_mel_bins: int = 23,
                  frame_length: float = 25, frame_shift: float = 10,
                  dither: float = 0.0) -> Dict:
    cfg = FbankConfig(sample_rate=sample['sample_rate'],
                      num_mel_bins=num_mel_bins,
                      frame_length_ms=frame_length,
                      frame_shift_ms=frame_shift)
    wave = sample['wav'][0] * (1 << 15)
    if dither > 0:
        wave = wave + dither * np.random.randn(len(wave)).astype(np.float32)
    feat = None
    if os.environ.get('REVERB_TPU_NATIVE_FBANK', '') not in ('', '0'):
        # the C++ frame loop (the numpy path's batched FFT is the faster
        # default in the JAX package's measurements); the numpy path where
        # the library does not build
        feat = native.fbank(wave, cfg.sample_rate, cfg.num_mel_bins,
                            cfg.frame_length_ms, cfg.frame_shift_ms)
    sample['feat'] = feat if feat is not None else fbank_numpy(wave, cfg)
    return sample


def compute_mfcc(sample: Dict, num_mel_bins: int = 23,
                 frame_length: float = 25, frame_shift: float = 10,
                 dither: float = 0.0, num_ceps: int = 40,
                 high_freq: float = 0.0, low_freq: float = 20.0) -> Dict:
    """MFCC features (processor.py:385-416): kaldi.mfcc on the 1<<15-scaled
    waveform.  Same arg surface as the reference; num_ceps is clamped to
    num_mel_bins (kaldi requires num_ceps <= num_mel_bins)."""
    cfg = FbankConfig(sample_rate=sample['sample_rate'],
                      num_mel_bins=num_mel_bins,
                      frame_length_ms=frame_length,
                      frame_shift_ms=frame_shift,
                      low_freq=low_freq, high_freq=high_freq)
    wave = sample['wav'][0] * (1 << 15)
    if dither > 0:
        wave = wave + dither * np.random.randn(len(wave)).astype(np.float32)
    sample['feat'] = mfcc_numpy(wave, cfg,
                                num_ceps=min(num_ceps, num_mel_bins))
    return sample


def compute_log_mel_spectrogram(sample: Dict, n_fft: int = 400,
                                hop_length: int = 160, num_mel_bins: int = 80,
                                padding: int = 0) -> Dict:
    """Whisper-style log-mel (processor.py:419-458): reflect-pad STFT, HTK mel,
    log10, clamp to max-8, /4 +1 normalization."""
    wave = sample['wav'][0].astype(np.float32)
    if padding > 0:
        wave = np.pad(wave, (0, padding))
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(wave) - n_fft) // hop_length if len(wave) >= n_fft \
        else 0
    wave = np.pad(wave, (n_fft // 2, n_fft // 2), mode='reflect')
    n_frames = 1 + (len(wave) - n_fft) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :])
    frames = wave[idx] * window
    spec = np.abs(np.fft.rfft(frames, axis=1)[:, :-1]) ** 2   # drop last frame
    mel = _htk_mel_banks(num_mel_bins, n_fft, sample['sample_rate'])
    melspec = np.maximum(spec[:-1] @ mel.T, 1e-10)
    logspec = np.log10(melspec)
    logspec = np.maximum(logspec, logspec.max() - 8.0)
    sample['feat'] = ((logspec + 4.0) / 4.0).astype(np.float32)
    return sample


def _htk_mel_banks(n_mels, n_fft, sr):
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    fmax = sr / 2
    mels = np.linspace(hz_to_mel(0), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)[:-1]
    lower = (fft_freqs[None, :] - freqs[:-2, None]) / \
        (freqs[1:-1, None] - freqs[:-2, None])
    upper = (freqs[2:, None] - fft_freqs[None, :]) / \
        (freqs[2:, None] - freqs[1:-1, None])
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (freqs[2:] - freqs[:-2])
    return (weights * enorm[:, None]).astype(np.float32)


def tokenize(sample: Dict, tokenizer) -> Dict:
    tokens, ids = tokenizer.tokenize(sample['txt'])
    sample['tokens'] = tokens
    sample['label'] = ids
    return sample


def filter(sample: Dict, max_length: float = 10240, min_length: float = 10,
           token_max_length: int = 200, token_min_length: int = 1,
           min_output_input_ratio: float = 0.0005,
           max_output_input_ratio: float = 1) -> bool:
    num_frames = sample['wav'].shape[1] / sample['sample_rate'] * 100
    if num_frames < min_length or num_frames > max_length:
        mystats['filter_length'] += 1
        return False
    if 'label' in sample:
        n = len(sample['label'])
        if n < token_min_length or n > token_max_length:
            mystats['filter_tokens'] += 1
            return False
        if num_frames != 0:
            r = n / num_frames
            if r < min_output_input_ratio or r > max_output_input_ratio:
                mystats['filter_ratio'] += 1
                return False
    return True


def spec_aug(sample: Dict, num_t_mask: int = 2, num_f_mask: int = 2,
             max_t: int = 50, max_f: int = 10, max_w: int = 80) -> Dict:
    y = sample['feat'].copy()
    T, F = y.shape
    for _ in range(num_t_mask):
        start = random.randint(0, T - 1)
        y[start:start + random.randint(1, max_t), :] = 0
    for _ in range(num_f_mask):
        start = random.randint(0, F - 1)
        y[:, start:start + random.randint(1, max_f)] = 0
    sample['feat'] = y
    return sample


def spec_sub(sample: Dict, max_t: int = 20, num_t_sub: int = 3) -> Dict:
    x = sample['feat']
    y = x.copy()
    T = y.shape[0]
    for _ in range(num_t_sub):
        start = random.randint(0, T - 1)
        end = min(T, start + random.randint(1, max_t))
        pos = random.randint(0, start)
        y[start:end, :] = x[start - pos:end - pos, :]
    sample['feat'] = y
    return sample


def spec_trim(sample: Dict, max_t: int = 20) -> Dict:
    x = sample['feat']
    T = x.shape[0]
    length = random.randint(1, max_t)
    if length < T / 2:
        sample['feat'] = x[:T - length].copy()
    return sample


def detect_language(sample: Dict, limited_langs=None) -> Dict:
    """Language id from the sample TEXT (processor.py:95-105: the reference
    runs the langid package's classifier restricted to limited_langs).
    Hermetic classifier in text/langid.py (script vote + function-word
    profiles); an existing 'lang' tag wins, and empty/undecidable text
    falls back to the first limited lang / 'en' (Rev's untagged-is-English
    policy, rev_processor.py:77-80)."""
    if 'lang' not in sample:
        from reverb_tpu_torch.text.langid import classify
        sample['lang'] = classify(sample.get('txt', ''), limited_langs)[0]
    return sample


def detect_task(sample: Dict) -> Dict:
    sample.setdefault('task', 'transcribe')
    return sample


def sort_by_feats(sample: Dict):
    return sample['feat'].shape[0]


def feats_length_fn(sample: Dict) -> int:
    return sample['feat'].shape[0]


class DynamicBatchWindow:
    """True when the incoming sample would overflow max_frames_in_batch
    (processor.py:757-773); resets its high-water mark when it fires."""

    def __init__(self, max_frames_in_batch: int = 12000):
        self.longest_frames = 0
        self.max_frames_in_batch = max_frames_in_batch

    def __call__(self, sample, buffer_size: int) -> bool:
        new_frames = sample['feat'].shape[0]
        self.longest_frames = max(self.longest_frames, new_frames)
        if self.longest_frames * (buffer_size + 1) > self.max_frames_in_batch:
            self.longest_frames = new_frames
            return True
        return False


def _pad_stack(arrays: List[np.ndarray], pad_value=0, pad_to: int = 0):
    maxlen = max(a.shape[0] for a in arrays)
    if pad_to:
        maxlen = -(-maxlen // pad_to) * pad_to
    out = np.full((len(arrays), maxlen) + arrays[0].shape[1:], pad_value,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


def padding(data: List[Dict], pass_cat_emb: bool = False,
            deep_biasing_conf=None, pad_len_multiple: int = 0) -> Dict:
    """Batch assembly (processor.py:681-754): sort by feat length desc, pad
    feats with 0 / labels with -1, carry keys/pcm/langs/tasks/cat_embs.

    `pad_len_multiple`: round padded lengths up to a multiple, so the
    device sees a small set of shapes instead of one per batch.  Samples
    with context phrases (data/deep_bias.py) add the batch's bias terms
    as `cv_list` (N, Lc) padded with 0 and `cv_list_lengths` (N,)."""
    order = np.argsort([-x['feat'].shape[0] for x in data], kind='stable')
    data = [data[i] for i in order]
    feats = [x['feat'] for x in data]
    labels = [np.asarray(x.get('label', []), dtype=np.int64) for x in data]
    wavs = [x['wav'][0] for x in data]
    batch = {
        'keys': [x['key'] for x in data],
        'feats': _pad_stack(feats, 0.0, pad_len_multiple),
        'target': _pad_stack(labels, -1, pad_len_multiple),
        'feats_lengths': np.asarray([f.shape[0] for f in feats], np.int32),
        'target_lengths': np.asarray([len(l) for l in labels], np.int32),
        'pcm': _pad_stack(wavs, 0.0),
        'pcm_length': np.asarray([len(w) for w in wavs], np.int32),
        'langs': [x.get('lang', 'en') for x in data],
        'tasks': [x.get('task', 'transcribe') for x in data],
    }
    if pass_cat_emb:
        batch['cat_embs'] = np.stack(
            [np.asarray(x['cat_emb'], np.float32) for x in data])
    if 'speaker' in data[0]:
        batch['speaker'] = np.asarray([x['speaker'] for x in data], np.int32)
    if 'cv_list' in data[0]:
        from reverb_tpu_torch.data.deep_bias import batch_cv_list
        terms = batch_cv_list(data, deep_biasing_conf or {})
        batch['cv_list'] = _pad_stack(
            [np.asarray(t, np.int64) for t in terms], 0)
        batch['cv_list_lengths'] = np.asarray([len(t) for t in terms],
                                              np.int32)
    return batch
