"""Kaldi-compatible log-mel filterbank on the device.

Counterpart of reverb_tpu/frontend/fbank.py (`FbankConfig`, `num_frames`,
`_povey_window`, `mel_banks`, `compute_fbank`): framing → DC removal →
preemphasis → povey window → rFFT(512) → power → mel → log, with
torchaudio.compliance.kaldi.fbank's definition (snip_edges, no dither,
Nyquist bin dropped).  The window and mel matrix are built on the host in
numpy exactly as the JAX package builds them; the rest runs as torch ops
on the waveform's device, for one waveform (`compute_fbank`) or a batch
of rows (`compute_fbank_batch`, the diarization crops).  The data
pipeline's host path is `fbank_numpy` / `mfcc_numpy` (the JAX package's
numpy functions, copied).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: offset from Nyquist
    use_power: bool = True
    # torchaudio's EPSILON (float32 eps) floors the mel energies
    epsilon: float = float(np.finfo(np.float32).eps)

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def padded_window_size(self) -> int:
        n = 1
        while n < self.window_size:
            n *= 2
        return n


def num_frames(num_samples: int, cfg: FbankConfig = FbankConfig()) -> int:
    """Frame count with snip_edges=True."""
    if num_samples < cfg.window_size:
        return 0
    return 1 + (num_samples - cfg.window_size) // cfg.window_shift


def _povey_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))) ** 0.85).astype(
        np.float32)


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=8)
def mel_banks(cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """(num_bins, padded_window_size//2) triangular mel weights (Nyquist bin
    excluded)."""
    num_fft_bins = cfg.padded_window_size // 2
    nyquist = 0.5 * cfg.sample_rate
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low = _mel_scale(cfg.low_freq)
    mel_high = _mel_scale(high_freq)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    fft_freqs = (np.arange(num_fft_bins, dtype=np.float64)
                 * cfg.sample_rate / cfg.padded_window_size)
    mel = _mel_scale(fft_freqs)[None, :]
    b = np.arange(cfg.num_mel_bins, dtype=np.float64)[:, None]
    left = mel_low + b * delta
    center = mel_low + (b + 1) * delta
    right = mel_low + (b + 2) * delta
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def compute_fbank(wave: torch.Tensor, cfg: FbankConfig = FbankConfig(),
                  n_frames: int | None = None) -> torch.Tensor:
    """Log-mel fbank of a 1-D int16-scale waveform → (n_frames, M) f32 on
    the waveform's device."""
    if n_frames is None:
        n_frames = num_frames(wave.shape[0], cfg)
    return compute_fbank_batch(wave[None], cfg, n_frames)[0]


def compute_fbank_batch(waves: torch.Tensor, cfg: FbankConfig,
                        n_frames: int) -> torch.Tensor:
    """Log-mel fbank of each row of (B, S) int16-scale waveforms → (B,
    n_frames, M) f32 on their device: the batch the JAX package takes with
    `vmap(compute_fbank)` (reverb_tpu/diar/pipeline.py:_fbank_from_wave).
    Rows shorter than the frames need are zero-padded."""
    waves = waves.to(torch.float32)
    dev = waves.device
    B = waves.shape[0]
    size, shift = cfg.window_size, cfg.window_shift
    if n_frames == 0:
        return torch.zeros((B, 0, cfg.num_mel_bins), dtype=torch.float32,
                           device=dev)
    need = (n_frames - 1) * shift + size
    if waves.shape[1] < need:
        waves = torch.nn.functional.pad(waves, (0, need - waves.shape[1]))
    # (B·T, W): one row per frame, each transformed alone
    frames = waves.unfold(1, size, shift)[:, :n_frames].reshape(-1, size)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=1, keepdim=True)
    if cfg.preemphasis != 0.0:
        first = frames[:, :1] - cfg.preemphasis * frames[:, :1]
        rest = frames[:, 1:] - cfg.preemphasis * frames[:, :-1]
        frames = torch.cat([first, rest], dim=1)
    window = torch.from_numpy(_povey_window(size)).to(dev)
    frames = frames * window[None, :]
    pad = cfg.padded_window_size - size
    if pad > 0:
        frames = torch.nn.functional.pad(frames, (0, pad))
    # the transform runs in float64: low-energy bins lose ~1e-3 in the log
    # domain to an f32 rFFT on 30 s inputs (the kaldi goldens' bar)
    spec = torch.fft.rfft(frames.to(torch.float64), dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :cfg.padded_window_size // 2]
    power = power.to(torch.float32)
    if not cfg.use_power:
        power = torch.sqrt(power)
    banks = torch.from_numpy(mel_banks(cfg)).to(dev)
    mel = power @ banks.T
    return torch.log(torch.clamp(mel, min=cfg.epsilon)).reshape(
        B, n_frames, cfg.num_mel_bins)


# --- the host numpy path of the data pipeline (data/processor.py) ---------

@functools.lru_cache(maxsize=8)
def dct_matrix(num_ceps: int, num_mel_bins: int) -> np.ndarray:
    """(num_mel_bins, num_ceps) kaldi DCT-II basis: ortho-normalized rows,
    C0 row = sqrt(1/N) (kaldi ComputeDctMatrix)."""
    n = np.arange(num_mel_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / num_mel_bins * (n[None, :] + 0.5) * k)  # (C, M)
    dct *= np.sqrt(2.0 / num_mel_bins)
    dct[0, :] = np.sqrt(1.0 / num_mel_bins)
    return dct.T.astype(np.float32)                              # (M, C)


@functools.lru_cache(maxsize=8)
def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Cepstral liftering 1 + (Q/2)·sin(πi/Q) (kaldi ComputeLifterCoeffs)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(np.pi * i / q)).astype(np.float32)


def mfcc_numpy(wave: np.ndarray, cfg: FbankConfig = FbankConfig(),
               num_ceps: int = 13, cepstral_lifter: float = 22.0
               ) -> np.ndarray:
    """Kaldi MFCC on the host (use_energy=False): log-mel fbank → DCT-II →
    cepstral liftering."""
    assert num_ceps <= cfg.num_mel_bins, (num_ceps, cfg.num_mel_bins)
    feat = fbank_numpy(wave, cfg) @ dct_matrix(num_ceps, cfg.num_mel_bins)
    if cepstral_lifter != 0.0:
        feat = feat * lifter_coeffs(num_ceps, cepstral_lifter)[None, :]
    return feat.astype(np.float32)


def fbank_numpy(wave: np.ndarray, cfg: FbankConfig = FbankConfig()
                ) -> np.ndarray:
    """The fbank of `compute_fbank` in numpy on the host (f32 rFFT), as
    reverb_tpu/frontend/fbank.py:fbank_numpy computes it, bit for bit."""
    T = num_frames(len(wave), cfg)
    if T == 0:
        return np.zeros((0, cfg.num_mel_bins), dtype=np.float32)
    wave = wave.astype(np.float32)
    shift, size = cfg.window_shift, cfg.window_size
    idx = np.arange(T)[:, None] * shift + np.arange(size)[None, :]
    frames = wave[idx]
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis:
        out = frames.copy()
        out[:, 0] -= cfg.preemphasis * frames[:, 0]
        out[:, 1:] -= cfg.preemphasis * frames[:, :-1]
        frames = out
    frames = frames * _povey_window(size)[None, :]
    padded = np.zeros((T, cfg.padded_window_size), dtype=np.float32)
    padded[:, :size] = frames
    spec = np.fft.rfft(padded, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : cfg.padded_window_size // 2]
    if not cfg.use_power:
        power = np.sqrt(power)
    mel = power @ mel_banks(cfg).T
    return np.log(np.maximum(mel, cfg.epsilon)).astype(np.float32)
