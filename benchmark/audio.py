"""Synthetic speech-like audio and Whisper's log-mel, made from the seed.

`speech_like` is noise and harmonic bursts under a slowly varying envelope
(100 ms steps, pitch changing every 200 ms), int16-scale, made on the
device.  `whisper_log_mel` is OpenAI Whisper's log_mel_spectrogram
(n_fft 400, hop 160, Hann window, Slaney mel filters, log10, clamped to
8 below the maximum, (x + 4) / 4).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SR = 16000


def speech_like(n_samples: int, seed: int, device) -> torch.Tensor:
    """(n_samples,) int16 speech-like audio from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    t = torch.arange(n_samples, device=device, dtype=torch.float64) / SR
    env = torch.rand(n_samples // 1600 + 1, generator=g, device=device,
                     dtype=torch.float64).repeat_interleave(1600)[:n_samples]
    f0 = (90 + 160 * torch.rand(n_samples // 3200 + 1, generator=g,
                                device=device, dtype=torch.float64)
          ).repeat_interleave(3200)[:n_samples]
    noise = torch.randn(n_samples, generator=g, device=device,
                        dtype=torch.float64)
    x = (torch.sin(2 * np.pi * f0 * t) + 0.5 * torch.sin(4 * np.pi * f0 * t)
         + 0.3 * noise) * env * 6000
    return torch.clamp(x, -32768, 32767).to(torch.int16)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mel = 3.0 * f / 200.0
    lin = f >= 1000.0
    return np.where(lin, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                               * (m - 15.0)), f)


@functools.lru_cache(maxsize=4)
def slaney_mel_filters(n_mels: int, n_fft: int = 400) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft, n_mels) (htk=False, norm
    'slaney'): (n_mels, n_fft // 2 + 1)."""
    fft_f = np.linspace(0, SR / 2, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def whisper_log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, S) float audio in [-1, 1] → (B, frames, n_mels) log-mel, frames
    = S // 160 (the last STFT frame dropped, as Whisper does)."""
    window = torch.hann_window(400, device=audio.device)
    stft = torch.stft(audio, 400, 160, window=window, return_complex=True)
    mag = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(slaney_mel_filters(n_mels)).to(audio.device)
    mel = filters @ mag
    log = torch.clamp(mel, min=1e-10).log10()
    log = torch.maximum(log, log.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log + 4.0) / 4.0).transpose(1, 2).contiguous()
