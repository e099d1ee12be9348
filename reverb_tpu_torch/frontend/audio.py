"""Host-side audio IO: WAV decode, other containers through ffmpeg, and
resampling (numpy, no device work).

Counterpart of reverb_tpu/frontend/audio.py (`_parse_wav`,
`_ffmpeg_decode`, `load_audio`, `to_mono`, `resample`, `load_for_asr`).
The JAX package's `frontend/__init__` imports jax, so these are carried
over here rather than imported.  A `.wav` file is parsed here; any other file is decoded by an
external `ffmpeg` binary to mono f32 at the target rate.  Waveforms come
back from `load_for_asr` as int16-scale float32, ready for
`frontend.fbank.compute_fbank`, and from `load_audio` in [-1, 1).
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess

import numpy as np


class AudioDecodeError(RuntimeError):
    pass


def _parse_wav(data: bytes):
    """Minimal RIFF/WAVE parser: PCM 8/16/24/32-bit and float32, any channel
    count.  Returns (x (T, C) float32 in [-1, 1), sample_rate)."""
    if len(data) < 44 or data[:4] != b'RIFF' or data[8:12] != b'WAVE':
        raise AudioDecodeError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack('<I', data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b'fmt ':
            fmt = struct.unpack('<HHIIHH', body[:16])
        elif chunk_id == b'data':
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise AudioDecodeError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:      # WAVE_FORMAT_EXTENSIBLE: PCM subtype
        audio_format = 1
    if audio_format == 1:
        if bits == 16:
            x = np.frombuffer(raw, dtype='<i2').astype(np.float32) / (1 << 15)
        elif bits == 32:
            x = np.frombuffer(raw, dtype='<i4').astype(np.float32) / (1 << 31)
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128) / 128
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = np.where(x >= (1 << 23), x - (1 << 24), x).astype(np.float32)
            x /= (1 << 23)
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:
        x = np.frombuffer(raw, dtype='<f4').astype(np.float32)
    else:
        raise AudioDecodeError(f"unsupported WAV format code {audio_format}")
    return x.reshape(-1, max(channels, 1)), sample_rate


def _ffmpeg_decode(path: str, rate: int):
    """Decode any container ffmpeg reads → (x (T, 1) float32 at `rate`,
    rate).  The reference's command line with `-ar rate` added: it omits
    the rate and then takes the samples to be 16 kHz whatever the file's
    rate."""
    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        raise AudioDecodeError(
            f"cannot decode {path!r}: not a WAV and no ffmpeg binary available")
    cmd = [ffmpeg, '-v', 'error', '-i', path, '-f', 'f32le', '-acodec',
           'pcm_f32le', '-ar', str(rate), '-ac', '1', 'pipe:1']
    out = subprocess.run(cmd, capture_output=True, check=False)
    if out.returncode != 0:
        raise AudioDecodeError(out.stderr.decode(errors='replace'))
    return np.frombuffer(out.stdout, dtype='<f4').reshape(-1, 1), rate


def load_audio(path: str, start: float | None = None,
               end: float | None = None, rate: int = 16000):
    """Read an audio file → (x (T, C) float32 in [-1, 1), sample_rate),
    optionally cut to [start, end) seconds (reverb_tpu/frontend/audio.py:
    load_audio).  A non-WAV file is decoded by ffmpeg at `rate` (the JAX
    package omits the rate there, see `_ffmpeg_decode`)."""
    if os.path.splitext(path)[1].lower() == '.wav':
        with open(path, 'rb') as f:
            x, sr = _parse_wav(f.read())
    else:
        x, sr = _ffmpeg_decode(path, rate)
    if start is not None or end is not None:
        s = int((start or 0) * sr)
        e = int(end * sr) if end is not None else x.shape[0]
        x = x[s:e]
    return x, sr


def to_mono(x: np.ndarray) -> np.ndarray:
    """Channel 0 of (T, C) → (T,); a 1-D x as it is (kaldi's fbank reads
    waveform[0], as reverb_tpu/frontend/audio.py:to_mono)."""
    return x[:, 0] if x.ndim == 2 else x


def resample(x: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    """Polyphase resampling (scipy), as reverb_tpu.frontend.audio.resample."""
    if orig_rate == new_rate:
        return x
    from scipy import signal
    g = np.gcd(int(orig_rate), int(new_rate))
    up, down = new_rate // g, orig_rate // g
    return signal.resample_poly(x, up, down, axis=0).astype(np.float32)


def load_for_asr(path: str, resample_rate: int = 16000) -> np.ndarray:
    """Read an audio file → channel 0, resampled, int16-scale float32 (T,).
    ffmpeg resamples what it decodes itself, so the rate it returns is the
    rate of the samples."""
    if os.path.splitext(path)[1].lower() == '.wav':
        with open(path, 'rb') as f:
            x, sr = _parse_wav(f.read())
    else:
        x, sr = _ffmpeg_decode(path, resample_rate)
    x = x[:, 0]
    if sr != resample_rate:
        x = resample(x, sr, resample_rate)
    return (x * (1 << 15)).astype(np.float32)
