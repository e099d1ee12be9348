"""ctypes bindings of the host audio runtime (`native/reverb_native.cpp`):
WAV decoding, resampling and the kaldi fbank in C++.

Counterpart of reverb_tpu/native/__init__.py (`get_lib`, `decode_wav`,
`resample`, `fbank`).  The first call builds the repository's
`native/reverb_native.cpp` with `g++` into `reverb_tpu_torch/_build/`
(keyed by a hash of the source and flags; the source's directory is not
written to), under a file lock, since several processes may build at
once.  These are host routines, not device kernels: as in the JAX
package, when no toolchain builds the library each entry point returns
None and its caller takes its numpy path (data/processor.py); the log
says which path ran.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / 'native' / 'reverb_native.cpp'
_OUT = Path(__file__).resolve().parents[1] / '_build'
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + ' '.join(_FLAGS).encode())
    return _OUT / f'libreverb_native_{h.hexdigest()[:16]}.so'


def _build(lib: Path) -> bool:
    """g++ the source into `lib` (a temporary name, then renamed) under a
    file lock; False when the toolchain fails."""
    _OUT.mkdir(parents=True, exist_ok=True)
    with open(_OUT / 'native.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return True
            tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
            try:
                subprocess.run(['g++', *_FLAGS, str(_SRC), '-o', str(tmp)],
                               check=True, capture_output=True)
            except (OSError, subprocess.CalledProcessError) as e:
                logging.warning('reverb_native: the g++ build failed (%r); '
                                'the host audio takes its numpy path', e)
                tmp.unlink(missing_ok=True)
                return False
            os.replace(tmp, lib)
            return True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot be
    built (then every entry point returns None)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rn_decode_wav.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32p,
                                      i64p, i32p, i32p]
        lib.rn_decode_wav.restype = ctypes.c_int
        lib.rn_resample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32, f32p, i64p]
        lib.rn_resample.restype = ctypes.c_int
        lib.rn_fbank.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_float,
                                 ctypes.c_float, f32p, i64p]
        lib.rn_fbank.restype = ctypes.c_int
        logging.info('reverb_native: the host audio runs %s', path.name)
        _lib = lib
        return _lib


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_wav(data: bytes):
    """WAV bytes → (float32 (T, C) in [-1, 1), sample_rate); None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    n, ch, sr = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.rn_decode_wav(data, len(data), None, ctypes.byref(n),
                           ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f'rn_decode_wav failed rc={rc}')
    out = np.empty((n.value, ch.value), np.float32)
    rc = lib.rn_decode_wav(data, len(data), _fp(out), ctypes.byref(n),
                           ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f'rn_decode_wav failed rc={rc}')
    return out, int(sr.value)


def resample(x: np.ndarray, sr_in: int, sr_out: int):
    """1-D float32 x at sr_in → sr_out; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n_out = ctypes.c_int64()
    lib.rn_resample(_fp(x), len(x), sr_in, sr_out, None,
                    ctypes.byref(n_out))
    out = np.empty((n_out.value,), np.float32)
    rc = lib.rn_resample(_fp(x), len(x), sr_in, sr_out, _fp(out),
                         ctypes.byref(n_out))
    if rc != 0:
        raise ValueError(f'rn_resample failed rc={rc}')
    return out


def fbank(wave: np.ndarray, sample_rate: int = 16000, num_bins: int = 80,
          frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0):
    """int16-scale float32 waveform → (T, num_bins) log-mel; None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    wave = np.ascontiguousarray(wave, np.float32)
    nf = ctypes.c_int64()
    lib.rn_fbank(_fp(wave), len(wave), sample_rate, num_bins,
                 frame_length_ms, frame_shift_ms, None, ctypes.byref(nf))
    out = np.empty((nf.value, num_bins), np.float32)
    rc = lib.rn_fbank(_fp(wave), len(wave), sample_rate, num_bins,
                      frame_length_ms, frame_shift_ms, _fp(out),
                      ctypes.byref(nf))
    if rc != 0:
        raise ValueError(f'rn_fbank failed rc={rc}')
    return out
