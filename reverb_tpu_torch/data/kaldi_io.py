"""Kaldi ark/scp IO (pure python/numpy): the port's copy of
reverb_tpu/data/kaldi_io.py; each package reads the other's files.

Parity: asr/wenet/dataset/kaldi_io.py capability — read/write Kaldi binary
matrices/vectors (FM/DM/FV/DV), scp indirection, text-format fallback.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np


def _read_token(f) -> str:
    tok = b''
    while True:
        c = f.read(1)
        if not c or c == b' ':
            break
        tok += c
    return tok.decode()


def _size_marker(f):
    if f.read(1) != b'\x04':
        raise ValueError('malformed kaldi binary header: no int32 size '
                         'marker')


def read_mat(f) -> np.ndarray:
    """Read one matrix at the current position (after the key)."""
    binary = f.read(2)
    if binary == b'\x00B':
        header = _read_token(f)
        if header in ('FM', 'DM'):
            dtype = '<f4' if header == 'FM' else '<f8'
            _size_marker(f)
            rows = struct.unpack('<i', f.read(4))[0]
            _size_marker(f)
            cols = struct.unpack('<i', f.read(4))[0]
            data = np.frombuffer(f.read(rows * cols *
                                        np.dtype(dtype).itemsize),
                                 dtype=dtype)
            return data.reshape(rows, cols).astype(np.float32)
        if header in ('FV', 'DV'):
            dtype = '<f4' if header == 'FV' else '<f8'
            _size_marker(f)
            n = struct.unpack('<i', f.read(4))[0]
            return np.frombuffer(f.read(n * np.dtype(dtype).itemsize),
                                 dtype=dtype).astype(np.float32)
        raise ValueError(f'unsupported kaldi header {header!r}')
    # text format: starts with '[' eventually
    rest = binary + f.readline()
    rows = []
    line = rest
    while line:
        parts = line.replace(b'[', b'').replace(b']', b'').split()
        if parts:
            rows.append([float(x) for x in parts])
        if b']' in line:
            break
        line = f.readline()
    return np.asarray(rows, np.float32)


def read_ark(path) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) pairs from a binary/text ark file."""
    with open(path, 'rb') as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            yield key, read_mat(f)


def read_scp(path) -> Iterator[Tuple[str, np.ndarray]]:
    """scp lines `key ark_path:offset` → (key, matrix)."""
    with open(path, encoding='utf8') as f:
        for line in f:
            key, rxfile = line.strip().split(None, 1)
            ark_path, _, offset = rxfile.rpartition(':')
            with open(ark_path, 'rb') as af:
                af.seek(int(offset))
                yield key, read_mat(af)


def write_ark(path, items: Dict[str, np.ndarray], scp_path=None):
    """Write binary FM matrices; optional scp index."""
    scp_lines = []
    with open(path, 'wb') as f:
        for key, mat in items.items():
            f.write(key.encode() + b' ')
            offset = f.tell()
            mat = np.asarray(mat, np.float32)
            if mat.ndim == 1:
                f.write(b'\x00BFV \x04' + struct.pack('<i', mat.shape[0]))
                f.write(mat.astype('<f4').tobytes())
            else:
                f.write(b'\x00BFM \x04' + struct.pack('<i', mat.shape[0]))
                f.write(b'\x04' + struct.pack('<i', mat.shape[1]))
                f.write(mat.astype('<f4').tobytes())
            scp_lines.append(f'{key} {path}:{offset}')
    if scp_path:
        with open(scp_path, 'w') as f:
            f.write('\n'.join(scp_lines) + '\n')
