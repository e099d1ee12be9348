"""Positional encodings (sinusoidal absolute + WeNet relative).

Counterpart of reverb_tpu/models/embedding.py; the table is built on the
host in float32 exactly as there.  Positional dropout (rate, generator)
applies to the scaled input and to the returned table, as there.
`position_encoding` picks the encoder's kind: rel_pos, abs_pos (and
abs_pos_whisper, the same table in the JAX package) or no_pos.
`stream_position_rows` gives a streaming chunk its rows at absolute stream
positions, one set per stream (reverb_tpu/models/encoder.py:
encoder_forward_chunk).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from reverb_tpu_torch.models.modules import dropout

POS_ENC_TYPES = ('rel_pos', 'abs_pos', 'abs_pos_whisper', 'no_pos')


@functools.lru_cache(maxsize=16)
def pe_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """(max_len, d_model) sinusoidal table: even dims sin, odd dims cos."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@functools.lru_cache(maxsize=8)
def pe_table_on(d_model: int, device: torch.device) -> torch.Tensor:
    """`pe_table` on `device`, copied there once: the decoder's incremental
    step reads one row per hypothesis at every step."""
    with torch.inference_mode(False):
        return torch.from_numpy(pe_table(d_model)).to(device)


def _pe(d_model: int, T: int, x):
    # rows of the one table on x's device: an exported program
    # (export/aot.py) then holds the table once, with views of it
    return pe_table_on(d_model, x.device)[:T].to(x.dtype)[None]


def abs_position_encoding(x, rate: float = 0.0, generator=None):
    """x (B, T, D) → (x·√d + pe, pe (1, T, D)), both through dropout."""
    d = x.shape[-1]
    pe = _pe(d, x.shape[1], x)
    return (dropout(x * math.sqrt(d) + pe, rate, generator),
            dropout(pe, rate, generator))


def rel_position_encoding(x, rate: float = 0.0, generator=None, seq=None):
    """x (B, T, D) → (x·√d, pos_emb (1, T, D)), both through dropout.
    Under 'seq' (`seq`, parallel/collectives.py:TimeSplit) x is this
    rank's block of the time axis, its dropout the block of the unsplit
    mask, and pos_emb the whole axis's rows (the keys' positions), zero
    past its end."""
    d = x.shape[-1]
    if seq is None:
        return (dropout(x * math.sqrt(d), rate, generator),
                dropout(_pe(d, x.shape[1], x), rate, generator))
    x = dropout(x * math.sqrt(d), rate, generator, seq.entry(1))
    pos = dropout(_pe(d, seq.length, x), rate, generator)
    return x, torch.cat(
        [pos, pos.new_zeros((1, seq.padded - seq.length, d))], 1)


def no_position_encoding(x, rate: float = 0.0, generator=None):
    """x (B, T, D) → (x through dropout, a zero pos_emb (1, T, D))."""
    return (dropout(x, rate, generator),
            torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device))


def position_encoding(kind: str, x, rate: float = 0.0, generator=None,
                      seq=None):
    """The encoder's `pos_enc_layer_type`: 'rel_pos' (x·√d and the table
    apart), 'abs_pos' and 'abs_pos_whisper' (x·√d + the table; the JAX
    package builds both from the one sinusoid table) or 'no_pos' (x, a
    zero table).  `seq` (rel_pos only): x is a 'seq' rank's time block
    (`rel_position_encoding`)."""
    if kind == 'rel_pos':
        return rel_position_encoding(x, rate, generator, seq)
    if kind in ('abs_pos', 'abs_pos_whisper'):
        return abs_position_encoding(x, rate, generator)
    if kind == 'no_pos':
        return no_position_encoding(x, rate, generator)
    raise ValueError(f'unknown pos_enc_layer_type {kind!r}')


def stream_position_rows(d_model: int, offset, cache_t: int, S: int, dtype):
    """Rel-pos rows of a streaming chunk: for each stream, the table rows at
    the absolute positions offset − cache_t + [0, S) (clipped to the table),
    the positions of its cache slots and chunk frames.  offset: (1,) or
    (B,) int64 tensor → (1|B, S, D) on offset's device."""
    table = pe_table_on(d_model, offset.device)
    idx = torch.clamp(offset[:, None] - cache_t
                      + torch.arange(S, device=offset.device)[None, :],
                      0, table.shape[0] - 1)
    return table[idx].to(dtype)
