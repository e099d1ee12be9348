"""Seeded random weights, made on the device in a few large calls.

A weight spec is a list of (name, shape, kind) in a fixed order.  Every
value comes from ONE stream of standard normals, generated in chunks of
CHUNK elements (chunk c from a generator seeded by the run's seed and c), so
the program's set-up and the plain reference, given the same spec and seed,
get the same tensors, and one leaf can be made again without the others.

kinds:
  'fan_in'  normal / sqrt(fan_in)      (matrices, convolution kernels)
  'embed'   normal * 0.02              (embedding tables)
  'small'   normal * 0.02              (biases, positional tables)
  'ones'    1 + normal * 0.02          (LayerNorm and BatchNorm scales)
  'var'     1 + |normal| * 0.1         (BatchNorm running variances)
  'sinusoid' Whisper's fixed sinusoid table (no random values used)
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 26
Spec = List[Tuple[str, Tuple[int, ...], str]]


def _chunk(seed: int, c: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 65537 + 7919 * (c + 1)) % (1 << 63))
    return torch.randn(CHUNK, generator=g, device=device)


def whisper_sinusoids(length: int, channels: int) -> np.ndarray:
    """OpenAI Whisper's `sinusoids`: [sin | cos] halves, timescales
    10000^(i / (channels/2 - 1))."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], 1).astype(np.float32)


def _shape_leaf(raw: torch.Tensor, shape, kind: str) -> torch.Tensor:
    if kind == 'fan_in':
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else int(shape[0])
        return raw.mul_(1.0 / math.sqrt(max(fan, 1)))
    if kind in ('embed', 'small'):
        return raw.mul_(0.02)
    if kind == 'ones':
        return raw.mul_(0.02).add_(1.0)
    if kind == 'var':
        return raw.abs_().mul_(0.1).add_(1.0)
    if kind == 'sinusoid':
        return torch.from_numpy(whisper_sinusoids(*shape)).to(raw.device)
    raise ValueError(f'unknown weight kind {kind!r}')


def leaves(spec: Spec, seed: int, device, dtype=torch.float32
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every leaf of the spec, in its order, each made
    from its span of the stream; at most two chunks live at a time."""
    cur_c, cur = -1, None
    pos = 0
    for name, shape, kind in spec:
        n = int(np.prod(shape)) if shape else 1
        parts = []
        need, at = n, pos
        while need:
            c, off = divmod(at, CHUNK)
            if c != cur_c:
                cur_c, cur = c, _chunk(seed, c, device)
            take = min(need, CHUNK - off)
            parts.append(cur[off:off + take])
            need -= take
            at += take
        pos += n
        raw = parts[0].clone() if len(parts) == 1 else torch.cat(parts)
        yield name, _shape_leaf(raw.reshape(shape), shape, kind).to(dtype)


def state_dict(spec: Spec, seed: int, device, dtype=torch.float32
               ) -> Dict[str, torch.Tensor]:
    return dict(leaves(spec, seed, device, dtype))
