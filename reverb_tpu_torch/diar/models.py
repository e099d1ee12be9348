"""Diarization nets: local segmentation and speaker embedding.

Counterpart of reverb_tpu/diar/models.py: a sliding-window segmentation
net emitting powerset multi-speaker log-posteriors (SincNet band-pass
frontend → max-pool → LayerNorm → BiLSTM stack → linear classifier) and
an x-vector TDNN speaker-embedding net (4 dilated convolutions, each
followed by a LayerNorm, then length-masked mean/std stats pooling).

The TDNN's LayerNorms are `models.modules.LayerNorm`: at 512 channels
(`EmbeddingConfig()`) they launch kernel K5 on a CUDA tensor
(ops/layer_norm.py), 4 launches per embedding call.  The segmentation
net's LayerNorm over 80 sinc filters is not a shape K5 takes and stays
plain, as in the JAX package.  The BiLSTM is `nn.LSTM`: the JAX package
runs it as a `lax.scan`, not a Pallas kernel.  JAX's one LSTM bias `b` is
`bias_ih` here with `bias_hh` zero (diar/convert.py).

Every forward runs its convolutions and matrix products in full f32
(`f32_math`): cuDNN would take TF32 for f32 convolutions by default and
move the embeddings by ~1e-3, enough to change a clustering merge near
the threshold.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from itertools import combinations
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.models.modules import (Conv1d, LayerNorm, Linear,
                                             reset_parameters)


@contextlib.contextmanager
def f32_math():
    """Full-f32 convolutions, RNNs and matrix products for the body (no
    TF32 in cuDNN or cuBLAS), the previous settings restored after."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


# ------------------------------ powerset ------------------------------

def powerset_classes(max_speakers: int = 3, max_simultaneous: int = 2
                     ) -> List[Tuple[int, ...]]:
    """Powerset label classes: ∅, singletons, pairs (pyannote 3.0 uses
    3 speakers / 2 simultaneous → 7 classes)."""
    classes: List[Tuple[int, ...]] = [()]
    for k in range(1, max_simultaneous + 1):
        classes += list(combinations(range(max_speakers), k))
    return classes


def powerset_mapping(max_speakers: int = 3, max_simultaneous: int = 2
                     ) -> np.ndarray:
    """(C, S) float32: 1 where powerset class c holds speaker s."""
    classes = powerset_classes(max_speakers, max_simultaneous)
    mapping = np.zeros((len(classes), max_speakers), np.float32)
    for ci, spk in enumerate(classes):
        for s in spk:
            mapping[ci, s] = 1.0
    return mapping


def powerset_to_multilabel(probs: torch.Tensor, max_speakers: int = 3,
                           max_simultaneous: int = 2,
                           soft: bool = False) -> torch.Tensor:
    """(…, C) powerset posteriors → (…, S) per-speaker activity: HARD by
    default (the argmax class's speakers, ties to the lower class, as
    pyannote 3.x and the JAX package), else the soft sum probs @ map."""
    mapping = torch.from_numpy(
        powerset_mapping(max_speakers, max_simultaneous)).to(probs.device)
    if soft:
        return probs @ mapping.to(probs.dtype)
    return mapping[torch.argmax(probs, dim=-1)]


# ------------------------------ SincNet ------------------------------

def sinc_filters(low_hz, band_hz, kernel_size: int, sample_rate: int):
    """(F, 1) low/band parameters → (F, K) band-pass filters (SincNet,
    arXiv 1808.00158), each scaled to a peak of 1.  |x| is taken as
    where(x ≥ 0, x, −x), whose gradient at 0 is 1 as jnp.abs's is (torch's
    abs has 0 there): the first mel band starts at exactly 0 Hz."""
    low = 30.0 + torch.where(low_hz >= 0, low_hz, -low_hz)
    high = torch.clamp(low + 50.0 + torch.where(band_hz >= 0, band_hz,
                                                -band_hz),
                       50.0, sample_rate / 2)
    dev = low_hz.device
    n = (torch.arange(kernel_size, dtype=torch.float32, device=dev)
         - (kernel_size - 1) / 2) / sample_rate
    window = torch.hamming_window(kernel_size, periodic=False,
                                  dtype=torch.float32, device=dev)
    f1, f2 = low, high                                    # (F, 1)
    filt = (2 * f2 * torch.sinc(2 * f2 * n) -
            2 * f1 * torch.sinc(2 * f1 * n)) * window
    norm = torch.amax(torch.abs(filt), dim=1, keepdim=True) + 1e-8
    return filt / norm


class SincNet(nn.Module):
    """Learnable band-pass filterbank: wave (B, T) → (B, F, T') log1p of
    the band energies' magnitudes."""

    def __init__(self, n_filters: int = 80, kernel_size: int = 251,
                 stride: int = 10, sample_rate: int = 16000):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.sample_rate = sample_rate
        self.low_hz = nn.Parameter(torch.empty(n_filters, 1))
        self.band_hz = nn.Parameter(torch.empty(n_filters, 1))

    def reset_parameters(self, g=None):
        """Mel-spaced bands (reverb_tpu/diar/models.py:init_sincnet; no
        draw)."""
        n = self.low_hz.shape[0]
        mel = np.linspace(0, 2595 * np.log10(
            1 + (self.sample_rate / 2 - 100) / 700), n + 1)
        hz = 700 * (10 ** (mel / 2595) - 1)
        with torch.no_grad():
            self.low_hz.copy_(torch.from_numpy(hz[:-1, None]))
            self.band_hz.copy_(torch.from_numpy(np.diff(hz)[:, None]))

    def forward(self, wave):
        filt = sinc_filters(self.low_hz, self.band_hz, self.kernel_size,
                            self.sample_rate)
        y = F.conv1d(wave[:, None, :], filt[:, None, :], stride=self.stride)
        return torch.log1p(torch.abs(y))


class LSTM(nn.LSTM):
    """`nn.LSTM` (batch first) whose random initialization draws from a
    generator as the JAX package's init_lstm: weights uniform in
    ±1/sqrt(hidden), biases zero."""

    def reset_parameters(self, g=None):
        if g is None:               # nn.LSTM's own init, at construction
            return super().reset_parameters()
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith('bias'):
                    p.zero_()
                else:
                    p.uniform_(-bound, bound, generator=g)


# ------------------------------ segmentation ------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    sample_rate: int = 16000
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    pool: int = 27              # output frame = sinc_stride*pool samples
    lstm_hidden: int = 128
    lstm_layers: int = 2
    linear_dim: int = 128
    max_speakers: int = 3
    max_simultaneous: int = 2

    @property
    def num_classes(self):
        return len(powerset_classes(self.max_speakers, self.max_simultaneous))


def segmentation_frame_rate(cfg: SegmentationConfig) -> float:
    """Seconds per output frame."""
    return cfg.sinc_stride * cfg.pool / cfg.sample_rate


class SegmentationNet(nn.Module):
    """wave (B, T) float32 in [-1, 1] → (B, T', C) powerset log-probs
    (reverb_tpu/diar/models.py:segmentation_forward)."""

    def __init__(self, cfg: SegmentationConfig = SegmentationConfig()):
        super().__init__()
        self.cfg = cfg
        self.frame_sec = segmentation_frame_rate(cfg)
        self.max_speakers = cfg.max_speakers
        self.max_simultaneous = cfg.max_simultaneous
        self.sincnet = SincNet(cfg.sinc_filters, cfg.sinc_kernel,
                               cfg.sinc_stride, cfg.sample_rate)
        self.norm0 = LayerNorm(cfg.sinc_filters)
        self.lstm = LSTM(cfg.sinc_filters, cfg.lstm_hidden,
                         num_layers=cfg.lstm_layers, bidirectional=True,
                         batch_first=True)
        self.linear = Linear(2 * cfg.lstm_hidden, cfg.linear_dim)
        self.classifier = Linear(cfg.linear_dim, cfg.num_classes)

    def forward(self, wave):
        with f32_math():
            x = self.sincnet(wave)                          # (B, F, T')
            x = F.max_pool1d(x, self.cfg.pool, self.cfg.pool)
            x = self.norm0(x.transpose(1, 2))               # (B, T', F)
            x, _ = self.lstm(x)
            x = F.leaky_relu(self.linear(x))
            return F.log_softmax(self.classifier(x), dim=-1)


# ------------------------------ embedding ------------------------------

@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    feat_dim: int = 80
    channels: int = 512
    embed_dim: int = 192
    layers: int = 4


_DILATIONS = (1, 2, 3, 1)


def stats_pool(x, lens: Optional[torch.Tensor]):
    """(B, C, T) → the (B, C) mean and variance over time, over the first
    lens[b] frames of each row when lens is given; the variance has no
    Bessel correction (jnp.var's ddof 0)."""
    if lens is None:
        mean = x.mean(dim=2)
        var = ((x - mean[:, :, None]) ** 2).mean(dim=2)
    else:
        T = x.shape[2]
        mask = (torch.arange(T, device=x.device)[None, :]
                < lens[:, None])[:, None, :]
        cnt = torch.clamp(mask.sum(dim=2), min=1)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        mean = torch.where(mask, x, zero).sum(dim=2) / cnt
        var = torch.where(mask, (x - mean[:, :, None]) ** 2,
                          zero).sum(dim=2) / cnt
    return mean, var


class TDNNLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, 3)
        self.norm = LayerNorm(out_ch)


class EmbeddingNet(nn.Module):
    """feats (B, T, F) fbank, lens (B,) or None → L2-normalized (B, E)
    (reverb_tpu/diar/models.py:embedding_forward)."""

    def __init__(self, cfg: EmbeddingConfig = EmbeddingConfig()):
        super().__init__()
        if cfg.layers > len(_DILATIONS):
            raise ValueError(f'EmbeddingConfig.layers {cfg.layers} > '
                             f'{len(_DILATIONS)} dilations')
        self.cfg = cfg
        self.feat_dim = cfg.feat_dim
        self.convs = nn.ModuleList(
            TDNNLayer(cfg.feat_dim if i == 0 else cfg.channels, cfg.channels)
            for i in range(cfg.layers))
        self.proj = Linear(2 * cfg.channels, cfg.embed_dim)

    def forward(self, feats, lens=None):
        with f32_math():
            x = feats.transpose(1, 2)                       # (B, F, T)
            for layer, d in zip(self.convs, _DILATIONS):
                y = F.conv1d(x, layer.conv.weight.to(x.dtype),
                             layer.conv.bias.to(x.dtype), padding=d,
                             dilation=d)
                # (B, T, C) rows: K5 where C suits it
                y = torch.relu(layer.norm(y.transpose(1, 2)))
                x = y.transpose(1, 2)
            mean, var = stats_pool(x, lens)
            stats = torch.cat([mean, torch.sqrt(var + 1e-6)], dim=1)
            emb = self.proj(stats)
            return emb / (torch.linalg.norm(emb, dim=-1, keepdim=True)
                          + 1e-8)


def _build_net(module_cls, cfg, device, state_dict, generator):
    with torch.device('meta'):
        model = module_cls(cfg)
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        if generator is None:
            raise ValueError(f'{module_cls.__name__} needs a state_dict or '
                             f'a generator')
        reset_parameters(model, generator)
    return model.eval().requires_grad_(False)


def build_segmentation(cfg: SegmentationConfig, device,
                       state_dict: Optional[dict] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> SegmentationNet:
    """A SegmentationNet on `device` from `state_dict` (strict), else
    randomly initialized from `generator` (a generator on `device`)."""
    return _build_net(SegmentationNet, cfg, device, state_dict, generator)


def build_embedding(cfg: EmbeddingConfig, device,
                    state_dict: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> EmbeddingNet:
    """An EmbeddingNet on `device`, as build_segmentation."""
    return _build_net(EmbeddingNet, cfg, device, state_dict, generator)
