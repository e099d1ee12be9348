"""PyanNet segmentation and wespeaker-ResNet34 embedding, in the released
checkpoints' parameter layout.

Counterpart of reverb_tpu/diar/pyannet.py: the model families behind the
released `Revai/reverb-diarization-v{1,2}` segmentation checkpoints
(fine-tuned `pyannote/segmentation-3.0` PyanNets) and the wespeaker
ResNet34 speaker-embedding net the pyannote 3.0 pipeline pairs them with.
The modules name their parameters and buffers as those checkpoints do, so
a released state_dict loads with `load_state_dict` (strict):

  PyanNet: sincnet.wav_norm1d.*, sincnet.conv1d.0.filterbank.{low_hz_,
    band_hz_,n_,window_}, sincnet.conv1d.{1,2}.*, sincnet.norm1d.{0,1,2}.*,
    lstm.{weight,bias}_{ih,hh}_l{k}[_reverse], linear.{0,1}.*,
    classifier.*
  ResNet34: conv1.weight, bn1.*, layer{1..4}.{i}.{conv1,bn1,conv2,bn2}.*
    (+ .downsample.{0,1}.* on stage-entry blocks), seg_1.*

Numerics as the JAX forwards: InstanceNorm and the stats pooling take the
variance without Bessel correction, BatchNorm uses its running statistics
(inference), ParamSincFB computes its filters as asteroid_filterbanks
does, and every convolution, LSTM and matrix product runs in full f32
(`models.f32_math`; the JAX package asks for Precision.HIGHEST).  No kernel of this repository runs here: the
JAX package's forwards reach no Pallas kernel either.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.diar.models import f32_math, stats_pool

LRELU_SLOPE = 0.01      # torch F.leaky_relu default


def instance_norm_1d(x, weight, bias, eps: float = 1e-5):
    """InstanceNorm1d(affine=True): per-(batch, channel) statistics over
    time of x (B, C, T), variance without Bessel correction."""
    mean = x.mean(dim=2, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=2, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * weight[None, :, None] + bias[None, :, None]


def sinc_fb_buffers(kernel_size: int = 251, sample_rate: int = 16000):
    """ParamSincFB's fixed buffers (n_, window_): the left half's time
    axis in radians per Hz and np.hamming's left half."""
    half = kernel_size // 2
    n_ = 2 * math.pi * np.arange(-half, 0, dtype=np.float32) / sample_rate
    window_ = np.hamming(kernel_size)[:half].astype(np.float32)
    return torch.from_numpy(n_), torch.from_numpy(window_)


def param_sinc_fb_filters(low_hz_, band_hz_, n_, window,
                          sample_rate: int = 16000,
                          min_low_hz: float = 50.0,
                          min_band_hz: float = 50.0):
    """asteroid_filterbanks.ParamSincFB filters: (2·P, 1, K) with
    interleaved cos/sin phases, from low_hz_/band_hz_ (P, 1) and the
    buffers of `sinc_fb_buffers`."""
    low = min_low_hz + torch.abs(low_hz_)                     # (P, 1)
    high = torch.clamp(low + min_band_hz + torch.abs(band_hz_),
                       min_low_hz, sample_rate / 2)
    band = (high - low)[:, 0]                                 # (P,)
    ft_low = low @ n_[None]                                   # (P, half)
    ft_high = high @ n_[None]
    cos_left = ((torch.sin(ft_high) - torch.sin(ft_low)) / (n_ / 2)) * window
    cos_center = 2 * band[:, None]
    cos_f = torch.cat([cos_left, cos_center, cos_left.flip(1)],
                      dim=1) / (2 * band[:, None])
    sin_left = ((torch.cos(ft_low) - torch.cos(ft_high)) / (n_ / 2)) * window
    sin_f = torch.cat([sin_left, torch.zeros_like(cos_center),
                       -sin_left.flip(1)], dim=1) / (2 * band[:, None])
    filt = torch.stack([cos_f, sin_f], dim=1)                 # (P, 2, K)
    return filt.reshape(-1, 1, filt.shape[-1])


@dataclasses.dataclass(frozen=True)
class PyanNetConfig:
    sample_rate: int = 16000
    sinc_stride: int = 10
    sinc_kernel: int = 251
    num_classes: int = 7        # 3-speaker powerset
    lstm_layers: int = 4
    lstm_hidden: int = 128
    linear_layers: int = 2
    linear_dim: int = 128

    @property
    def frame_stride(self):     # samples per output frame (3 pools of 3)
        return self.sinc_stride * 27


class ParamSincFB(nn.Module):
    """(low_hz_, band_hz_) (P, 1) and the buffers n_/window_, under
    asteroid's names."""

    def __init__(self, n_filters: int = 80, kernel_size: int = 251,
                 sample_rate: int = 16000):
        super().__init__()
        self.kernel_size, self.sample_rate = kernel_size, sample_rate
        self.low_hz_ = nn.Parameter(torch.empty(n_filters // 2, 1))
        self.band_hz_ = nn.Parameter(torch.empty(n_filters // 2, 1))
        n_, window_ = sinc_fb_buffers(kernel_size, sample_rate)
        self.register_buffer('n_', n_)
        self.register_buffer('window_', window_)

    def filters(self):
        return param_sinc_fb_filters(self.low_hz_, self.band_hz_, self.n_,
                                     self.window_, self.sample_rate)


class _Encoder(nn.Module):
    """asteroid's Encoder: the filterbank under `filterbank`."""

    def __init__(self, filterbank: ParamSincFB):
        super().__init__()
        self.filterbank = filterbank


class PyanSincNet(nn.Module):
    """pyannote.audio's SincNet block: wave (B, T) → (B, 60, T')."""

    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        self.stride = cfg.sinc_stride
        self.wav_norm1d = nn.InstanceNorm1d(1, affine=True)
        self.conv1d = nn.ModuleList([
            _Encoder(ParamSincFB(80, cfg.sinc_kernel, cfg.sample_rate)),
            nn.Conv1d(80, 60, 5), nn.Conv1d(60, 60, 5)])
        self.norm1d = nn.ModuleList(nn.InstanceNorm1d(c, affine=True)
                                    for c in (80, 60, 60))

    def forward(self, wave):
        n = self.wav_norm1d
        x = instance_norm_1d(wave[:, None, :], n.weight, n.bias, n.eps)
        x = F.conv1d(x, self.conv1d[0].filterbank.filters(),
                     stride=self.stride)
        x = torch.abs(x)
        for i, n in enumerate(self.norm1d):
            if i > 0:
                x = self.conv1d[i](x)
            x = F.max_pool1d(x, 3, 3)
            x = F.leaky_relu(instance_norm_1d(x, n.weight, n.bias, n.eps),
                             LRELU_SLOPE)
        return x


class PyanNet(nn.Module):
    """wave (B, T) float32 → (B, T', C) powerset log-probs
    (reverb_tpu/diar/pyannet.py:pyannet_forward)."""

    max_speakers, max_simultaneous = 3, 2

    def __init__(self, cfg: PyanNetConfig = PyanNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.frame_sec = cfg.frame_stride / cfg.sample_rate
        self.sincnet = PyanSincNet(cfg)
        self.lstm = nn.LSTM(60, cfg.lstm_hidden, num_layers=cfg.lstm_layers,
                            bidirectional=True, batch_first=True)
        dims = [2 * cfg.lstm_hidden] + [cfg.linear_dim] * cfg.linear_layers
        self.linear = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        self.classifier = nn.Linear(dims[-1], cfg.num_classes)

    def forward(self, wave):
        with f32_math():
            x = self.sincnet(wave).transpose(1, 2)          # (B, T', 60)
            x, _ = self.lstm(x)
            for lin in self.linear:
                x = F.leaky_relu(lin(x), LRELU_SLOPE)
            return F.log_softmax(self.classifier(x), dim=-1)


def pyannet_config(state: Dict[str, torch.Tensor]) -> PyanNetConfig:
    """The PyanNetConfig of a PyanNet state_dict (layer counts and widths
    read from its keys and shapes)."""
    n_lstm = 1 + max(int(m.group(1)) for k in state
                     if (m := re.match(r'lstm\.weight_ih_l(\d+)$', k)))
    n_lin = 1 + max(int(k.split('.')[1]) for k in state
                    if k.startswith('linear.'))
    return PyanNetConfig(num_classes=state['classifier.weight'].shape[0],
                         lstm_layers=n_lstm,
                         lstm_hidden=state['lstm.weight_hh_l0'].shape[1],
                         linear_layers=n_lin,
                         linear_dim=state['linear.0.weight'].shape[0])


def build_pyannet(state: Dict[str, torch.Tensor], device) -> PyanNet:
    """A PyanNet on `device` holding `state` (strict)."""
    with torch.device('meta'):
        model = PyanNet(pyannet_config(state))
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)


def _read_state(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's state_dict (lightning's under 'state_dict',
    its `model.` prefix dropped) as CPU tensors."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    state = ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix('model.'): torch.as_tensor(v)
            for k, v in state.items()}


def load_pyannet_checkpoint(path: str, device) -> PyanNet:
    """A pyannote .ckpt/.bin (lightning or bare state_dict) → PyanNet."""
    return build_pyannet(_read_state(path), device)


# --------------------- wespeaker ResNet34 embedding ---------------------

@dataclasses.dataclass(frozen=True)
class ResNet34Config:
    feat_dim: int = 80
    m_channels: int = 32
    embed_dim: int = 256
    block_counts: tuple = (3, 4, 6, 3)


def _bn(m: nn.BatchNorm2d, x):
    """Inference BatchNorm over (B, C, F, T) from the running statistics."""
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                        training=False, eps=m.eps)


class BasicBlock(nn.Module):
    """wespeaker BasicBlock: conv3x3/bn/relu → conv3x3/bn + shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x):
        y = torch.relu(_bn(self.bn1, self.conv1(x)))
        y = _bn(self.bn2, self.conv2(y))
        if self.downsample is not None:
            x = _bn(self.downsample[1], self.downsample[0](x))
        return torch.relu(y + x)


class ResNet34(nn.Module):
    """feats (B, T, F) fbank, lens (B,) or None → L2-normalized (B, E)
    (reverb_tpu/diar/pyannet.py:resnet34_forward): input (B, 1, F, T), a
    conv3x3 stem, 4 stages of strides (1, 2, 2, 2), mean ‖ std over time
    of the (C·F') map (the frames past each ⌈len/8⌉ masked), seg_1."""

    def __init__(self, cfg: ResNet34Config = ResNet34Config()):
        super().__init__()
        self.cfg = cfg
        self.feat_dim = cfg.feat_dim
        m = cfg.m_channels
        self.conv1 = nn.Conv2d(1, m, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(m)
        in_p = m
        for si, n in enumerate(cfg.block_counts):
            planes = m << si
            blocks = []
            for bi in range(n):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                blocks.append(BasicBlock(in_p, planes, stride))
                in_p = planes
            setattr(self, f'layer{si + 1}', nn.Sequential(*blocks))
        freq_out = cfg.feat_dim // 8          # three stride-2 stages
        self.seg_1 = nn.Linear(in_p * freq_out * 2, cfg.embed_dim)

    def forward(self, feats, lens=None):
        with f32_math():
            x = feats.transpose(1, 2)[:, None]              # (B, 1, F, T)
            x = torch.relu(_bn(self.bn1, self.conv1(x)))
            for si in range(len(self.cfg.block_counts)):
                x = getattr(self, f'layer{si + 1}')(x)
            B, C, Fr, T = x.shape
            t_lens = (None if lens is None
                      else torch.clamp((lens + 7) // 8, min=1))
            mean, var = stats_pool(x.reshape(B, C * Fr, T), t_lens)
            std = torch.sqrt(torch.clamp(var, min=1e-7))
            emb = self.seg_1(torch.cat([mean, std], dim=1))
            return emb / (torch.linalg.norm(emb, dim=-1, keepdim=True)
                          + 1e-8)


def resnet34_config(state: Dict[str, torch.Tensor]) -> ResNet34Config:
    """The ResNet34Config of a wespeaker ResNet state_dict (80 mel bins)."""
    counts = tuple(
        1 + max(int(k.split('.')[1]) for k in state
                if k.startswith(f'layer{si}.'))
        for si in range(1, 5))
    return ResNet34Config(m_channels=state['conv1.weight'].shape[0],
                          embed_dim=state['seg_1.weight'].shape[0],
                          block_counts=counts)


def build_resnet34(state: Dict[str, torch.Tensor], device) -> ResNet34:
    """A ResNet34 on `device` holding `state` (strict)."""
    with torch.device('meta'):
        model = ResNet34(resnet34_config(state))
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)


def load_resnet34_checkpoint(path: str, device) -> ResNet34:
    """A wespeaker ResNet34 .pt (bare, or under 'state_dict') → ResNet34."""
    return build_resnet34(_read_state(path), device)
