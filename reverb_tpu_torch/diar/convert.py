"""Weights of the JAX package's diarization nets → the port's state_dicts.

reverb_tpu keeps each diarization net's parameters as a tree of dicts and
lists (its `init_segmentation` / `init_embedding_model` trees, the output
of `convert_pyannet` / `convert_wespeaker_resnet34`), and its save_npz
writes the same tree flat under dotted keys (`segmentation.npz`,
`embedding.npz`).  `state_dict_from_jax(tree, net)` takes either form, as
numpy, and returns the state_dict of the port's module for `net`:

  segmentation  diar.models.SegmentationNet   keys as the tree, but the
                BiLSTM's lstm.{k}.{fwd,bwd}.{w_ih,w_hh,b} become nn.LSTM's
                lstm.{weight_ih,weight_hh,bias_ih}_l{k}[_reverse] with
                bias_hh zero (JAX's one bias is b_ih + b_hh)
  embedding     diar.models.EmbeddingNet      keys as the tree
  pyannet       diar.pyannet.PyanNet          the released layout (the
                inverse of reverb_tpu's convert_pyannet), ParamSincFB's
                n_/window_ buffers added
  resnet34      diar.pyannet.ResNet34         the released layout (the
                inverse of convert_wespeaker_resnet34), each BatchNorm's
                num_batches_tracked added

`npz_arrays` goes back for the two native nets: a state_dict → the flat
arrays reverb_tpu's save_npz writes.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from reverb_tpu_torch.diar.pyannet import sinc_fb_buffers

NETS = ('segmentation', 'embedding', 'pyannet', 'resnet34')
_LSTM = re.compile(r'^lstm\.(\d+)\.(fwd|bwd)\.(w_ih|w_hh|b)$')
_LSTM_NAMES = {'w_ih': 'weight_ih', 'w_hh': 'weight_hh', 'b': 'bias_ih'}
_RENAMES = {
    'pyannet': [(r'^sincnet\.sinc\.', 'sincnet.conv1d.0.filterbank.'),
                (r'^sincnet\.conv(\d)\.', r'sincnet.conv1d.\1.'),
                (r'^sincnet\.norm(\d)\.', r'sincnet.norm1d.\1.')],
    'resnet34': [(r'^layers\.(\d+)\.',
                  lambda m: f'layer{int(m.group(1)) + 1}.'),
                 (r'\.shortcut\.conv\.', '.downsample.0.'),
                 (r'\.shortcut\.bn\.', '.downsample.1.')],
}


def flatten(tree, prefix: str = '') -> Dict[str, np.ndarray]:
    """A tree of dicts and lists → {dotted key: array}; a flat dict's
    dotted keys stay as they are."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f'{prefix}{k}.'))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f'{prefix}{i}.'))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def state_dict_from_jax(tree, net: str) -> Dict[str, torch.Tensor]:
    """JAX parameters of `net` (one of NETS) → the port module's state_dict
    of float32 tensors (strict loading)."""
    if net not in NETS:
        raise ValueError(f'net {net!r} is not one of {NETS}')
    out = {}
    for key, val in flatten(tree).items():
        t = torch.from_numpy(np.array(val, dtype=np.float32))
        m = _LSTM.match(key)
        if m:
            layer, direction, what = m.groups()
            sfx = f'_l{layer}' + ('_reverse' if direction == 'bwd' else '')
            out[f'lstm.{_LSTM_NAMES[what]}{sfx}'] = t
            if what == 'b':
                out[f'lstm.bias_hh{sfx}'] = torch.zeros_like(t)
            continue
        for pat, rep in _RENAMES.get(net, ()):
            key = re.sub(pat, rep, key)
        out[key] = t
    if net == 'pyannet':
        n_, window_ = sinc_fb_buffers()     # PyanNetConfig's 251 taps
        out['sincnet.conv1d.0.filterbank.n_'] = n_
        out['sincnet.conv1d.0.filterbank.window_'] = window_
    if net == 'resnet34':
        for k in [k for k in out if k.endswith('.running_mean')]:
            out[k.removesuffix('running_mean') + 'num_batches_tracked'] = \
                torch.zeros((), dtype=torch.long)
    return out


def npz_arrays(state_dict) -> Dict[str, np.ndarray]:
    """A SegmentationNet's or EmbeddingNet's state_dict → the flat float32
    arrays reverb_tpu's save_npz writes for its tree (b = b_ih + b_hh)."""
    out = {}
    for k, v in state_dict.items():
        a = v.detach().to('cpu', torch.float32).numpy()
        m = re.match(r'^lstm\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)'
                     r'(_reverse)?$', k)
        if m is None:
            out[k] = a
            continue
        name, layer, rev = m.groups()
        pre = f'lstm.{layer}.{"bwd" if rev else "fwd"}.'
        if name == 'weight_ih':
            out[pre + 'w_ih'] = a
        elif name == 'weight_hh':
            out[pre + 'w_hh'] = a
        elif name == 'bias_ih':
            hh = state_dict[k.replace('bias_ih', 'bias_hh')]
            out[pre + 'b'] = a + hh.detach().to('cpu', torch.float32).numpy()
    return out
