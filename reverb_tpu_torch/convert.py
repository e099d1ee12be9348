"""Weights between the JAX parameter tree, reverb checkpoints and the port.

The JAX package keeps parameters in a nested dict with WeNet's state-dict
keys, except that a conformer layer's conv-module parameters sit flat in
the layer (reverb_tpu/convert/torch_ckpt.py drops `.conv_module.`).  The
port's modules use WeNet's keys as they are, so the bridge is a key walk:

    flat JAX keys (flatten_params / a reverb .pt / a JAX .npz)
        → re-nest `.conv_module.` → {key: float32 tensor} → load_state_dict

and back (`flat_from_state_dict`), so a checkpoint the port writes loads
into the JAX tree (`nest_state_dict`) and the other way round.  Every leaf
crosses, the batch-norm running statistics and the CMVN stats included:
both packages keep them as leaves of the trainable tree.

A transducer's rnn predictor is the JAX tree's list of LSTM layers
`predictor.rnn.{k}.{w_ih,w_hh,b}` (and `predictor_r`), and `nn.LSTM`'s
`predictor.rnn.{weight_ih,weight_hh,bias_ih}_l{k}` in the port, whose
second bias `bias_hh_l{k}` has no JAX leaf: it comes in as zeros and goes
out summed into `b` (`lstm_second_bias` names it; the trainer keeps it
frozen at zero).  A Paraformer's timestamp BiLSTM is the JAX tree's
`predictor.tp_blstm.{fwd,bwd}.{w_ih,w_hh,b}` and `nn.LSTM`'s
`predictor.tp_blstm.{weight_ih,weight_hh,bias_ih,bias_hh}_l0[_reverse]`
here, the same way.  A WeNet-converted Paraformer `.pt` nests the CIF head
under `predictor.predictor.*` and keeps both LSTM biases:
`fixup_paraformer_flat` flattens the one and sums the other into
`bias_ih`, as reverb_tpu/convert/torch_ckpt.py:fixup_paraformer_predictor
does.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# torch buffer/bookkeeping keys a reverb .pt carries and the tree does not
_SKIP_SUFFIXES = ('num_batches_tracked',)
_CONV_MODULE = re.compile(
    r'^(encoder\.encoders\.\d+\.)'
    r'(pointwise_conv1|depthwise_conv|pointwise_conv2|norm)\.')
_PORT_CONV = re.compile(r'^(encoder\.encoders\.\d+\.)conv_module\.')
_JAX_LSTM = re.compile(r'^(predictor(?:_r)?\.rnn)\.(\d+)\.(w_ih|w_hh|b)$')
_PORT_LSTM = re.compile(
    r'^(predictor(?:_r)?\.rnn)\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)$')
_JAX_TP = re.compile(r'^(predictor\.tp_blstm)\.(fwd|bwd)\.(w_ih|w_hh|b)$')
_PORT_TP = re.compile(r'^(predictor\.tp_blstm)\.'
                      r'(weight_ih|weight_hh|bias_ih|bias_hh)_l0(_reverse)?$')
_TO_PORT_LSTM = {'w_ih': 'weight_ih', 'w_hh': 'weight_hh', 'b': 'bias_ih'}
_TO_JAX_LSTM = {'weight_ih': 'w_ih', 'weight_hh': 'w_hh', 'bias_ih': 'b',
                'bias_hh': 'b'}


def lstm_second_bias(name: str) -> bool:
    """Whether a port parameter is a predictor LSTM's `bias_hh`, which has
    no JAX leaf."""
    m = _PORT_LSTM.match(name) or _PORT_TP.match(name)
    return bool(m) and m.group(2) == 'bias_hh'


def tree_key(name: str) -> str:
    """The JAX tree's flat key of a port parameter name (the conv-module
    parameters sit flat in the layer there; a predictor LSTM's weights are
    the JAX layer list's, both biases its `b`)."""
    m = _PORT_LSTM.match(name)
    if m:
        return f'{m.group(1)}.{m.group(3)}.{_TO_JAX_LSTM[m.group(2)]}'
    m = _PORT_TP.match(name)
    if m:
        side = 'bwd' if m.group(3) else 'fwd'
        return f'{m.group(1)}.{side}.{_TO_JAX_LSTM[m.group(2)]}'
    return _PORT_CONV.sub(r'\1', name)


def state_dict_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """`flatten_params(jax_params)` (or a converted checkpoint) → a state
    dict for `models.asr_model.ASRModel` (strict loading).  Floating values
    become float32 tensors, the encoder's global_cmvn (mean, istd) and the
    conv modules' batch-norm running stats included; the int8 weights of a
    quantized tree (`weight_q8`) stay int8, with their f32 `w_scale` and
    `a_scale`."""
    out = {}
    for key, val in flat.items():
        key = _CONV_MODULE.sub(r'\1conv_module.\2.', key)
        arr = np.asarray(val)
        if arr.dtype.kind == 'f' or arr.dtype.name == 'bfloat16':
            arr = arr.astype(np.float32)
        m = _JAX_LSTM.match(key)
        if m:
            key = f'{m.group(1)}.{_TO_PORT_LSTM[m.group(3)]}_l{m.group(2)}'
            if m.group(3) == 'b':
                out[f'{m.group(1)}.bias_hh_l{m.group(2)}'] = torch.zeros(
                    arr.shape)
        m = _JAX_TP.match(key)
        if m:
            rev = '_reverse' if m.group(2) == 'bwd' else ''
            key = f'{m.group(1)}.{_TO_PORT_LSTM[m.group(3)]}_l0{rev}'
            if m.group(3) == 'b':
                out[f'{m.group(1)}.bias_hh_l0{rev}'] = torch.zeros(arr.shape)
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def flat_from_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """A port state dict → flat {JAX key: array}, the inverse of
    `state_dict_from_jax` (feeds reverb_tpu's nest_state_dict): floating
    values as float32, the int8 weights of a quantized model
    (`weight_q8`) as int8."""
    out = {}
    for k, v in state_dict.items():
        arr = (v.detach().to('cpu', torch.float32) if v.is_floating_point()
               else v.detach().cpu()).numpy()
        key = tree_key(k)
        out[key] = out[key] + arr if key in out else arr
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reverb `.pt` (a raw state dict, or one under 'model0' or
    'state_dict') → flat {JAX key: np.ndarray} on the host (the port's copy
    of reverb_tpu/convert/torch_ckpt.py:load_torch_state_dict)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(ckpt, dict) and 'model0' in ckpt:
        ckpt = ckpt['model0']
    if isinstance(ckpt, dict) and 'state_dict' in ckpt:
        ckpt = ckpt['state_dict']
    return convert_torch_state_dict(ckpt)


def convert_torch_state_dict(ckpt) -> Dict[str, np.ndarray]:
    """In-memory torch state dict → flat {JAX key: np.ndarray}: drops a
    'module.' prefix, renames ESPnet's cmvn keys (`normalize.mean/std` →
    `global_cmvn.mean/istd`), flattens `.conv_module.` as the JAX tree does,
    skips bookkeeping buffers; floating values become float32."""
    out = {}
    for k, v in ckpt.items():
        if not hasattr(v, 'numpy'):
            continue
        k = k.removeprefix('module.')
        k = k.replace('normalize.mean', 'global_cmvn.mean')
        k = k.replace('normalize.std', 'global_cmvn.istd')
        k = k.replace('.conv_module.', '.')
        if k.endswith(_SKIP_SUFFIXES):
            continue
        out[k] = v.detach().to(torch.float32).numpy() \
            if v.dtype.is_floating_point else v.detach().numpy()
    return out


def fixup_paraformer_flat(flat: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """A WeNet-converted Paraformer's flat keys → the JAX tree's (the
    counterpart of reverb_tpu/convert/torch_ckpt.py:
    fixup_paraformer_predictor): `predictor.predictor.*` (the CIF head)
    → `predictor.*`, and the timestamp BiLSTM's torch keys
    `predictor.tp_blstm.{weight_ih,weight_hh,bias_ih,bias_hh}_l0[_reverse]`
    → `predictor.tp_blstm.{fwd,bwd}.{w_ih,w_hh,b}` with b = b_ih + b_hh.
    Keys already in the JAX layout pass through."""
    out = {}
    tp = {}
    for k, v in flat.items():
        if k.startswith('predictor.predictor.'):
            k = 'predictor.' + k[len('predictor.predictor.'):]
        m = _PORT_TP.match(k)
        if m:
            side = 'bwd' if m.group(3) else 'fwd'
            name = _TO_JAX_LSTM[m.group(2)]
            key = f'{m.group(1)}.{side}.{name}'
            tp[key] = tp[key] + v if key in tp else v
            continue
        out[k] = v
    out.update(tp)
    return out


def load_paraformer_flat(path: str) -> Dict[str, np.ndarray]:
    """A Paraformer checkpoint — a WeNet-converted `.pt` or a JAX `.npz` —
    → flat {JAX key: array} (reverb_tpu/convert/torch_ckpt.py:
    load_paraformer_checkpoint, and fixup_paraformer_predictor over
    load_npz)."""
    return fixup_paraformer_flat(load_flat_checkpoint(path))


def load_flat_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reverb `.pt` or a JAX `.npz` checkpoint → flat {JAX key: array}."""
    if str(path).endswith('.npz'):
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files
                    if not k.startswith('__meta__')}
    return load_torch_state_dict(path)


def load_npz(path: str):
    """A JAX `.npz` checkpoint (reverb_tpu's save_npz) → (flat {dotted
    key: array}, {metadata key: array}), as reverb_tpu's load_npz but
    left flat: the port's state_dict bridges take flat keys."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if not k.startswith('__meta__')}
        meta = {k.removeprefix('__meta__'): data[k] for k in data.files
                if k.startswith('__meta__')}
    return flat, meta
