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


def tree_key(name: str) -> str:
    """The JAX tree's flat key of a port parameter name (the conv-module
    parameters sit flat in the layer there)."""
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
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def flat_from_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """A port state dict → flat {JAX key: array}, the inverse of
    `state_dict_from_jax` (feeds reverb_tpu's nest_state_dict): floating
    values as float32, the int8 weights of a quantized model
    (`weight_q8`) as int8."""
    return {tree_key(k): (v.detach().to('cpu', torch.float32)
                          if v.is_floating_point() else v.detach().cpu())
            .numpy() for k, v in state_dict.items()}


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
