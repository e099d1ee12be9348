"""Weights between the JAX parameter tree, reverb checkpoints and the port.

The JAX package keeps parameters in a nested dict with WeNet's state-dict
keys, except that a conformer layer's conv-module parameters sit flat in
the layer (reverb_tpu/convert/torch_ckpt.py drops `.conv_module.`).  The
port's modules use WeNet's keys as they are, so the bridge is a key walk:

    flat JAX keys (flatten_params / a reverb .pt / a JAX .npz)
        → re-nest `.conv_module.` → {key: float32 tensor} → load_state_dict
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from reverb_tpu.convert.torch_ckpt import load_torch_state_dict

_CONV_MODULE = re.compile(
    r'^(encoder\.encoders\.\d+\.)'
    r'(pointwise_conv1|depthwise_conv|pointwise_conv2|norm)\.')


def state_dict_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """`flatten_params(jax_params)` (or a converted checkpoint) → a state
    dict for `models.asr_model.ASRModel` (strict loading).  Floating values
    become float32 tensors; the encoder's global_cmvn (mean, istd) and the
    conv modules' batch-norm running stats are carried as buffers."""
    out = {}
    for key, val in flat.items():
        key = _CONV_MODULE.sub(r'\1conv_module.\2.', key)
        arr = np.asarray(val)
        if arr.dtype.kind == 'f' or arr.dtype.name == 'bfloat16':
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def load_flat_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reverb `.pt` or a JAX `.npz` checkpoint → flat {JAX key: array}."""
    if str(path).endswith('.npz'):
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files
                    if not k.startswith('__meta__')}
    return load_torch_state_dict(path)
