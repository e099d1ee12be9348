"""Checkpoints in the JAX package's format.

Counterpart of reverb_tpu/train/checkpoint.py (`save_checkpoint`,
`load_checkpoint`): `<tag>.npz` holds the parameters as flat float32
arrays under the JAX tree's keys (WeNet's state-dict keys with the
conv-module parameters flat, as reverb_tpu/convert/torch_ckpt.py:save_npz
writes them), `<tag>.yaml` the info dict.  Each package loads the other's
parameters.  The optimizer state is the port's own: `<tag>.torch_opt.pt`.

The info file is written as a JSON object, which is YAML too, so no YAML
writer is needed; reading it (or one the JAX package wrote) takes PyYAML.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from reverb_tpu_torch import convert


def save_checkpoint(model_dir, tag: str, model: torch.nn.Module,
                    optimizer=None, info: Optional[Dict] = None) -> Path:
    """Write `<model_dir>/<tag>.npz` (+ `<tag>.torch_opt.pt`) + `<tag>.yaml`.
    `info` holds plain scalars, strings, lists and dicts.  Returns the npz
    path."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    path = model_dir / f'{tag}.npz'
    np.savez(path, **convert.flat_from_state_dict(model.state_dict()))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), model_dir / f'{tag}.torch_opt.pt')
    (model_dir / f'{tag}.yaml').write_text(
        json.dumps(info or {}, sort_keys=True) + '\n')
    return path


def load_checkpoint(path, model: torch.nn.Module, optimizer=None) -> Dict:
    """Load `<tag>.npz` (written by either package) into `model` (strict),
    and `<tag>.torch_opt.pt` into `optimizer` when both exist.  Returns the
    info dict of `<tag>.yaml` ({} without one)."""
    path = Path(path)
    state = convert.state_dict_from_jax(convert.load_flat_checkpoint(path))
    model.load_state_dict(state, strict=True)
    opt_path = path.with_suffix('.torch_opt.pt')
    if optimizer is not None and opt_path.exists():
        optimizer.load_state_dict(torch.load(opt_path, map_location='cpu'))
    info_path = path.with_suffix('.yaml')
    if not info_path.exists():
        return {}
    import yaml
    return yaml.safe_load(info_path.read_text()) or {}
