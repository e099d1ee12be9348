"""Checkpoints in the JAX package's format.

Counterpart of reverb_tpu/train/checkpoint.py (`save_checkpoint`,
`load_checkpoint`, `load_trained_modules`, `should_force_snapshot`,
`average_checkpoints`, `find_best_checkpoints`): `<tag>.npz` holds the
parameters as flat float32 arrays under the JAX tree's keys (WeNet's
state-dict keys with the conv-module parameters flat, as
reverb_tpu/convert/torch_ckpt.py:save_npz writes them), `<tag>.yaml` the
info dict.  Each package loads the other's parameters.  The optimizer state
is the port's own: `<tag>.torch_opt.pt`; the JAX package's `<tag>.opt.npz`
(optax leaves) is not read, and Adam's moments then start fresh.

The info file is written as a JSON object, which is YAML too; it is read
with PyYAML where that is installed (utils/config.py:load_config).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from reverb_tpu_torch import convert
from reverb_tpu_torch.utils.config import load_config, save_config

FORCE_SNAPSHOT_FLAG = 'force_full_snapshot'


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
    save_config(info or {}, model_dir / f'{tag}.yaml')
    return path


def load_checkpoint(path, model: torch.nn.Module, optimizer=None) -> Dict:
    """Load `<tag>.npz` (written by either package) into `model` (strict),
    and `<tag>.torch_opt.pt` into `optimizer` when both exist.  Returns the
    info dict of `<tag>.yaml` ({} without one)."""
    path = Path(path)
    state = convert.state_dict_from_jax(convert.load_flat_checkpoint(path))
    model.load_state_dict(state, strict=True)
    opt_path = path.with_suffix('.torch_opt.pt')
    if optimizer is not None:
        if opt_path.exists():
            optimizer.load_state_dict(torch.load(opt_path,
                                                 map_location='cpu'))
        elif path.with_suffix('.opt.npz').exists():
            logging.warning(
                '%s: the JAX optimizer state (optax leaves) is not read; '
                "Adam's moments and count start fresh", path.with_suffix(
                    '.opt.npz'))
    info_path = path.with_suffix('.yaml')
    if not info_path.exists():
        return {}
    return load_config(info_path) or {}


def load_trained_modules(model: torch.nn.Module, ckpt_path,
                         module_prefixes: List[str]):
    """Partial init (checkpoint.py:218-239): overwrite only the parameters
    whose JAX tree key starts with one of `module_prefixes`, from a `.npz`
    of either package or a reverb `.pt`."""
    new = convert.load_flat_checkpoint(ckpt_path)
    cur = convert.flat_from_state_dict(model.state_dict())
    for k in cur:
        if any(k.startswith(p) for p in module_prefixes) and k in new:
            cur[k] = new[k]
    model.load_state_dict(convert.state_dict_from_jax(cur), strict=True)
    return model


def should_force_snapshot(model_dir) -> bool:
    """Operator drops a `force_full_snapshot` file → next save includes the
    optimizer (checkpoint.py:241-264); the flag file is consumed."""
    flag = Path(model_dir) / FORCE_SNAPSHOT_FLAG
    if flag.exists():
        try:
            flag.unlink()
        except OSError:
            pass
        return True
    return False


def average_checkpoints(paths: List, out_path):
    """Average N `.npz` checkpoints array by array: accumulated in float64,
    divided by N, cast to float32 (as reverb_tpu's average_checkpoints, so
    either package's average holds the same arrays).  The best-N selection
    happens in the caller."""
    assert paths
    acc = None
    for p in paths:
        flat = convert.load_flat_checkpoint(p)
        if acc is None:
            acc = {k: v.astype(np.float64) for k, v in flat.items()}
        else:
            for k in acc:
                acc[k] += flat[k]
    n = len(paths)
    np.savez(out_path, **{k: (v / n).astype(np.float32)
                          for k, v in acc.items()})
    return out_path


def find_best_checkpoints(model_dir, n: int, key: str = 'cv_loss'
                          ) -> List[Path]:
    """The N checkpoints with the lowest `key` in their sidecar yamls."""
    scored = []
    for y in Path(model_dir).glob('*.yaml'):
        info = load_config(y) or {}
        if key in info and y.with_suffix('.npz').exists():
            scored.append((float(info[key]), y.with_suffix('.npz')))
    scored.sort()
    return [p for _, p in scored[:n]]
