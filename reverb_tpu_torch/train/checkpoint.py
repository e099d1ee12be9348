"""Checkpoints in the JAX package's format.

Counterpart of reverb_tpu/train/checkpoint.py (`save_checkpoint`,
`load_checkpoint`, `load_trained_modules`, `should_force_snapshot`,
`average_checkpoints`, `find_best_checkpoints`): `<tag>.npz` holds the
parameters as flat float32 arrays under the JAX tree's keys (WeNet's
state-dict keys with the conv-module parameters flat, as
reverb_tpu/convert/torch_ckpt.py:save_npz writes them), `<tag>.yaml` the
info dict.  Each package loads the other's parameters.  The optimizer state
the port writes is its own, `<tag>.torch_opt.pt`; it also resumes from the
JAX package's `<tag>.opt.npz` (the optax state's leaves, `load_optax_state`).

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
    and into `optimizer` the port's `<tag>.torch_opt.pt`, or else the JAX
    package's `<tag>.opt.npz`, when one exists.  Returns the info dict of
    `<tag>.yaml` ({} without one)."""
    path = Path(path)
    state = convert.state_dict_from_jax(convert.load_flat_checkpoint(path))
    model.load_state_dict(state, strict=True)
    opt_path = path.with_suffix('.torch_opt.pt')
    if optimizer is not None:
        if opt_path.exists():
            optimizer.load_state_dict(torch.load(opt_path,
                                                 map_location='cpu'))
        elif path.with_suffix('.opt.npz').exists():
            load_optax_state(path.with_suffix('.opt.npz'), optimizer)
    info_path = path.with_suffix('.yaml')
    if not info_path.exists():
        return {}
    return load_config(info_path) or {}


_LIST_KEYS = ('encoders', 'decoders', 'language_layers', 'encoders0',
              'decoders3', 'experts')


def _tree_order_key(key: str):
    """Sort key of a flat JAX key in `jax.tree.flatten` order: dict keys
    sort as strings, the indices of the module lists (the JAX tree's lists,
    reverb_tpu/convert/torch_ckpt.py:_LIST_KEYS) as integers."""
    parts = key.split('.')
    return tuple((1, int(p), '') if i and p.isdigit()
                 and parts[i - 1] in _LIST_KEYS else (0, 0, p)
                 for i, p in enumerate(parts))


def _leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    """An npz leaf as a tensor; a bfloat16 leaf (stored by ml_dtypes,
    read back as 2-byte raw values without it) keeps its bits."""
    if arr.dtype.itemsize == 2 and arr.dtype.kind in 'Vf' and \
            arr.dtype != np.float16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_optax_state(path, optimizer):
    """Load the JAX package's `<tag>.opt.npz` into the port's Adam or
    NovoGrad.  Its keys are `leaf_i` in `jax.tree.flatten` order of the
    optax state: the chain's states in order — scale_by_adam's or
    scale_by_novograd's (count, mu, nu), each moment a tree of the
    parameters with its dict keys sorted, then the schedule's count (the
    weight decay and the frozen mask hold no leaf).  Moments are loaded for
    the trainable parameters; a file of another layout raises."""
    with np.load(path, allow_pickle=False) as data:
        leaves = [data[f'leaf_{i}'] for i in range(len(data.files))]
    names = optimizer.names
    # a predictor LSTM's second bias has no leaf (convert.py)
    leafy = sorted(((convert.tree_key(nm), nm) for nm in names
                    if not convert.lstm_second_bias(nm)),
                   key=lambda kn: _tree_order_key(kn[0]))
    n = len(leafy)
    if len(leaves) != 2 * n + 2:
        raise ValueError(
            f'{path}: {len(leaves)} optax leaves, expected {2 * n + 2} '
            f'(count, {n} mu, {n} nu, the schedule count) for the '
            f'{type(optimizer).__name__} of this model')
    mu = {nm: leaves[1 + j] for j, (_, nm) in enumerate(leafy)}
    nu = {nm: leaves[1 + n + j] for j, (_, nm) in enumerate(leafy)}
    state = {'count': int(leaves[0]), 'mu': {}, 'nu': {}}
    for i, m, v in zip(optimizer.train_idx, optimizer.mu, optimizer.nu):
        name = names[i]
        for part, want, leaf in (('mu', m, mu[name]), ('nu', v, nu[name])):
            t = _leaf_tensor(leaf)
            if t.shape != want.shape or t.dtype != want.dtype:
                raise ValueError(
                    f'{path}: the {part} leaf of {name} is {t.dtype} '
                    f'{tuple(t.shape)}, the optimizer holds {want.dtype} '
                    f'{tuple(want.shape)}')
            state[part][name] = t
    optimizer.load_state_dict(state)
    logging.info('%s: optax state loaded at count %d', path, state['count'])


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
