"""Global CMVN statistics loading.

Counterpart of reverb_tpu/frontend/cmvn.py (JSON and Kaldi-text stats).
The stats become the encoder's `global_cmvn` buffers (mean, istd); the
encoder applies (x - mean) * istd.
"""

from __future__ import annotations

import json

import numpy as np


def _finalize(means, variance, count):
    means = np.asarray(means, dtype=np.float64) / count
    var = np.asarray(variance, dtype=np.float64) / count - means * means
    var = np.maximum(var, 1.0e-20)
    istd = 1.0 / np.sqrt(var)
    return means.astype(np.float32), istd.astype(np.float32)


def _load_json_cmvn(path):
    with open(path) as f:
        stats = json.load(f)
    return _finalize(stats['mean_stat'], stats['var_stat'], stats['frame_num'])


def _load_kaldi_cmvn(path):
    with open(path) as f:
        arr = f.read().split()
    if not (arr[0] == '[' and arr[-1] == ']' and arr[-2] == '0'):
        raise ValueError(f'{path}: expected kaldi text-format cmvn stats')
    feat_dim = (len(arr) - 4) // 2
    means = [float(x) for x in arr[1:1 + feat_dim]]
    count = float(arr[feat_dim + 1])
    variance = [float(x) for x in arr[feat_dim + 2:2 * feat_dim + 2]]
    return _finalize(means, variance, count)


def load_cmvn(path, is_json: bool = True):
    """Returns (mean, istd) float32 arrays of shape (feat_dim,)."""
    if is_json:
        return _load_json_cmvn(path)
    return _load_kaldi_cmvn(path)


def load_cmvn_from_configs(configs):
    """(mean, istd) from a reference-schema config dict, or None when no
    global CMVN is configured (reverb_tpu/frontend/cmvn.py:
    load_cmvn_from_configs; a trained model carries the stats the serving
    CLI applies)."""
    if configs.get('cmvn') != 'global_cmvn':
        return None
    conf = configs.get('cmvn_conf', {}) or {}
    path = conf.get('cmvn_file')
    if not path:
        return None
    return load_cmvn(path, conf.get('is_json_cmvn', True))
