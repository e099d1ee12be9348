"""Config loading, dotted-path overrides, and the saved train.yaml.

Counterpart of reverb_tpu/utils/config.py (`override_config`,
`check_modify_and_save_config`; reference asr/wenet/utils/config.py:18 and
train_utils.py:261-292).  A config file is read with PyYAML where it is
installed and as JSON where it is not; the port writes its config and
info files as JSON objects, which YAML readers take as they are.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List


def load_config(path) -> Dict:
    """A YAML (or JSON) config file → dict."""
    with open(path, encoding='utf8') as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)


def save_config(obj: Dict, path):
    """Write `obj` as one JSON object (readable as YAML)."""
    with open(path, 'w', encoding='utf8') as f:
        f.write(json.dumps(obj, sort_keys=True, indent=1) + '\n')


def _parse_value(raw: str):
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(raw)
        except ValueError:
            return raw
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def override_config(configs: Dict, overrides: List[str]) -> Dict:
    configs = copy.deepcopy(configs)
    for item in overrides or []:
        assert '=' in item, f'bad override {item!r} (want a.b.c=value)'
        dotted, raw = item.split('=', 1)
        node = configs
        keys = dotted.split('.')
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _parse_value(raw)
    return configs


def check_modify_and_save_config(args, configs: Dict, symbol_table=None
                                 ) -> Dict:
    """Inject input/output dims and persist train.yaml
    (train_utils.py:261-292)."""
    ds_conf = configs.get('dataset_conf', {}) or {}
    feats_type = ds_conf.get('feats_type', 'fbank')
    if 'input_dim' not in configs:
        if feats_type == 'fbank':
            configs['input_dim'] = ds_conf.get('fbank_conf', {}).get(
                'num_mel_bins', 80)
        elif feats_type == 'log_mel_spectrogram':
            configs['input_dim'] = ds_conf.get(
                'log_mel_spectrogram_conf', {}).get('num_mel_bins', 80)
    if ds_conf.get('add_cat_emb'):
        configs['input_dim'] += int(
            ds_conf.get('cat_emb_conf', {}).get('emb_len', 1))
    if symbol_table is not None:
        configs['output_dim'] = len(symbol_table)
        configs['vocab_size'] = len(symbol_table)
    model_dir = getattr(args, 'model_dir', None)
    if model_dir:
        os.makedirs(model_dir, exist_ok=True)
        save_config(configs, os.path.join(model_dir, 'train.yaml'))
    return configs
