"""A tiny cell for the benchmark's CPU tests: a copy of the benchmark
folder with a Whisper at tiny widths, in a temporary root with its own
BENCHMARK.json."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import core

torch.set_num_threads(1)

TINY_WHISPER = dict(d_model=64, encoder_layers=2, decoder_layers=2,
                    encoder_attention_heads=2, decoder_attention_heads=2,
                    encoder_ffn_dim=256, decoder_ffn_dim=256, num_mel_bins=16,
                    vocab_size=300, max_source_positions=100,
                    max_target_positions=64)


def tiny_root(dest: Path) -> Path:
    """dest/BENCHMARK.json with the cell `whisper_tiny_train` beside a
    copy of benchmark/."""
    shutil.copytree(core.HERE, dest / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    b = dest / 'benchmark'
    w = core.load_json(core.HERE / 'configs' / 'whisper_large_v3.json')
    w.update(TINY_WHISPER)
    (b / 'configs' / 'whisper_tiny.json').write_text(json.dumps(w))
    m = core.load_json(core.HERE / 'traffic' / 'whisper_b4_30s.json')
    m.update(batch=2, clip_s=2.0, pool_batches=3, prompt=[250, 251, 252, 253],
             eot=249, text_tokens=[5, 10], trace_steps=2)
    (b / 'traffic' / 'whisper_tiny_mix.json').write_text(json.dumps(m))
    bench = core.load_json(core.ROOT / 'BENCHMARK.json')
    bench['configs'].append(
        {'name': 'whisper_tiny', 'source': 'tiny', 'reduced': [], 'why': 't',
         'file': 'benchmark/configs/whisper_tiny.json'})
    bench['workloads'].append(
        {'name': 'whisper_tiny_train', 'config': 'whisper_tiny',
         'traffic': 'whisper_tiny_mix', 'chips': 1, 'why': 't'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'whisper_v3_train_b4' in m.get('workloads', []):
            m['workloads'].append('whisper_tiny_train')
    (dest / 'BENCHMARK.json').write_text(json.dumps(bench, indent=1))
    # the program beside the harness, as in a checkout
    (dest / 'reverb_tpu_torch').symlink_to(core.ROOT / 'reverb_tpu_torch')
    return dest


@pytest.fixture(scope='session')
def tiny(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp('tiny'))
