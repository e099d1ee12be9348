"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as files and entries (no file that is there
edited) are listed and run."""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import core


def digests(root: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / 'benchmark').rglob('*'))
            if p.is_file() and '__pycache__' not in p.parts}


def run_copy(root: Path, *args):
    return subprocess.run([sys.executable, str(root / 'benchmark' / 'run.py'),
                           *args], capture_output=True, text=True,
                          timeout=600, cwd=root)


def test_added_files_are_found_and_run(tiny, tmp_path):
    import shutil
    root = tmp_path / 'checkout'
    shutil.copytree(tiny, root, symlinks=True)
    before = digests(root)
    b = root / 'benchmark'
    conf = json.loads((b / 'configs' / 'whisper_tiny.json').read_text())
    conf['decoder_layers'] = 1
    (b / 'configs' / 'whisper_tiny2.json').write_text(json.dumps(conf))
    mix = json.loads((b / 'traffic' / 'whisper_tiny_mix.json').read_text())
    mix.update(pool_batches=2, text_tokens=[4, 6])
    (b / 'traffic' / 'whisper_tiny_mix2.json').write_text(json.dumps(mix))
    (b / 'metrics' / 'step_ms_p50.tiny2.json').write_text(
        json.dumps({'reader': 'step_p50'}))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'whisper_tiny2', 'source': 'tiny',
                             'file': 'benchmark/configs/whisper_tiny2.json',
                             'reduced': ['decoder_layers'], 'why': 't'})
    bench['workloads'].append({'name': 'whisper_tiny2_train',
                               'config': 'whisper_tiny2',
                               'traffic': 'whisper_tiny_mix2', 'chips': 1,
                               'why': 't'})
    bench['per_layer'].append({
        'name': 'step_ms_p50.tiny2', 'unit': 'ms', 'better': 'lower',
        'source': 'host_clock', 'layer': 'trainer',
        'moves': 'train_audio_s_per_s', 'workloads': ['whisper_tiny2_train']})
    bench['end_to_end'][0]['workloads'].append('whisper_tiny2_train')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    listed = run_copy(root, '--list')
    assert listed.returncode == 0, listed.stderr
    rows = {r['workload']: r for r in map(json.loads,
                                          listed.stdout.splitlines())}
    new = rows['whisper_tiny2_train']
    assert new['config'] == 'benchmark/configs/whisper_tiny2.json'
    assert new['traffic'] == 'benchmark/traffic/whisper_tiny_mix2.json'
    assert new['metrics'] == ['step_ms_p50.tiny2']
    assert new['readers'] == ['step_p50']
    done = run_copy(root, '--workload', 'whisper_tiny2_train', '--seed',
                    str(2 ** 31 + 77), '--seconds', '1', '--dry-run')
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['dry_run'] and line['metrics'] == {}
    after = digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_without_a_card_no_result(tiny):
    done = run_copy(tiny, '--workload', 'whisper_tiny_train', '--seed', '1',
                    '--seconds', '1', '--trace', '0')
    pytest.importorskip('torch')
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is here')
    assert done.returncode == 2
    assert done.stdout.strip() == ''


def test_without_the_program_no_result(tmp_path):
    import shutil
    shutil.copytree(core.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(core.ROOT / 'BENCHMARK.json', tmp_path)
    done = run_copy(tmp_path, '--workload', 'whisper_v3_train_b4', '--seed',
                    '1', '--seconds', '1', '--trace', '0', '--dry-run')
    assert done.returncode != 0
    assert done.stdout.strip() == ''


def test_a_traced_dry_run_reads_its_metrics(tiny):
    """The traced path (both profiler windows, trace parsing, every
    reader) runs end to end on the CPU; its numbers are not printed."""
    done = run_copy(tiny, '--workload', 'whisper_tiny_train', '--seed', '9',
                    '--seconds', '2', '--trace', '1', '--dry-run')
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line['dry_run'] and line['metrics'] == {}
    assert {'mfu.train', 'step_ms_p50.train'} <= set(line['metric_names'])
    assert set(line['launches']) == {
        'reverb_tpu_torch.ops.layer_norm:LAUNCHES',
        'reverb_tpu_torch.ops.layer_norm:BWD_LAUNCHES'}
