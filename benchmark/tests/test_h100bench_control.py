"""The control of each cell's correctness check, at the cell's own size on
the card: the reference in the program's place at the next precision
down (TF32 for the float32 Whisper step) comes out not correct.
Run on the card: python -m pytest benchmark/tests -m cuda."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import core


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['whisper_v3_train_b4'])
@pytest.mark.parametrize('seed', [2 ** 31 + 11, 424242])
def test_the_control_fails_its_cell(cell, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('the control is read at the cell\'s own size on the card')
    done = subprocess.run(
        [sys.executable, str(core.HERE / 'run.py'), '--workload', cell,
         '--seed', str(seed), '--seconds', '10', '--control'],
        capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line['correct'] is False, line['checks']
