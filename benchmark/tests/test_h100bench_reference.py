"""The plain reference against the port run with its plain versions, on
the CPU at tiny widths: the training step (loss, gradients, update)."""

from __future__ import annotations

import math

import torch

from benchmark import core, weights as W
from benchmark.drivers import train_steps
from benchmark.reference import whisper as ref_whisper

torch.set_num_threads(1)


def test_training_steps_match_the_port(tiny):
    cell = core.Cell('whisper_tiny_train', tiny / 'BENCHMARK.json')
    core.set_precision('float32')
    prog = train_steps.TrainCell(cell, 11, torch.device('cpu'))
    readings = prog.checked_steps()
    batches = [prog.pool[i] for i in range(3)]
    want = ref_whisper.train_steps(cell.config, cell.config['training'], 11,
                                   batches, 'cpu')
    checks = train_steps.compare(readings, want, cell.traffic['limits'],
                                 cell.traffic['grad_floor'])
    assert checks['loss_gap']['value'] < 1e-5
    assert checks['grad_gap']['value'] < 1e-4
    assert checks['update_gap']['value'] < 1e-2
    assert all(math.isfinite(x) for x in readings['losses'])


def test_weights_are_one_stream():
    spec = [('a', (3, 5), 'fan_in'), ('b', (7,), 'small'),
            ('c', (W.CHUNK // 2 + 3,), 'ones')]
    one = W.state_dict(spec, 5, 'cpu')
    again = dict(W.leaves(spec, 5, 'cpu'))
    assert all(torch.equal(one[k], again[k]) for k in one)
    other = W.state_dict(spec, 6, 'cpu')
    assert not torch.equal(one['a'], other['a'])
    assert float((one['c'] - 1).abs().max()) < 0.2
