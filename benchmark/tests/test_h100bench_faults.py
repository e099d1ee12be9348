"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip skipped (the CPU dry-run path), the rest of a
run driven at tiny widths with one fault planted in the program, once
for each fault the cell can have: a step that returns its state
unchanged, half of the batch left out, a token altered where it is
produced.  (The cell runs on one chip: there is no exchange between chips
to leave out.)"""

from __future__ import annotations

import time

import torch

from benchmark import core
from benchmark.drivers import train_steps

torch.set_num_threads(1)
CPU = torch.device('cpu')


def train_run(tiny, seed=202):
    cell = core.Cell('whisper_tiny_train', tiny / 'BENCHMARK.json')
    result, checks = train_steps.run(cell, seed, 0.5, False, CPU,
                                     time.perf_counter(), None)
    return result['correct'], checks


def test_sound_training_is_correct(tiny):
    ok, checks = train_run(tiny)
    assert ok, checks


# ------------------------------ training ------------------------------

def test_training_state_unchanged(tiny, monkeypatch):
    from reverb_tpu_torch.train import trainer

    def frozen(self, grads, scale=1.0):
        self.count += 1
        with torch.no_grad():
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 0.1))
    monkeypatch.setattr(trainer.Adam, 'step', frozen)
    ok, checks = train_run(tiny)
    assert not ok and not checks['update_gap']['ok']


def test_training_half_the_batch(tiny, monkeypatch):
    from reverb_tpu_torch.models import registry
    real = registry.whisper_loss

    def half(model, batch, generator=None):
        B = batch['feats'].shape[0]
        return real(model, {k: v[:max(B // 2, 1)] for k, v in batch.items()},
                    generator)
    monkeypatch.setattr(registry, 'whisper_loss', half)
    ok, checks = train_run(tiny)
    assert not ok


def test_training_token_altered(tiny, monkeypatch):
    from reverb_tpu_torch.models import registry
    real = registry.whisper_loss

    def altered(model, batch, generator=None):
        t = batch['target'].clone()
        t[0, 5] = (t[0, 5] + 1) % 249
        return real(model, dict(batch, target=t), generator)
    monkeypatch.setattr(registry, 'whisper_loss', altered)
    ok, checks = train_run(tiny)
    assert not ok and not checks['loss_gap']['ok']


def test_control_runs_on_the_cpu(tiny):
    """The control's path (the next precision down in the program's
    place) runs end to end; whether it fails its cell is read on the card
    at the cell's own size (test_h100bench_control.py)."""
    c = core.Cell('whisper_tiny_train', tiny / 'BENCHMARK.json')
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        result, checks = c.driver().run(c, 5, 0.5, False, CPU,
                                        time.perf_counter(), Path(d),
                                        control=True)
    assert set(checks) >= set(c.traffic['limits'])
