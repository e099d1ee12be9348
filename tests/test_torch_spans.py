"""The program's spans (utils/profiling.py:span) on the CPU, with a tiny
Whisper: the train step's spans nest in order under a torch profiler and
change no bit of the step; without a profiler `span` enters no
`record_function`; the executor's `train.data` span is in the
`ProfileWindow` trace of each of its steps after the first."""

import json

import numpy as np
import pytest
import torch

from reverb_tpu_torch.models.registry import init_model
from reverb_tpu_torch.train import trainer as ttr
from reverb_tpu_torch.train.executor import Executor
from reverb_tpu_torch.utils import profiling
from reverb_tpu_torch.utils.profiling import ProfileWindow

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

V = 60
CONF = {'model': 'whisper',
        'whisper_conf': {'n_mels': 16, 'n_audio_state': 32,
                         'n_audio_head': 2, 'n_audio_layer': 2, 'n_vocab': V,
                         'n_audio_ctx': 20, 'n_text_ctx': 12,
                         'n_text_state': 32, 'n_text_head': 2,
                         'n_text_layer': 2},
        'optim_conf': {'lr': 1e-3}, 'scheduler_conf': {'warmup_steps': 1}}


def host_batch(seed=0, B=4, T=30, L=6):
    rng = np.random.RandomState(seed)
    return {'feats': rng.randn(B, T, 16).astype(np.float32),
            'feats_lengths': np.full((B,), T, np.int32),
            'target': rng.randint(0, V, (B, L)).astype(np.int32),
            'target_lengths': np.full((B,), L, np.int32)}


def device_batch(seed=0):
    return {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32
                                      else torch.float32)
            for k, v in host_batch(seed).items()}


def setup(accum_grad=1):
    """A fresh Whisper, its Adam and a train step that clips (the clip
    lies under the first step's norm)."""
    bundle = init_model(CONF, torch.Generator().manual_seed(3), 'cpu')
    tc = ttr.TrainConfig.from_config(dict(CONF, accum_grad=accum_grad,
                                          grad_clip=0.1))
    opt, _ = ttr.build_optimizer(tc, bundle.model)
    step = ttr.make_train_step(bundle.model.cfg, opt, accum_grad,
                               tc.grad_clip, loss_fn=bundle.loss_fn)
    return bundle.model, step


READ = 'aten::_local_scalar_dense'   # float(t), t.item()


def profiled(fn):
    """fn()'s result and its trace's spans and scalar reads, in order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[5:] if e.name.startswith('span:') else e.name)
                   for e in prof.events()
                   if e.name.startswith('span:') or e.name == READ)
    return out, spans


@pytest.mark.parametrize('accum_grad', [1, 2])
def test_the_step_spans_nest_in_order(accum_grad):
    model, step = setup(accum_grad)
    metrics, spans = profiled(lambda: step(model, device_batch()))
    assert metrics['grad_norm'] > 0.1 and metrics['skipped'] == 0.0
    (s0, s1, _), = [s for s in spans if s[2] == 'train.step']
    assert all(s0 <= s <= e <= s1 for s, e, _ in spans)
    phases = [n for _, _, n in spans if n not in ('train.step', READ)]
    assert phases == (['train.forward', 'train.backward'] * accum_grad
                      + ['train.grad_norm', 'train.optimizer'])
    where = {n: (s, e) for s, e, n in spans}
    reads = [(s, e) for s, e, n in spans if n == READ]
    assert len(reads) == 2   # the norm, then the loss
    g0, g1 = where['train.grad_norm']
    assert g0 <= reads[0][0] <= reads[0][1] <= g1
    assert reads[1][0] >= where['train.optimizer'][1]


@pytest.mark.parametrize('accum_grad', [1, 2])
def test_the_profiler_changes_no_bit_of_the_step(accum_grad):
    (m_on, step_on), (m_off, step_off) = setup(accum_grad), setup(accum_grad)
    for seed in range(2):
        on, _ = profiled(lambda: step_on(m_on, device_batch(seed)))
        off = step_off(m_off, device_batch(seed))
        assert on == off
    for (name, p), q in zip(m_on.named_parameters(), m_off.parameters()):
        assert torch.equal(p, q), name


def test_without_a_profiler_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, 'record_function', counting)
    model, step = setup()
    step(model, device_batch())
    assert entered == []
    profiled(lambda: step(model, device_batch(1)))
    assert entered.count('span:train.step') == 1
    assert profiling.span('x') is profiling.span('y')


@pytest.mark.parametrize('num_steps', [2, 3])
def test_the_data_span_is_in_each_profiled_step(tmp_path, num_steps):
    """The window opens once a step's batch is on the device, so its
    trace holds `train.step` for each of its steps and `train.data` for
    each but the first; no batch is pulled past `max_steps`."""
    model, step = setup()
    prof = ProfileWindow(str(tmp_path / 'prof'), start_step=1,
                         num_steps=num_steps)
    ex = Executor(train_step=step, eval_step=None,
                  model_dir=str(tmp_path), device='cpu', profiler=prof)
    pulled = []

    def batches():
        for s in range(6):
            pulled.append(s)
            yield host_batch(s)
    ex.train(model, None, batches(), epoch=0, max_steps=4)
    assert ex.step == 4 and pulled == [0, 1, 2, 3] and prof.done
    events = json.loads((tmp_path / 'prof' / 'trace_step1.json').read_text())
    names = [e.get('name') for e in events['traceEvents']]
    assert names.count('span:train.step') == num_steps
    assert names.count('span:train.data') == num_steps - 1
