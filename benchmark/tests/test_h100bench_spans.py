"""The readers of the program's spans and of its device-to-host reads on
hand-made traces, and the traced dry run: a kernel counts for the span
its host launch lies in, on any thread; a read is a device-to-host copy
launched inside `train.step`, and its idle is the gap that opens when it
ends."""

from __future__ import annotations

import json
import types

import pytest

from benchmark import core
from benchmark.readers import copy_count, copy_idle, span_device
from benchmark.tests.test_h100bench_data import run_copy


def span(ts, dur, name, tid=1):
    return {'ph': 'X', 'cat': 'user_annotation', 'ts': ts, 'dur': dur,
            'tid': tid, 'name': f'span:{name}'}


def kernel(ts, dur, corr, launch_ts, tid=1):
    """A kernel and its host launch on thread `tid`."""
    return [{'ph': 'X', 'cat': 'kernel', 'ts': ts, 'dur': dur,
             'name': f'k{corr}', 'args': {'correlation': corr}},
            {'ph': 'X', 'cat': 'cuda_runtime', 'ts': launch_ts, 'dur': 1.0,
             'tid': tid, 'name': 'cudaLaunchKernel',
             'args': {'correlation': corr}}]


def copy(ts, dur, corr, launch_ts, kind='DtoH (Device -> Pageable)'):
    """A memcpy on the card and its host launch on thread 1."""
    return [{'ph': 'X', 'cat': 'gpu_memcpy', 'ts': ts, 'dur': dur,
             'name': f'Memcpy {kind}', 'args': {'correlation': corr}},
            {'ph': 'X', 'cat': 'cuda_runtime', 'ts': launch_ts, 'dur': 1.0,
             'tid': 1, 'name': 'cudaMemcpyAsync',
             'args': {'correlation': corr}}]


READS = {'copy': 'Memcpy DtoH', 'within': 'train.step'}


def ctx(events, steps=1):
    return types.SimpleNamespace(trace=core.Trace(events), traced_steps=steps)


def test_a_kernel_counts_for_the_span_its_launch_lies_in():
    # train.backward on the main thread; one kernel launched from
    # autograd's thread inside it, one from the main thread after it
    c = ctx([span(0, 100, 'train.backward'),
             *kernel(20, 300, 1, 50, tid=2),
             *kernel(400, 40, 2, 150, tid=1)], steps=2)
    assert span_device.read(c, 'train.backward') == pytest.approx(0.15)
    assert span_device.read(c, 'train.optimizer') is None


def a_step_with_reads():
    """Two steps: busy [0, 100) ending in a read, [300, 350), [900, 960)
    ending in a read, [1000, 1010) a read outside `train.step`, and an
    HtoD copy inside it."""
    return ctx([span(0, 990, 'train.step'),
                *kernel(0, 90, 1, 0), *copy(90, 10, 2, 80),
                *kernel(300, 50, 3, 290), *copy(320, 5, 4, 295, 'HtoD'),
                *kernel(900, 50, 5, 880), *copy(950, 10, 6, 890),
                *copy(1000, 10, 7, 995), *kernel(1200, 10, 8, 1190)],
               steps=2)


def test_the_reads_are_the_device_to_host_copies_in_the_step():
    assert copy_count.read(a_step_with_reads(), **READS) == 1.0


def test_the_idle_of_a_read_is_the_gap_after_it():
    # the gaps after the reads at 100 and 960; not the one at 350 (a
    # kernel ends there) nor the one after the read outside the step
    assert copy_idle.read(a_step_with_reads(), **READS) == pytest.approx(
        (200 + 40) * 1e-3 / 2)


@pytest.mark.parametrize('events', [
    [], [span(0, 10, 'train.forward'), span(0, 10, 'train.step')],
    kernel(0, 5, 1, 0) + copy(5, 1, 2, 3)],
    ids=['empty', 'no kernels', 'no span'])
def test_nothing_to_read_gives_no_reading(events):
    c = ctx(events)
    assert span_device.read(c, 'train.forward') is None
    assert copy_count.read(c, **READS) is None
    assert copy_idle.read(c, **READS) is None


def test_a_traced_dry_run_reads_no_device_metric(tiny):
    """On the CPU the trace has no device event: the six readers give no
    reading, and the run's launch counters are the cell's own."""
    done = run_copy(tiny, '--workload', 'whisper_tiny_train', '--seed',
                    str(2 ** 31 + 5), '--seconds', '1', '--trace', '1',
                    '--dry-run')
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert not set(line['metric_names']) & {
        'forward_ms_per_step.train', 'backward_ms_per_step.train',
        'grad_norm_ms_per_step.train', 'adam_ms_per_step.train',
        'host_read_idle_ms_per_step.train', 'host_reads_per_step.train'}
    assert set(line['launches']) == {
        'reverb_tpu_torch.ops.layer_norm:LAUNCHES',
        'reverb_tpu_torch.ops.layer_norm:BWD_LAUNCHES'}
