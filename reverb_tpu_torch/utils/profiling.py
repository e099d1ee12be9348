"""Profiling window for training (counterpart of
reverb_tpu/utils/profiling.py, on torch.profiler).

`ProfileWindow(logdir, start_step, num_steps)` traces the steps
[start, start + n) of a step loop — the host's ops and the card's kernels —
and writes a Chrome trace (`trace_step<start>.json`, readable in Perfetto
or chrome://tracing) into `logdir`:

    prof = ProfileWindow(logdir, start_step=10, num_steps=5)
    for ...:
        prof.maybe_start(step); ...; prof.maybe_stop(step)

`span(name)` marks a phase of the program in that trace:

    with span('train.forward'):
        ...

While a torch profiler records (this window, or any other), it is a
`span:<name>` range on the host's timeline, on the clock the profiler
aligns the card's kernels to; the ranges opened inside it nest in it.
Otherwise it does nothing, at the cost of one check.  It never
synchronises with the device or reads from it.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `span:<name>` range in the recording profiler's trace, or a
    no-op context when no profiler records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function('span:' + name)
    return _OFF


class ProfileWindow:
    """Start/stop a torch.profiler trace over a step window ([start,
    start + n))."""

    def __init__(self, logdir: str | None, start_step: int = 10,
                 num_steps: int = 5):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._first = None
        self.done = False

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def maybe_start(self, step: int):
        if (self.logdir and not self.done and not self._active
                and self.start_step <= step < self.stop_step):
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            logging.info('profiler: starting trace at step %d → %s', step,
                         self.logdir)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._first = step

    def maybe_stop(self, step: int):
        if self._active and step + 1 >= self.stop_step:
            self._finish()
            logging.info('profiler: stopped trace at step %d', step)

    def close(self):
        if self._active:
            self._finish()

    def _finish(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.logdir, f'trace_step{self._first}.json'))
        self.done = True
