"""Stall detection for training (the port's copy of
reverb_tpu/train/watchdog.py).

Parity target: the reference's `wenet_join` gloo monitored_barrier
(asr/wenet/utils/train_utils.py:569-595, bin/train.py:147-156) — a stalled
peer (dead host, hung data pipeline) surfaces as a diagnosed failure
instead of a silent infinite wait.

  - `StepWatchdog` — a daemon thread that fires when no training step has
    completed for `timeout_s` (the executor calls `beat()` after each
    step).  On stall it logs a loud diagnosis; with `exit_on_stall=True`
    (or env REVERB_STALL_EXIT=1) it hard-exits the process so an external
    supervisor can tear down and restart the job.  If the main thread is
    merely slow (not blocked), `check()` raises in-band on the next step.
  - `epoch_barrier(tag)` — a `torch.distributed` barrier at epoch
    boundaries when a process group is initialised; a no-op in one
    process.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional


class StepWatchdog:
    """Fires when `beat()` hasn't been called for `timeout_s` seconds."""

    def __init__(self, timeout_s: float = 1800.0,
                 exit_on_stall: Optional[bool] = None,
                 poll_s: Optional[float] = None):
        self.timeout_s = float(timeout_s)
        if exit_on_stall is None:
            exit_on_stall = os.environ.get('REVERB_STALL_EXIT', '0') == '1'
        self.exit_on_stall = exit_on_stall
        self._poll_s = poll_s if poll_s is not None else \
            min(max(self.timeout_s / 10.0, 1.0), 60.0)
        self._last = time.monotonic()
        self._last_step = -1
        self.stalled = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self, step: int = -1):
        """Call after every completed training step."""
        self._last = time.monotonic()
        self._last_step = step
        self.stalled = False

    def check(self):
        """In-band check for callers that CAN raise (the executor calls it
        at the top of each loop iteration)."""
        if self.stalled:
            raise RuntimeError(
                f'training stalled: no step completed in {self.timeout_s:.0f}'
                f' s (last step {self._last_step}) — a peer process or the '
                'data pipeline is likely hung (wenet_join timeout '
                'equivalent)')

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self._poll_s):
            age = time.monotonic() - self._last
            if age > self.timeout_s and not self.stalled:
                self.stalled = True
                logging.error(
                    'StepWatchdog: no training step for %.0f s (last step '
                    '%d). A peer process or this host\'s data pipeline is '
                    'stalled; a process blocked inside a collective cannot '
                    'raise — %s',
                    age, self._last_step,
                    'hard-exiting for supervisor restart'
                    if self.exit_on_stall else
                    'set REVERB_STALL_EXIT=1 to hard-exit for supervisor '
                    'restart')
                if self.exit_on_stall:
                    os._exit(17)


def epoch_barrier(tag: str):
    """Cross-process sync at epoch boundaries (no-op in one process)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        logging.info('epoch barrier %s', tag)
        dist.barrier()
