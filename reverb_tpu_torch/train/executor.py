"""Training executor: epoch loop, CV, snapshots, telemetry.

Counterpart of reverb_tpu/train/executor.py (`Executor.train`, `cv`,
`_snapshot`, `_log`) with its fields and snapshot rules.  Parity targets:
  - Executor.train/cv                asr/wenet/utils/executor.py:51-285
    (mid-epoch step snapshots every save_interval with CV run, full snapshot
     every save_optimizer_every-th, frames-seen telemetry, fixed-steps
     semantics instead of a join)
  - epoch loop / ckpt metadata yaml  asr/wenet/bin/train.py:140-196
  - log_per_step                     utils/train_utils.py:712-764

The step is `train/trainer.py:make_train_step`'s: it takes the model, the
batch on the device and the dropout generator, updates the model in place
and returns its metrics as floats (one host read a step).  A batch's numpy
arrays go to the device from pinned memory with non_blocking copies
(parallel/mesh.py:put_batch).

Over a mesh (`sharding`: parallel/sharding.py) each rank's batch is its
own partition's; every rank runs the CV (the whole CV list, as every JAX
process reads it) with ZeRO-3 parameters gathered, and its metrics are
averaged over 'data'; checkpoints are written by rank 0 from the gathered
single-process layout (`save`).
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from reverb_tpu_torch.data.pipeline import mystats
from reverb_tpu_torch.parallel.mesh import put_batch
from reverb_tpu_torch.train.checkpoint import (save_checkpoint,
                                               should_force_snapshot)
from reverb_tpu_torch.utils.profiling import span


def _device_batch(batch: Dict, device) -> Dict:
    """Drop host-only fields (keys, langs, tasks); ship the numpy arrays to
    `device` (int32 as int64, the index dtype of the loss), from pinned
    memory on a CUDA device."""
    return put_batch(batch, None, device)


# seed of the generator a CV (and bin/get_loss) draws dynamic chunks from
CV_SEED = 0


@dataclass
class Executor:
    train_step: Callable                # (model, batch, generator) → floats
    eval_step: Callable       # (model, batch, generator) → floats
    model_dir: str
    log_interval: int = 100
    save_interval: int = 0              # mid-epoch snapshot cadence (steps)
    save_optimizer_every: int = 4       # every Nth snapshot keeps optimizer
    schedule: Optional[Callable] = None
    writer: Optional[object] = None     # tensorboard-like .add_scalar
    save_to_tracker: bool = False       # snapshot_saving_conf.save_to_wandb
    # snapshot_saving_conf.use_named_snapshots (checkpoint.py:157-168):
    # True → one checkpoint per step tag; False → overwrite a single rolling
    # 'snapshot[_and_optimizer]' file (bounded disk)
    use_named_snapshots: bool = True
    run_tag: Optional[str] = None       # snapshot_saving_conf.run_tag
    device: object = 'cuda'
    step: int = 0
    frames_seen: float = 0.0
    snapshots_taken: int = 0
    profiler: Optional[object] = None   # utils.profiling.ProfileWindow
    watchdog: Optional[object] = None   # train.watchdog.StepWatchdog
    sharding: Optional[object] = None   # parallel.sharding.Sharding

    def train(self, model, optimizer, dataset: Iterable, epoch: int,
              generator: Optional[torch.Generator] = None,
              cv_dataset: Optional[Iterable] = None,
              max_steps: Optional[int] = None):
        """One pass over `dataset` (or up to `max_steps` steps in all);
        the model and optimizer are updated in place.  The wait for each
        batch and its copy to the device are the span `train.data`
        (utils/profiling.py:span); the profiler's window opens after it,
        so its trace holds the data of every step but its first."""
        t0 = time.time()
        batches = iter(dataset)
        while max_steps is None or self.step < max_steps:
            with span('train.data'):
                batch = next(batches, None)
                if batch is None:
                    break
                on_device = _device_batch(batch, self.device)
            if self.watchdog is not None:
                self.watchdog.check()
            if self.profiler is not None:
                self.profiler.maybe_start(self.step)
            metrics = self.train_step(model, on_device, generator)
            if self.profiler is not None:
                self.profiler.maybe_stop(self.step)
            self.step += 1
            if self.watchdog is not None:
                self.watchdog.beat(self.step)
            self.frames_seen += float(np.sum(batch['feats_lengths']))
            if self.step % self.log_interval == 0:
                self._log('TRAIN', epoch, metrics, t0)
                t0 = time.time()
            if self.save_interval and self.step % self.save_interval == 0:
                self._snapshot(model, optimizer, epoch, cv_dataset)
        if self.profiler is not None:
            self.profiler.close()
        return model, optimizer

    def cv(self, model, dataset: Iterable) -> Dict[str, float]:
        """Mean metrics over `dataset`; a dynamic-chunk model's chunks
        come from a generator seeded with CV_SEED, so every CV of a run
        draws the same chunks."""
        tot: Dict[str, float] = {}
        n = 0
        gen = torch.Generator(device=self.device).manual_seed(CV_SEED)
        full = (self.sharding.full_params() if self.sharding is not None
                else contextlib.nullcontext())
        with full:
            for batch in dataset:
                m = self.eval_step(model, _device_batch(batch, self.device),
                                   gen)
                bs = batch['feats'].shape[0]
                for k, v in m.items():
                    tot[k] = tot.get(k, 0.0) + float(v) * bs
                n += bs
        out = {k: v / max(n, 1) for k, v in tot.items()}
        if self.sharding is not None and out:
            # each data rank read the whole CV list: the mean over 'data'
            # is every rank's value, and keeps the ranks one
            out = {k: v / self.sharding.data_size for k, v in
                   self.sharding.sum_over_data(out).items()}
        return out

    def save(self, tag: str, model, optimizer, info: Dict):
        """save_checkpoint of the single-process layout; over a mesh every
        rank gathers and rank 0 writes.  Returns the npz path (None on
        other ranks)."""
        if self.sharding is None:
            return save_checkpoint(self.model_dir, tag, model, optimizer,
                                   info)
        path = None
        with self.sharding.gathered():
            if torch.distributed.get_rank() == 0:
                path = save_checkpoint(self.model_dir, tag, model,
                                       optimizer, info)
        torch.distributed.barrier()
        return path

    # ------------------------------ internals ------------------------------

    def _snapshot(self, model, optimizer, epoch, cv_dataset):
        self.snapshots_taken += 1
        with_opt = (self.save_optimizer_every > 0 and
                    self.snapshots_taken % self.save_optimizer_every == 0)
        if should_force_snapshot(self.model_dir):
            with_opt = True
        info = {'step': self.step, 'epoch': epoch,
                'frames_seen': self.frames_seen,
                'lr': float(self.schedule(self.step)) if self.schedule
                else None,
                'tag': f'step_{self.step}'}
        if self.run_tag:
            info['run_tag'] = self.run_tag
        if cv_dataset is not None:
            cv_metrics = self.cv(model, cv_dataset)
            info['cv_loss'] = cv_metrics.get('loss')
            logging.info('CV at step %d: %s', self.step, cv_metrics)
        name = (f'step_{self.step}' if self.use_named_snapshots
                else ('snapshot_and_optimizer' if with_opt else 'snapshot'))
        path = self.save(name, model, optimizer if with_opt else None,
                         info)
        if path is not None and self.save_to_tracker and \
                hasattr(self.writer, 'log_artifact'):
            # ckpt artifact upload (utils/checkpoint.py:180-190)
            self.writer.log_artifact(f'ckpt-step_{self.step}', 'checkpoint',
                                     {path.name: str(path),
                                      f'{name}.yaml':
                                      str(path.with_suffix('.yaml'))})

    def _log(self, tag, epoch, metrics, t0):
        lr = float(self.schedule(self.step)) if self.schedule else float('nan')
        msg = {k: round(float(v), 4) for k, v in metrics.items()}
        logging.info('%s epoch %d step %d lr %.3e %s (%.2fs/%d steps, '
                     'stats %s)', tag, epoch, self.step, lr, msg,
                     time.time() - t0, self.log_interval, dict(mystats))
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(f'{tag.lower()}/{k}', float(v),
                                       self.step)
            self.writer.add_scalar('train/lr', lr, self.step)
