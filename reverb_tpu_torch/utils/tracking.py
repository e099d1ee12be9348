"""Experiment tracking: wandb / tensorboard / JSONL backends behind one API.

The port's copy of reverb_tpu/utils/tracking.py.  Parity: the reference's
wandb integration — `init_wandb` logs the config and uploads code-tree /
train+dev data-list / tokenizer artifacts at launch
(asr/wenet/utils/train_utils.py:495-533), `log_per_step` mirrors scalars to
wandb+tensorboard (train_utils.py:712-764), `save_checkpoint` uploads ckpt
artifacts when snapshot_saving_conf.save_to_wandb (utils/checkpoint.py:180-190)
and `download_checkpoint_from_wandb` restores them (checkpoint.py:266-290).

Trackers expose the tensorboard `add_scalar` interface the Executor writes
to.  The JSONL backend is always available: it appends one line per logged
step to `<model_dir>/metrics.jsonl` and records artifacts as
content-hashed manifest entries instead of uploads.  TensorBoard and wandb
are imported only when asked for (wandb when the package and WANDB_KEY are
present, as in the reference).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class Tracker:
    """No-op base; also the common interface (tensorboard-writer compatible)."""

    def add_scalar(self, tag: str, value: float, step: int):
        pass

    def log_metrics(self, metrics: Dict[str, float], step: int):
        for k, v in metrics.items():
            if v is not None:
                self.add_scalar(k, float(v), step)

    def log_artifact(self, name: str, type: str, files: Dict[str, str]):
        """files: {name_in_artifact: local_path} (dirs allowed)."""

    def get_artifact(self, name: str) -> Optional[str]:
        """Return a local dir for a previously logged artifact, if possible."""
        return None

    def finish(self):
        pass


class JsonlTracker(Tracker):
    """Offline tracker: metrics.jsonl + artifacts manifest under model_dir."""

    def __init__(self, model_dir: str):
        os.makedirs(model_dir, exist_ok=True)
        self._metrics_path = os.path.join(model_dir, 'metrics.jsonl')
        self._manifest_path = os.path.join(model_dir, 'artifacts.jsonl')
        self._buf = {}
        self._buf_step = None

    def add_scalar(self, tag: str, value: float, step: int):
        # coalesce scalars of one step into one JSON line
        if self._buf_step is not None and step != self._buf_step:
            self._flush()
        self._buf_step = step
        self._buf[tag] = float(value)

    def _flush(self):
        if self._buf:
            rec = {'step': self._buf_step, 'ts': time.time(), **self._buf}
            with open(self._metrics_path, 'a') as f:
                f.write(json.dumps(rec) + '\n')
            self._buf = {}
            self._buf_step = None

    @staticmethod
    def _hash(path: str) -> str:
        h = hashlib.sha256()
        with open(path, 'rb') as f:
            for chunk in iter(lambda: f.read(1 << 20), b''):
                h.update(chunk)
        return h.hexdigest()

    def log_artifact(self, name: str, type: str, files: Dict[str, str]):
        entries = []
        for aname, path in files.items():
            if os.path.isdir(path):
                for root, _, fnames in os.walk(path):
                    for fn in sorted(fnames):
                        p = os.path.join(root, fn)
                        entries.append({'name': os.path.join(
                            aname, os.path.relpath(p, path)),
                            'path': os.path.abspath(p),
                            'sha256': self._hash(p),
                            'bytes': os.path.getsize(p)})
            elif os.path.exists(path):
                entries.append({'name': aname, 'path': os.path.abspath(path),
                                'sha256': self._hash(path),
                                'bytes': os.path.getsize(path)})
        with open(self._manifest_path, 'a') as f:
            f.write(json.dumps({'artifact': name, 'type': type,
                                'ts': time.time(), 'files': entries}) + '\n')

    def finish(self):
        self._flush()


class TensorBoardTracker(Tracker):
    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(logdir)

    def add_scalar(self, tag, value, step):
        self._w.add_scalar(tag, value, step)

    def finish(self):
        self._w.flush()


class WandbTracker(Tracker):
    """wandb backend; requires the package plus WANDB_KEY/WANDB_HOST env
    (train_utils.py:505-513 contract)."""

    def __init__(self, project: str, configs: dict):
        import wandb
        if os.environ.get('WANDB_KEY'):
            wandb.login(host=os.environ.get('WANDB_HOST'),
                        key=os.environ['WANDB_KEY'])
        self._wandb = wandb
        self._run = wandb.init(project=project, config=configs,
                               job_type='training')

    def add_scalar(self, tag, value, step):
        self._wandb.log({tag: value}, step=step)

    def log_artifact(self, name, type, files):
        art = self._wandb.Artifact(name, type=type)
        for aname, path in files.items():
            if os.path.isdir(path):
                art.add_dir(path)
            elif os.path.exists(path):
                art.add_file(path, name=aname)
        self._wandb.log_artifact(art)

    def get_artifact(self, name):
        # checkpoint.py:266-290: download a ckpt artifact back to disk
        art = self._run.use_artifact(name)
        return art.download()

    def finish(self):
        self._wandb.finish()


class MultiTracker(Tracker):
    def __init__(self, trackers):
        self.trackers = list(trackers)

    def add_scalar(self, tag, value, step):
        for t in self.trackers:
            t.add_scalar(tag, value, step)

    def log_artifact(self, name, type, files):
        for t in self.trackers:
            t.log_artifact(name, type, files)

    def get_artifact(self, name):
        for t in self.trackers:
            d = t.get_artifact(name)
            if d:
                return d
        return None

    def finish(self):
        for t in self.trackers:
            t.finish()


def init_tracking(model_dir: str, configs: dict, train_data: str = None,
                  cv_data: str = None, tensorboard_dir: str = None,
                  code_dir: str = None) -> Tracker:
    """Rank-0 tracker with launch-time artifacts (train_utils.py:495-533).

    Always includes the JSONL backend; adds tensorboard when a dir is given
    and wandb when importable + WANDB_KEY is set.
    """
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return Tracker()
    exp_id = os.path.basename(os.path.normpath(model_dir))
    trackers = [JsonlTracker(model_dir)]
    if tensorboard_dir:
        try:
            trackers.append(TensorBoardTracker(
                os.path.join(tensorboard_dir, exp_id)))
        except Exception:                                   # noqa: BLE001
            logger.warning('tensorboard unavailable; skipping')
    try:
        import wandb                                        # noqa: F401
        if os.environ.get('WANDB_KEY'):
            project = os.environ.get('WANDB_PROJECT') or exp_id
            trackers.append(WandbTracker(project, configs))
    except ImportError:
        pass
    tracker = MultiTracker(trackers)

    # launch artifacts: code tree, data lists, tokenizer files
    if code_dir is None:
        code_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tracker.log_artifact('reverb-tpu-torch-tree', 'code',
                         {'reverb_tpu_torch': code_dir})
    if train_data:
        tracker.log_artifact('training_data_list', 'train_dataset',
                             {'train.list': train_data})
    if cv_data:
        tracker.log_artifact('dev_data_list', 'dev_dataset',
                             {'dev.list': cv_data})
    tk_conf = configs.get('tokenizer_conf') or {}
    tk_files = {}
    if tk_conf.get('bpe_path'):
        tk_files['tk.model'] = tk_conf['bpe_path']
    if tk_conf.get('symbol_table_path'):
        tk_files['tk.units.txt'] = tk_conf['symbol_table_path']
    if tk_files:
        tracker.log_artifact('tokenizer', 'tokenizer', tk_files)
    return tracker
