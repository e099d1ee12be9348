"""Learning-rate schedules as plain step → lr functions.

Counterpart of reverb_tpu/train/scheduler.py, value for value.  The step is
the optimizer's update count before the update (optax's `count`, starting
at 0), so warmuplr and cosineannealing evaluate at step + 1 and
noamholdannealing at the step itself, as there.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_lr(lr: float, warmup_steps: int = 25000) -> Callable:
    def schedule(step: int) -> float:
        s = float(max(step + 1, 1))
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)
    return schedule


def steady_lr(lr: float, warmup_steps: int = 25000) -> Callable:
    """Constant lr: the reference SteadyLR ignores warmup_steps."""
    del warmup_steps

    def schedule(step: int) -> float:
        return lr
    return schedule


def noam_hold_annealing(lr: float, warmup_steps: int, hold_steps: int,
                        decay_rate: float = 0.5, min_lr: float = 0.0,
                        max_steps: int = 1_000_000) -> Callable:
    """Linear warmup lr·(s+1)/(warmup+1), hold at lr through warmup+hold,
    then lr·warmup^decay/(s−hold)^decay floored at min_lr; min_lr after
    max_steps."""
    def schedule(step: int) -> float:
        s = float(max(step, 0))
        if s > max_steps:
            return min_lr
        if s <= warmup_steps:
            return lr * (s + 1.0) / (warmup_steps + 1.0)
        if s <= warmup_steps + hold_steps:
            return lr
        t_warm = max(1.0, warmup_steps ** decay_rate)
        return max(lr * t_warm / max(s - hold_steps, 1.0) ** decay_rate,
                   min_lr)
    return schedule


def cosine_annealing(lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Callable:
    def schedule(step: int) -> float:
        s = float(max(step + 1, 1))
        if s <= warmup_steps:
            return lr * s / max(warmup_steps, 1)
        t = min(max((s - warmup_steps) / max(max_steps - warmup_steps, 1),
                    0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi * t))
    return schedule


def build_scheduler(name: str, lr: float, conf: dict) -> Callable:
    """Dispatch on configs['scheduler'] (case-insensitive)."""
    name = name.lower()
    conf = conf or {}
    if name == 'warmuplr':
        return warmup_lr(lr, conf.get('warmup_steps', 25000))
    if name == 'steadylr':
        return steady_lr(lr, conf.get('warmup_steps', 25000))
    if name == 'noamholdannealing':
        return noam_hold_annealing(
            lr, conf.get('warmup_steps', 25000), conf.get('hold_steps', 0),
            conf.get('decay_rate', 0.5), conf.get('min_lr', 0.0),
            conf.get('max_steps', 1_000_000))
    if name == 'cosineannealing':
        return cosine_annealing(lr, conf.get('warmup_steps', 25000),
                                conf.get('max_steps', 1_000_000),
                                conf.get('min_lr', 0.0))
    raise ValueError(f'unknown scheduler {name!r}')
