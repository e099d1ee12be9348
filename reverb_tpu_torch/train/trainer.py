"""Training step: Adam/AdamW/NovoGrad with a schedule, gradient accumulation, one
global-norm pass for clipping, the non-finite skip and the metric, and the
freeze rules.

Counterpart of reverb_tpu/train/trainer.py (`TrainConfig`,
`trainable_mask`, `build_optimizer`, `make_train_step`, `make_eval_step`),
with the same
update arithmetic as its optax chain:

    mu = b1·mu + (1−b1)·g,  nu = b2·nu + (1−b2)·g²        (g after the clip)
    u  = (mu / (1−b1^n)) / (sqrt(nu / (1−b2^n)) + eps)  [+ wd·p]
    p  = p − lr(count)·u                 n = count + 1, count from 0

Every parameter takes a gradient and counts in the global norm, frozen ones
included, as in JAX (whose grad covers the whole tree); frozen parameters
(`freeze_modules`, `restrict_learning`, and always `global_cmvn`) are left
out of the update, weight decay included.  A non-finite norm skips the
update: parameters, moments and the schedule's count stay as they were.
The skip decision reads the norm on the host once per step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from reverb_tpu_torch.convert import lstm_second_bias, tree_key
from reverb_tpu_torch.frontend.device_feats import (FrontendSpec,
                                                    apply_frontend)
from reverb_tpu_torch.models.asr_model import ModelConfig, compute_loss
from reverb_tpu_torch.parallel import global_batch as gb
from reverb_tpu_torch.parallel.mesh import axis_ranks
from reverb_tpu_torch.train.scheduler import build_scheduler
from reverb_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainConfig:
    optim: str = 'adam'
    optim_conf: Dict = dataclasses.field(default_factory=lambda: {'lr': 1e-3})
    scheduler: str = 'warmuplr'
    scheduler_conf: Dict = dataclasses.field(
        default_factory=lambda: {'warmup_steps': 25000})
    grad_clip: float = 50.0
    accum_grad: int = 1
    freeze_modules: List[str] = dataclasses.field(default_factory=list)
    restrict_learning: Optional[List[Dict[str, str]]] = None

    @staticmethod
    def from_config(configs: Dict) -> 'TrainConfig':
        return TrainConfig(
            optim=configs.get('optim', 'adam'),
            optim_conf=dict(configs.get('optim_conf', {'lr': 1e-3})),
            scheduler=configs.get('scheduler', 'warmuplr'),
            scheduler_conf=dict(configs.get('scheduler_conf', {}) or {}),
            grad_clip=configs.get('grad_clip', 50.0),
            accum_grad=configs.get('accum_grad', 1),
            freeze_modules=list(configs.get('freeze_modules', []) or []),
            restrict_learning=configs.get('restrict_learning'))


def trainable_mask(model: torch.nn.Module, tc: TrainConfig) -> Dict[str, bool]:
    """{parameter name: trains?}.  Rules match the JAX tree's path of the
    parameter (the conv-module keys without `.conv_module.`): global_cmvn
    never trains, then `freeze_modules` prefixes, then the
    `restrict_learning` include/exclude regexes in order, first match
    wins; the default is trainable.  A predictor LSTM's second bias
    (`convert.lstm_second_bias`, no JAX leaf) never trains, nor does a
    parameter whose requires_grad is off (the frozen base of a LoRA
    model, train/lora.py:lora_trainable_mask)."""
    rules = []
    for item in (tc.restrict_learning or []):
        if 'include' in item:
            rules.append((re.compile(item['include']), True))
        if 'exclude' in item:
            rules.append((re.compile(item['exclude']), False))

    def decide(path: str) -> bool:
        if 'global_cmvn' in path:
            return False
        if any(path.startswith(prefix) for prefix in tc.freeze_modules):
            return False
        for pat, keep in rules:
            if pat.search(path):
                return keep
        return True

    return {name: (p.requires_grad and not lstm_second_bias(name)
                   and decide(tree_key(name)))
            for name, p in model.named_parameters()}


def _f32_pow_complement(decay: float, n: int) -> float:
    """1 − decay^n in float32, as optax's bias correction computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(n))


_MU_DTYPES = {'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
              'float16': torch.float16, 'float32': torch.float32}


class _Optimizer:
    """Moments over the trainable parameters of a model, and optax's
    count: the number of applied updates, at which the schedule is
    evaluated before it advances.

    The JAX package's optax state also holds moments for frozen leaves and
    masks only their final update; here frozen parameters have no moments,
    which gives the same trainable updates (each moment is per parameter:
    elementwise for Adam, per leaf for NovoGrad)."""

    def __init__(self, model: torch.nn.Module, schedule: Callable,
                 trainable: Dict[str, bool]):
        self.schedule = schedule
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.train_idx = [i for i, n in enumerate(self.names) if trainable[n]]
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        self.count = 0
        # set by parallel/sharding.py under ZeRO: each trainable
        # parameter's block this rank updates, and the per-leaf ‖g‖² of
        # NovoGrad summed over the blocks
        self.views: Optional[List[Callable]] = None
        self.leaf_sq: Optional[Callable] = None

    def _trainable(self, grads, scale):
        params = [self.params[i] for i in self.train_idx]
        g = [grads[i] for i in self.train_idx]
        if self.views is not None:
            params = [v(t) for v, t in zip(self.views, params)]
            g = [v(t) for v, t in zip(self.views, g)]
        if scale != 1.0:
            g = torch._foreach_mul(g, scale)
        return params, g

    def state_dict(self) -> Dict:
        names = [self.names[i] for i in self.train_idx]
        return {'count': self.count,
                'mu': dict(zip(names, self.mu)),
                'nu': dict(zip(names, self.nu))}

    def load_state_dict(self, state: Dict):
        names = [self.names[i] for i in self.train_idx]
        with torch.no_grad():
            for dst, src in ((self.mu, state['mu']), (self.nu, state['nu'])):
                for t, n in zip(dst, names):
                    t.copy_(torch.as_tensor(src[n]))
        self.count = int(state['count'])


class Adam(_Optimizer):
    """optax.adam / optax.adamw over the trainable parameters of a model.

    With `mu_dtype` (optim_conf.mu_dtype) the first moment is stored in
    that dtype, in optax.scale_by_adam's order: b1·mu is taken in the
    stored dtype (the JAX package's weakly typed b1 is rounded to it too),
    added to (1−b1)·g in f32, the update is taken from that f32 moment,
    and only then is the moment stored rounded.  nu stays f32.  (XLA may
    keep the product in f32 inside a fused program; this is the op-by-op
    arithmetic of the optax code.)"""

    def __init__(self, model: torch.nn.Module, schedule: Callable,
                 trainable: Dict[str, bool], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype=None):
        super().__init__(model, schedule, trainable)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, \
            weight_decay
        self.mu_dtype = mu_dtype
        with torch.no_grad():
            self.mu = [torch.zeros_like(self.params[i], dtype=mu_dtype)
                       for i in self.train_idx]
            self.nu = [torch.zeros_like(self.params[i])
                       for i in self.train_idx]

    def step(self, grads: List[torch.Tensor], scale: float = 1.0):
        """One update from `grads` (aligned with self.params) × scale."""
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            params, g = self._trainable(grads, scale)
            if self.mu_dtype is None:
                torch._foreach_mul_(self.mu, b1)
                torch._foreach_add_(self.mu, g, alpha=1.0 - b1)
                mu = self.mu
            else:
                decay = torch.tensor(b1, dtype=self.mu_dtype,
                                     device=self.mu[0].device)
                mu = torch._foreach_mul(g, 1.0 - b1)
                torch._foreach_add_(mu, [m.float() for m in
                                         torch._foreach_mul(self.mu, decay)])
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, g, g, value=1.0 - b2)
            denom = torch._foreach_div(
                self.nu, _f32_pow_complement(b2, self.count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu, _f32_pow_complement(b1, self.count))
            torch._foreach_div_(upd, denom)
            if self.mu_dtype is not None:
                torch._foreach_copy_(self.mu, mu)
            if self.weight_decay:
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
            torch._foreach_add_(params, upd, alpha=-lr)


class NovoGrad(_Optimizer):
    """optax.novograd over the trainable parameters of a model
    (optax.scale_by_novograd, then the schedule), with optax.novograd's
    defaults.  nu is one scalar per parameter (a leaf of the JAX tree):

        step 1:  nu = ‖g‖²,                 mu = g/(√(nu+eps_root)+eps) + wd·p
        later:   nu = (1−b2)·‖g‖² + b2·nu,  mu = b1·mu + that
        p = p − lr(count)·mu                (no bias correction)"""

    def __init__(self, model: torch.nn.Module, schedule: Callable,
                 trainable: Dict[str, bool], b1: float = 0.9,
                 b2: float = 0.25, eps: float = 1e-6, eps_root: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(model, schedule, trainable)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay
        with torch.no_grad():
            self.mu = [torch.zeros_like(self.params[i])
                       for i in self.train_idx]
            self.nu = [torch.zeros((), dtype=self.params[i].dtype,
                                   device=self.params[i].device)
                       for i in self.train_idx]

    def step(self, grads: List[torch.Tensor], scale: float = 1.0):
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            params, g = self._trainable(grads, scale)
            sq = [n * n for n in torch._foreach_norm(g)]
            if self.leaf_sq is not None:
                sq = self.leaf_sq(sq)
            if self.count == 1:
                torch._foreach_copy_(self.nu, sq)
            else:
                torch._foreach_mul_(self.nu, b2)
                torch._foreach_add_(self.nu, sq, alpha=1.0 - b2)
            denom = torch._foreach_add(self.nu, self.eps_root)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            add = torch._foreach_div(g, denom)
            if self.weight_decay:
                torch._foreach_add_(add, params, alpha=self.weight_decay)
            if self.count == 1:
                torch._foreach_copy_(self.mu, add)
            else:
                torch._foreach_mul_(self.mu, b1)
                torch._foreach_add_(self.mu, add)
            torch._foreach_add_(params, self.mu, alpha=-lr)


def build_optimizer(tc: TrainConfig, model: torch.nn.Module):
    """adam / adamw / novograd with the configured schedule, betas, eps,
    weight decay and (adam) mu_dtype over the trainable parameters, as
    reverb_tpu/train/trainer.py:build_optimizer builds its optax chain.
    Returns (optimizer, schedule)."""
    conf = tc.optim_conf
    schedule = build_scheduler(tc.scheduler, conf.get('lr', 1e-3),
                               tc.scheduler_conf)
    kwargs = {}
    if 'betas' in conf:
        kwargs.update(b1=conf['betas'][0], b2=conf['betas'][1])
    if 'eps' in conf:
        kwargs.update(eps=conf['eps'])
    mu_dtype = conf.get('mu_dtype')
    wd = conf.get('weight_decay', 0.0)
    trainable = trainable_mask(model, tc)
    name = tc.optim.lower()
    if name in ('adam', 'adamw'):
        if mu_dtype:
            if str(mu_dtype) not in _MU_DTYPES:
                raise ValueError(f'unknown optim_conf.mu_dtype {mu_dtype!r}')
            kwargs.update(mu_dtype=_MU_DTYPES[str(mu_dtype)])
        opt = Adam(model, schedule, trainable, weight_decay=wd, **kwargs)
    elif name == 'novograd':
        if mu_dtype:
            # optax.novograd takes no mu_dtype: the JAX package's
            # build_optimizer fails on this config too
            raise TypeError('novograd takes no optim_conf.mu_dtype')
        opt = NovoGrad(model, schedule, trainable, weight_decay=wd, **kwargs)
    else:
        raise ValueError(f'unknown optimizer {tc.optim!r}')
    return opt, schedule


# batch-level fields: the context phrases every utterance of a batch shares
_WHOLE_BATCH_KEYS = ('cv_list', 'cv_list_lengths')


def _micro_batches(batch: Dict, n: int, sharding=None) -> List[Dict]:
    """Split every per-utterance tensor of the batch along its leading
    axis into n equal micro-batches; the context phrases go to each.
    Over several data ranks, this rank's block of each micro-batch of the
    global batch, as JAX's scan cuts it (global_batch.regroup)."""
    B = batch['feats'].shape[0]
    if B % n:
        raise ValueError(f'batch {B} does not split into {n} micro-batches')
    m = B // n
    chunks = [{k: v if k in _WHOLE_BATCH_KEYS else v[i * m:(i + 1) * m]
               for k, v in batch.items()} for i in range(n)]
    if n == 1 or sharding is None or sharding.data_size == 1:
        return chunks
    return gb.regroup(chunks, sharding.data_group,
                      axis_ranks(sharding.mesh, 'data'), sharding.data_rank)


def _check_rows(batch: Dict, sharding):
    """Every data rank must hold as many rows: JAX's global batch is one
    array split over 'data', and its micro-batches are blocks of it."""
    B = torch.tensor([batch['feats'].shape[0]],
                     device=batch['feats'].device)
    parts = [torch.empty_like(B) for _ in range(sharding.data_size)]
    torch.distributed.all_gather(parts, B, group=sharding.data_group)
    rows = [int(t) for t in parts]
    if len(set(rows)) != 1:
        raise ValueError(f'ranks hold unequal batch rows {rows}: the loss '
                         f'is a mean over the global batch')


def _detached(v):
    """A loss term for the metric sums: None as 0, tensors detached."""
    if v is None:
        return 0.0
    return v.detach() if torch.is_tensor(v) else float(v)


def make_train_step(cfg: ModelConfig, optimizer: _Optimizer,
                    accum_grad: int = 1, grad_clip: float = 0.0,
                    frontend: Optional[FrontendSpec] = None,
                    sharding=None, loss_fn: Optional[Callable] = None):
    """Returns train_step(model, batch, generator=None) → metrics {loss,
    loss_att, loss_ctc, th_accuracy, grad_norm, skipped} as floats, for a
    model of config `cfg` whose parameters `optimizer` updates.

    With accum_grad > 1 the batch's leading axis is accum·micro; the
    micro-batch gradients are summed and divided by accum_grad before ONE
    update, and the metrics are the micro-batch means.  grad_clip > 0 scales
    the gradients by clip/‖g‖ when ‖g‖ ≥ clip.  `generator` drives dropout
    (None: no dropout, as rng=None).  With a `frontend`
    (dataset_conf.device_feats) each micro-batch's features are computed
    from its `pcm` first, dithered and SpecAugmented from the generator
    (frontend/device_feats.py:apply_frontend).

    `loss_fn(model, batch, generator)` → metrics with 'loss' replaces the
    hybrid CTC/attention `compute_loss` (a registry family's bundle loss,
    models/registry.py), as the JAX package's make_train_step takes one;
    `cfg` is then the model's own `cfg`.

    With a `sharding` (parallel/sharding.py, applied to the model and the
    optimizer) the step is one rank's part of the JAX package's step over
    its mesh: the batch is this rank's rows, regrouped with accum_grad > 1
    so that its micro-batch j is its block of the global batch's (JAX's)
    micro-batch j (`_micro_batches`); each micro-batch's loss runs inside
    `global_batch.data_shard`, which gives it the global micro-batch's
    rows, tokens, denominators and statistics and data rank 0's draws
    (the asr_model's `norm`, a family's `loss_fn`), so that the ranks'
    losses sum to JAX's; the gradients are summed over 'data' once, after
    the last micro-batch, the norm is the whole model's, and the metrics
    are the global means, the same on every rank.  `generator` is this
    rank's own (seeded by its data coordinate: ranks of one data
    coordinate draw the same masks, as their activations are one).  Each
    micro-batch's loss is scaled by `sharding.loss_scale` for the
    backward ('seq' and 'pipe' ranks each compute it whole).

    Under a torch profiler the step is the span `train.step`
    (utils/profiling.py:span) holding, per micro-batch, `train.forward`
    (front end and loss) and `train.backward`; then `train.grad_sync`
    (with a sharding), `train.grad_norm` (the accumulation divide, the
    global norm, its read and the clip scale) and `train.optimizer`.
    The spans change no arithmetic and no launch."""

    def train_step(model, batch, generator=None) -> Dict[str, float]:
        if model.cfg != cfg:
            raise ValueError('train_step: the model has another config')
        with span('train.step'):
            return _step(model, batch, generator)

    def _step(model, batch, generator):
        if sharding is not None:
            if sharding.data_size > 1:
                _check_rows(batch, sharding)
            sharding.gather_params(batch['feats'].shape[0] // accum_grad)
        params = optimizer.params
        for p in params:
            p.grad = None
        sums: Dict[str, float] = {}
        for micro in _micro_batches(batch, accum_grad, sharding):
            with span('train.forward'):
                if frontend is not None:
                    micro = apply_frontend(micro, frontend, generator)
                with (contextlib.nullcontext() if sharding is None else
                      gb.data_shard(sharding.data_group, sharding.data_size)):
                    out = (compute_loss(model, micro, generator,
                                        norm=gb.norms(micro))
                           if loss_fn is None
                           else loss_fn(model, micro, generator))
                loss = out['loss']
                if sharding is not None and sharding.loss_scale != 1.0:
                    loss = loss * sharding.loss_scale
            with span('train.backward'):
                loss.backward()
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + _detached(v)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if sharding is not None:
            with span('train.grad_sync'):
                sharding.reduce_grads(grads)
                sums = sharding.sum_over_data(sums)
        with span('train.grad_norm'):
            if accum_grad > 1:
                torch._foreach_div_(grads, float(accum_grad))
            if sharding is not None:
                grad_norm = float(sharding.global_norm(grads))
            else:
                grad_norm = float(torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads))))
            finite = np.isfinite(grad_norm)
            scale = 1.0
            if finite and grad_clip > 0.0 and grad_norm >= grad_clip:
                scale = float(np.float32(grad_clip) / np.float32(grad_norm))
        if finite:
            with span('train.optimizer'):
                optimizer.step(grads, scale)
        for p in params:
            p.grad = None
        if sharding is not None:
            sharding.after_update()
        metrics = {k: float(v) / accum_grad for k, v in sums.items()}
        metrics['grad_norm'] = grad_norm
        metrics['skipped'] = 0.0 if finite else 1.0
        return metrics

    return train_step


def make_eval_step(cfg: ModelConfig,
                   frontend: Optional[FrontendSpec] = None,
                   loss_fn: Optional[Callable] = None):
    """Returns eval_step(model, batch, generator=None) → {loss, loss_att,
    loss_ctc, th_accuracy} as floats (0.0 where a weight switches a term
    off): the loss with no dropout, under torch.no_grad()
    (reverb_tpu/train/trainer.py:make_eval_step).  A use_dynamic_chunk
    model draws its chunk from `generator`, as WeNet's
    add_optional_chunk_mask draws it in evaluation too (the JAX package
    has no rng there and raises).  With a `frontend` the features come
    from `pcm`, with neither dither nor SpecAugment.  `loss_fn` as in
    `make_train_step` (called with no generator)."""

    def eval_step(model, batch, generator=None) -> Dict[str, float]:
        if model.cfg != cfg:
            raise ValueError('eval_step: the model has another config')
        if frontend is not None:
            batch = apply_frontend(batch, frontend, None)
        with torch.no_grad():
            out = (compute_loss(model, batch, None, chunk_generator=generator)
                   if loss_fn is None else loss_fn(model, batch, None))
        return {k: float(_detached(v)) for k, v in out.items()}

    return eval_step
