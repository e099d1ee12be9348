"""A model and its optimizer laid out over a mesh for training.

Counterpart of what reverb_tpu/bin/train.py does with
`param_shardings` / `opt_state_shardings` and `jax.device_put`, and of the
collectives XLA then inserts into the jitted step.  `Sharding.apply` takes
a model and optimizer that hold the whole single-process state (the same
on every rank) and, in place:

- tensor parallelism over 'model' (`mesh.TP_RULES`): each split parameter
  keeps its rank's block, and its layer runs split (models/modules.py
  `tp`; attention keeps its rank's heads, the depthwise conv its
  channels, a conv module's LayerNorm normalises the gathered channels).
  The GLU after `pointwise_conv1` pairs channel i with channel
  i + C, so a rank keeps rows [rC/n, (r+1)C/n) of both halves.  The
  dropout of a split activation (attention probabilities on the rank's
  heads, the FFN's hidden units) keeps the rank's block of the unsplit
  mask (models/modules.py `keep_mask`): the ranks of a 'model' group
  share one generator, so masks neither repeat across the group's
  blocks nor differ from the unsplit model's;
- 'seq': the encoder's time axis split over the group (models/encoder.py
  `seq_split`);
- 'expert': each rank keeps the experts [rE/n, (r+1)E/n) of every MoE
  feed-forward (models/encoder.py `expert_split`);
- 'pipe': the encoder's GPipe region (`ConformerEncoder.pipe_region`),
  stage s keeping its layers; a batch that does not divide into the
  microbatches runs the region in order, its layers gathered for that
  step (`gather_params`);
- ZeRO-1/2 over 'data' (`zero`): each moment keeps its rank's block of the
  first free divisible axis; the optimizer updates that block of its
  parameter, and the blocks are all-gathered after the update;
- ZeRO-3 (`zero3`): every parameter of at least `zero3_min_size` elements
  is also STORED as its block between steps, gathered for the step
  (`gather_params`) and released after the update.

A parameter an 'expert' or 'pipe' rank does not keep is an empty tensor
there, with empty moments.

The gradient sums (`reduce_grads`): the trainer scales the loss by
`loss_scale` = 1/(S·P) for 'seq' S and 'pipe' P, since every rank of a
'seq' or 'pipe' group computes the loss whole after the encoder's output
is gathered; a replicated parameter's gradient (and a 'model'- or
'expert'-split one's block) is then summed over ('data', 'seq', 'pipe'),
and a stage's region layer's over ('data', 'seq').  'model' and 'expert'
need no sum: their collectives (`copy_in`) give every rank the whole
gradient of what it holds.  The global norm sums the squares of split
gradients over their axis (`global_norm`), so every rank takes the same
clip and skip decision.  `gathered()` gives the single-process layout for
a checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from reverb_tpu_torch.convert import tree_key
from reverb_tpu_torch.parallel.mesh import (AXES, axis_group, axis_rank,
                                            axis_ranks, axis_size,
                                            opt_state_shardings,
                                            param_shardings)

_BUCKET = 1 << 25          # elements a gradient all-reduce moves at once


@dataclasses.dataclass
class ParamLayout:
    tp_axis: Optional[int] = None            # split over 'model'
    tp_index: Optional[torch.Tensor] = None  # this rank's rows of tp_axis
    zero_axis: Optional[int] = None          # moments split over 'data'
    zero3: bool = False                      # the parameter stored split
    owner_axis: Optional[str] = None         # kept by one 'expert'/'pipe' rank
    owner: int = 0                           # ... of this coordinate
    full: tuple = ()                         # the single-process shape


def _all_gather(t, axis: int, group) -> torch.Tensor:
    """The group's blocks of `t` along `axis`, concatenated in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, axis)


def _sum_buckets(grads: List[torch.Tensor], group):
    """Sum the gradients over `group` in place, in flat buckets."""
    i = 0
    while i < len(grads):
        j, size = i, 0
        while j < len(grads) and (size == 0 or
                                  size + grads[j].numel() <= _BUCKET):
            size += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in grads[i:j]:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        i = j


class Sharding:
    """The layout of one model and optimizer over `mesh` (module
    docstring): 'model' the tensor-parallel axis, 'data' the
    data-parallel one, 'seq', 'expert' and 'pipe' the encoder's time,
    experts and stages; `zero` shards the moments over 'data' (ZeRO-1/2,
    as the JAX package's bin/train always does), `zero3` the large
    parameters too."""

    def __init__(self, mesh, zero: bool = True, zero3: bool = False,
                 zero3_min_size: int = 65536):
        self.mesh = mesh
        self.zero = zero or zero3
        self.zero3 = zero3
        self.zero3_min_size = zero3_min_size
        self.sizes = {a: axis_size(mesh, a) for a in AXES}
        self.coords = {a: axis_rank(mesh, a) for a in AXES}
        if self.sizes['seq'] > 1 and self.sizes['pipe'] > 1:
            raise NotImplementedError(
                "'seq' and 'pipe' together: the GPipe region's stages "
                "would each split their time axis (not ported)")
        self.data_size = self.sizes['data']
        self.data_rank = self.coords['data']
        self.tp_size = self.sizes['model']
        self.tp_rank = self.coords['model']
        self.data_group = mesh.get_group('data')
        self.tp_group = mesh.get_group('model')
        # the gradient sums' groups (collective: every rank makes both)
        self.replica_group = axis_group(mesh, ('pipe', 'data', 'seq'))
        self.stage_group = axis_group(mesh, ('data', 'seq'))
        self.loss_scale = 1.0 / (self.sizes['seq'] * self.sizes['pipe'])
        self.layouts: Dict[str, ParamLayout] = {}
        self.model = None
        self.optimizer = None
        self.encoder = None          # the encoder with a GPipe region
        self._region_whole = False

    # ------------------------------ layout ------------------------------

    def _keeps(self, lay: ParamLayout) -> bool:
        return lay.owner_axis is None or \
            self.coords[lay.owner_axis] == lay.owner

    def _tp_index(self, name, n, device):
        tp, r = self.tp_size, self.tp_rank
        if name.endswith(('pointwise_conv1.weight', 'pointwise_conv1.bias')):
            c = n // 2
            if c % tp:
                raise ValueError(f'{name}: {c} GLU channels over {tp} ranks')
            blk = torch.arange(r * (c // tp), (r + 1) * (c // tp))
            return torch.cat([blk, blk + c]).to(device)
        if n % tp:
            raise ValueError(f'{name}: {n} rows over {tp} ranks')
        return torch.arange(r * (n // tp), (r + 1) * (n // tp), device=device)

    def _owners(self, model) -> Dict[str, tuple]:
        """{parameter name: (axis, coordinate of the rank that keeps it)}
        of the experts ('expert') and the GPipe region's layers
        ('pipe')."""
        from reverb_tpu_torch.models.encoder import (ConformerEncoder,
                                                     MoEFeedForward)
        out = {}
        n_exp, n_pipe = self.sizes['expert'], self.sizes['pipe']
        for mname, m in model.named_modules():
            if n_exp > 1 and isinstance(m, MoEFeedForward):
                E = len(m.experts)
                if E % n_exp:
                    raise ValueError(f'{mname}: {E} experts over {n_exp} '
                                     f'ranks')
                for e, ex in enumerate(m.experts):
                    for pn, _ in ex.named_parameters():
                        out[f'{mname}.experts.{e}.{pn}'] = (
                            'expert', e // (E // n_exp))
            region = (m.pipe_region(n_pipe) if n_pipe > 1 and
                      isinstance(m, ConformerEncoder) else None)
            if region is not None:
                lo, hi = region
                per = (hi - lo) // n_pipe
                for i in range(lo, hi):
                    for pn, _ in m.encoders[i].named_parameters():
                        key = f'{mname}.encoders.{i}.{pn}'
                        if key in out:
                            raise NotImplementedError(
                                f'{key}: experts inside a GPipe stage '
                                f"('expert' with 'pipe')")
                        out[key] = ('pipe', (i - lo) // per)
        return out

    def _layouts(self, model):
        from reverb_tpu_torch.models.modules import LayerNorm
        shapes = {tree_key(n): tuple(p.shape)
                  for n, p in model.named_parameters()}
        # a LayerNorm stays replicated (the port's BatchNorm row of
        # TP_RULES would match a conv module's)
        replicated = {tree_key(f'{mn}.{pn}')
                      for mn, m in model.named_modules()
                      if isinstance(m, LayerNorm)
                      for pn, _ in m.named_parameters(recurse=False)}
        pspec = param_shardings(shapes, self.mesh, self.zero3,
                                self.zero3_min_size, replicated)
        mspec = opt_state_shardings(shapes, self.mesh, self.zero, replicated)
        owners = self._owners(model)
        out = {}
        for name, p in model.named_parameters():
            path = tree_key(name)
            lay = ParamLayout(full=tuple(p.shape))
            if name in owners:
                lay.owner_axis, lay.owner = owners[name]
            if self.tp_size > 1 and 'model' in pspec[path]:
                lay.tp_axis = pspec[path].index('model')
                lay.tp_index = self._tp_index(name, p.shape[lay.tp_axis],
                                              p.device)
            if self.data_size > 1 and 'data' in mspec[path] and \
                    self._keeps(lay):
                lay.zero_axis = mspec[path].index('data')
                lay.zero3 = 'data' in pspec[path]
                if lay.zero3:
                    assert pspec[path].index('data') == lay.zero_axis
            out[name] = lay
        return out

    def _split_layers(self, model):
        """Give each split layer its rank's share of the work."""
        from reverb_tpu_torch.models.attention import MultiHeadedAttention
        from reverb_tpu_torch.models.encoder import (ConformerEncoder,
                                                     ConvolutionModule,
                                                     FeedForward,
                                                     MoEFeedForward)
        from reverb_tpu_torch.models.modules import (Conv1d, Embedding,
                                                     LayerNorm, Linear)
        from reverb_tpu_torch.parallel.pipeline import PipeStage
        tp, sizes, coords = self.tp_size, self.sizes, self.coords
        for mname, m in model.named_modules():
            lay = self.layouts.get(f'{mname}.weight')
            if isinstance(m, ConformerEncoder):
                if sizes['seq'] > 1:
                    m.seq_split = (self.mesh.get_group('seq'),
                                   coords['seq'], sizes['seq'])
                if sizes['pipe'] > 1 and m.pipe_region(sizes['pipe']):
                    m.pipe = PipeStage(self.mesh.get_group('pipe'),
                                       coords['pipe'], sizes['pipe'],
                                       axis_ranks(self.mesh, 'pipe'),
                                       m.cfg.pipeline_microbatches)
                    self.encoder = m
            if isinstance(m, MoEFeedForward) and sizes['expert'] > 1:
                m.expert_split = (self.mesh.get_group('expert'),
                                  coords['expert'], sizes['expert'])
            if isinstance(m, ConvolutionModule) and tp > 1 and \
                    isinstance(m.norm, LayerNorm) and self.layouts[
                        f'{mname}.pointwise_conv1.weight'].tp_axis is not None:
                m.norm.tp = (self.tp_group, self.tp_rank, tp)
            if isinstance(m, MultiHeadedAttention):
                if m.h % tp:
                    raise ValueError(f'{mname}: {m.h} heads over {tp} ranks')
                m.h //= tp
                if tp > 1:
                    m.tp_split = (1, self.tp_rank, tp)
            if isinstance(m, FeedForward) and tp > 1 and \
                    self.layouts[f'{mname}.w_1.weight'].tp_axis is not None:
                m.tp_split = (-1, self.tp_rank, tp)
            if lay is None or lay.tp_axis is None:
                continue
            if isinstance(m, Conv1d) and m.groups > 1:
                m.groups //= tp
                continue
            if isinstance(m, Embedding):
                mode = 'vocab'
            elif isinstance(m, (Linear, Conv1d)):
                mode = ('row' if lay.tp_axis == 1 else
                        'vocab' if mname.endswith(('output_layer', 'ctc_lo'))
                        else 'col')
            else:
                continue
            m.tp = (mode, self.tp_group, self.tp_rank)

    def _local(self, name, t):
        """The TP block, then the ZeRO block, of a whole-shaped tensor
        (empty where another 'expert' or 'pipe' rank keeps it)."""
        lay = self.layouts[name]
        if not self._keeps(lay):
            return t.new_empty(0)
        if lay.tp_axis is not None:
            t = t.index_select(lay.tp_axis, lay.tp_index)
        return self._zero_view(lay, t).clone()

    def _zero_view(self, lay, t):
        if lay.zero_axis is None or t.dim() == 0:
            return t
        n = t.shape[lay.zero_axis] // self.data_size
        return t.narrow(lay.zero_axis, self.data_rank * n, n)

    def _view_fn(self, lay):
        """The block of a parameter (or its gradient) this rank updates:
        its ZeRO block, nothing of one another rank keeps."""
        if not self._keeps(lay):
            return lambda t: t.reshape(-1)[:0]
        return lambda t: self._zero_view(lay, t)

    def apply(self, model, optimizer=None):
        """Split `model` and `optimizer` (see the module docstring) in
        place; returns self."""
        self.model, self.optimizer = model, optimizer
        self.device = next(model.parameters()).device
        self.layouts = self._layouts(model)
        self._split_layers(model)
        with torch.no_grad():
            for name, p in model.named_parameters():
                lay = self.layouts[name]
                if not self._keeps(lay):
                    p.data = p.data.new_empty(0)
                elif lay.tp_axis is not None:
                    p.data = p.data.index_select(lay.tp_axis,
                                                 lay.tp_index).contiguous()
            if optimizer is not None:
                names = [optimizer.names[i] for i in optimizer.train_idx]
                for moments in (optimizer.mu, optimizer.nu):
                    for j, name in enumerate(names):
                        if moments[j].dim():
                            moments[j] = self._local(name, moments[j])
                lays = [self.layouts[n] for n in names]
                optimizer.views = [self._view_fn(lay) for lay in lays]
                optimizer.leaf_sq = self._leaf_sq_fn(lays)
        self.release_params()
        return self

    # --------------------------- the step ---------------------------

    def _zero3_params(self):
        return [(n, p) for n, p in self.model.named_parameters()
                if self.layouts[n].zero3]

    def _region_params(self):
        return [(n, p) for n, p in self.model.named_parameters()
                if self.layouts[n].owner_axis == 'pipe']

    def _from_owner(self, lay, t, shape):
        """The kept tensor `t` broadcast from its owner over its axis;
        `shape` is what the other ranks receive."""
        buf = t.contiguous() if self._keeps(lay) else t.new_empty(shape)
        src = axis_ranks(self.mesh, lay.owner_axis)[lay.owner]
        dist.broadcast(buf, src=src, group=self.mesh.get_group(
            lay.owner_axis))
        return buf

    def gather_params(self, rows: Optional[int] = None):
        """ZeRO-3: every split parameter back to its whole (TP-local)
        shape, for a forward.  Under 'pipe', also every stage's region
        layers on every stage when a batch of `rows` does not run the
        GPipe region (None: whatever the batch, for an evaluation)."""
        self._gather_zero3()
        if self.encoder is not None and (
                rows is None or not self.encoder.pipe_engages(rows)):
            with torch.no_grad():
                for name, p in self._region_params():
                    lay = self.layouts[name]
                    shape = list(lay.full)
                    if lay.tp_axis is not None:
                        shape[lay.tp_axis] = len(lay.tp_index)
                    p.data = self._from_owner(lay, p.data, shape)
            self._region_whole = True

    def _gather_zero3(self):
        with torch.no_grad():
            for name, p in self._zero3_params():
                lay = self.layouts[name]
                p.data = _all_gather(p.data, lay.zero_axis, self.data_group)

    def release_params(self):
        """ZeRO-3: keep only this rank's block of each split parameter;
        the region layers of other stages go again."""
        with torch.no_grad():
            for name, p in self._zero3_params():
                p.data = self._zero_view(self.layouts[name], p.data).clone()
            if self._region_whole:
                for name, p in self._region_params():
                    if not self._keeps(self.layouts[name]):
                        p.data = p.data.new_empty(0)
                self._region_whole = False

    def reduce_grads(self, grads: List[torch.Tensor]):
        """Sum the gradients (aligned with model.parameters()) in place:
        over ('data', 'seq', 'pipe'), a region layer's over ('data',
        'seq') where its stage alone computed it (module docstring).
        Frozen parameters (requires_grad off: LoRA's base) take part in
        no sum.  A region layer of another stage, gathered for a step
        that ran the region in order, leaves an empty gradient."""
        by_group: Dict[int, tuple] = {}
        for (name, p), g in zip(self.model.named_parameters(), grads):
            if not p.requires_grad:
                continue
            staged = (self.layouts[name].owner_axis == 'pipe'
                      and not self._region_whole)
            group = self.stage_group if staged else self.replica_group
            if group is not None:
                by_group.setdefault(id(group), (group, []))[1].append(g)
        for group, gs in by_group.values():
            _sum_buckets(gs, group)
        if self._region_whole:
            for i, (name, _) in enumerate(self.model.named_parameters()):
                lay = self.layouts[name]
                if lay.owner_axis == 'pipe' and not self._keeps(lay):
                    grads[i] = grads[i].new_empty(0)

    def sum_over_data(self, values: Dict) -> Dict[str, float]:
        """{name: number or 0-d tensor} summed over 'data' (in f64)."""
        keys = sorted(values)
        t = torch.stack([torch.as_tensor(values[k], dtype=torch.float64,
                                         device=self.device) for k in keys])
        dist.all_reduce(t, group=self.data_group)
        return dict(zip(keys, t.tolist()))

    def _sum_over(self, sq, split, group):
        """Σ sq with the entries of `split` summed over `group` too."""
        sq = torch.stack(sq)
        mask = torch.tensor(split, device=sq.device)
        part = torch.where(mask, sq, torch.zeros_like(sq))
        dist.all_reduce(part, group=group)
        return torch.where(mask, part, sq)

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """‖g‖ of the whole model's gradient (0-d): the squares of the
        'model'-split gradients summed over 'model', of the experts over
        'expert' and of the region layers over 'pipe'; each rank holds
        the whole gradient of the rest after `reduce_grads`."""
        lays = [self.layouts[n] for n, _ in self.model.named_parameters()]
        sq = [n * n for n in torch._foreach_norm(grads)]
        for axis, split in (
                ('model', [lay.tp_axis is not None for lay in lays]),
                ('expert', [lay.owner_axis == 'expert' for lay in lays]),
                ('pipe', [lay.owner_axis == 'pipe' for lay in lays])):
            if self.sizes[axis] > 1 and any(split):
                sq = list(self._sum_over(sq, split,
                                         self.mesh.get_group(axis)))
        return torch.sqrt(torch.stack(sq).sum())

    def _leaf_sq_fn(self, lays):
        """NovoGrad's per-leaf ‖g‖² over the whole leaf: the squares of a
        split leaf's blocks summed over the axes it is split on."""
        zero = [lay.zero_axis is not None for lay in lays]
        tp = [lay.tp_axis is not None for lay in lays]

        def leaf_sq(sq):
            if self.data_size > 1 and any(zero):
                sq = list(self._sum_over(sq, zero, self.data_group))
            if self.tp_size > 1 and any(tp):
                sq = list(self._sum_over(sq, tp, self.tp_group))
            return sq
        return leaf_sq

    def after_update(self):
        """ZeRO-1/2: all-gather the updated blocks of each parameter;
        ZeRO-3: release the parameters."""
        opt = self.optimizer
        with torch.no_grad():
            for i in opt.train_idx:
                name, p = opt.names[i], opt.params[i]
                lay = self.layouts[name]
                if lay.zero_axis is None or lay.zero3:
                    continue
                p.data.copy_(_all_gather(self._zero_view(lay, p.data),
                                         lay.zero_axis, self.data_group))
        self.release_params()

    # --------------------------- checkpoints ---------------------------

    @contextlib.contextmanager
    def full_params(self):
        """ZeRO-3 parameters and every stage's region layers gathered (for
        an evaluation) inside."""
        self.gather_params()
        try:
            yield
        finally:
            self.release_params()

    def _whole_tp(self, name, t):
        """A parameter's TP block → its whole tensor (the blocks put back
        at their rows, the GLU halves included)."""
        lay = self.layouts[name]
        blocks = _all_gather(t, lay.tp_axis, self.tp_group)
        order = _all_gather(lay.tp_index, 0, self.tp_group)
        return torch.empty_like(blocks).index_copy_(lay.tp_axis, order,
                                                    blocks)

    def _whole(self, name, t, data: bool = True):
        """A moment's block (TP, then ZeRO; none where another 'expert' or
        'pipe' rank keeps it) → its whole tensor; a parameter's with
        `data` False (whole over 'data' already)."""
        lay = self.layouts[name]
        if self._keeps(lay) and t.dim():
            if data and lay.zero_axis is not None:
                t = _all_gather(t, lay.zero_axis, self.data_group)
            if lay.tp_axis is not None:
                t = self._whole_tp(name, t)
        if lay.owner_axis is not None:
            t = self._from_owner(lay, t, lay.full if t.dim() else ())
        return t

    @contextlib.contextmanager
    def gathered(self):
        """Inside, every parameter and moment holds its whole
        single-process value (a collective: every rank enters), so
        `train/checkpoint.py:save_checkpoint` writes the one layout that
        any run resumes into; the split layout is restored after."""
        opt = self.optimizer
        params = list(self.model.named_parameters())
        saved, moments = [], []
        self._gather_zero3()
        try:
            with torch.no_grad():
                for name, p in params:
                    saved.append(p.data)
                    p.data = self._whole(name, p.data, data=False)
                if opt is not None:
                    names = [opt.names[i] for i in opt.train_idx]
                    for ms in (opt.mu, opt.nu):
                        moments.append(list(ms))
                        for j, name in enumerate(names):
                            if ms[j].dim() or \
                                    self.layouts[name].owner_axis:
                                ms[j] = self._whole(name, ms[j])
            yield
        finally:
            for (_, p), d in zip(params, saved):
                p.data = d
            if moments:
                opt.mu[:], opt.nu[:] = moments
            self.release_params()
