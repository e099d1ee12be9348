"""A model and its optimizer laid out over a mesh for training.

Counterpart of what reverb_tpu/bin/train.py does with
`param_shardings` / `opt_state_shardings` and `jax.device_put`, and of the
collectives XLA then inserts into the jitted step.  `Sharding.apply` takes
a model and optimizer that hold the whole single-process state (the same
on every rank) and, in place:

- tensor parallelism over 'model' (`mesh.TP_RULES`, completed block by
  block by `_BLOCK_SPECS`: a block the rules split in part splits whole,
  and what `_whole_form` names stays whole): each split parameter keeps
  its rank's block, and its layer runs split (models/modules.py `tp`;
  attention keeps its rank's heads, the depthwise conv its channels, a
  conv module's or the SANM feed-forward's LayerNorm normalises the
  gathered channels).  A fused projection (`_FUSED`: the GLU's pointwise_conv1,
  SANM's linear_q_k_v and linear_k_v) keeps the rank's block of each
  part.  A parameter the rules split outside any split form raises.  The
  dropout of a split activation (attention probabilities on the rank's
  heads, the FFN's hidden units) keeps the rank's block of the unsplit
  mask (models/modules.py `keep_mask`): the ranks of a 'model' group
  share one generator, so masks neither repeat across the group's
  blocks nor differ from the unsplit model's;
- 'seq': the encoder's time axis split over the group (`seq_split` of
  the conformer and Branchformer encoders, models/encoder.py and
  models/encoders_alt.py; the other encoders run whole on every rank and
  count it in `seq_steps`);
- 'expert': each rank keeps the experts [rE/n, (r+1)E/n) of every MoE
  feed-forward (models/encoder.py `expert_split`);
- 'pipe': the encoder's GPipe region (`ConformerEncoder.pipe_region`),
  stage s keeping its layers; a batch that does not divide into the
  microbatches runs the region in order, its layers gathered for that
  step (`gather_params`).  The region composes with the other axes:
  under 'seq' each stage runs its layers on the rank's time block, and
  under 'expert' an expert of a region layer is kept by one stage and
  one 'expert' rank (`ParamLayout.owners` holds both);
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
gradient of what it holds.  Under 'expert' the gradients of what the
group's ranks all hold are averaged over the group all the same (a
region layer's inside its stage, over ('data', 'seq', 'expert')): each
rank computes them whole, with its own roundings of the card's
nondeterministic backward kernels (CTC's atomics), and copies that must
stay one would drift apart step by step (under 'model' the replicated
gradients meet in `copy_in`'s sums).  The global norm sums the squares
of split gradients over each axis they are split on (`global_norm`), so
every rank takes the same clip and skip decision.  `gathered()` gives
the single-process layout for a checkpoint.
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

# The port's split forms beyond mesh.TP_RULES (the JAX package's table,
# under which GSPMD computes any layout whole).  Eager layers need a block
# split whole or not at all, so a block of which the rules split a part
# splits whole (`_block_layouts`): an attention's head-bearing projections
# by heads (its fused ones part by part, `_FUSED`; the SANM fsmn memory on
# the rank's v channels) and its output by rows; a feed-forward's w_1 by
# columns and w_2 by rows.  Whisper's MLP, which no rule names, splits as
# a feed-forward too.  What the rules match and the port keeps whole, on
# every rank (`_whole_form`): a LayerNorm (whose split neighbours
# normalise the gathered channels, `LayerNorm.tp`) and the Efficient
# Conformer's grouped attention (a grouped head reads g frames of every
# channel, no block of the projections' channels).  Every other parameter
# the rules split must lie in a layer with a split form (`Sharding.apply`
# raises).
_COL, _COL_B, _ROW = ('model', None), ('model',), (None, 'model')
_BLOCK_SPECS = {
    'attention': {
        **{f'{lin}.{w}': spec
           for lin in ('linear_q', 'linear_k', 'linear_v', 'linear_q_k_v',
                       'linear_k_v')
           for w, spec in (('weight', _COL), ('bias', _COL_B))},
        'linear_pos.weight': _COL, 'pos_bias_u': _COL, 'pos_bias_v': _COL,
        'fsmn_block.weight': ('model', None, None),
        'linear_out.weight': _ROW},
    'feed_forward': {'w_1.weight': _COL, 'w_1.bias': _COL_B,
                     'w_2.weight': _ROW}}
# fused projections: {name: parts}, a rank keeping its block of each part
# (the GLU pairs channel i with i + C after pointwise_conv1)
_FUSED = {'pointwise_conv1': 2, 'linear_q_k_v': 3, 'linear_k_v': 2}


def _whole_form(m) -> bool:
    """Whether `m` is kept whole on every rank (the comment above)."""
    from reverb_tpu_torch.models.encoders_alt import (
        GroupedRelPositionMultiHeadedAttention)
    from reverb_tpu_torch.models.modules import LayerNorm
    return isinstance(m, (LayerNorm, GroupedRelPositionMultiHeadedAttention))


def _block_kind(m) -> Optional[str]:
    """'attention' or 'feed_forward' for the blocks with a split form."""
    from reverb_tpu_torch.models.attention import MultiHeadedAttention
    from reverb_tpu_torch.models.encoder import FeedForward
    from reverb_tpu_torch.models import sanm, whisper
    if isinstance(m, (MultiHeadedAttention, sanm.MultiHeadedAttentionSANM,
                      sanm.MultiHeadAttentionCross)):
        return 'attention'
    if isinstance(m, (FeedForward, sanm.FeedForwardSANM, whisper.MLP,
                      sanm.FeedForwardDecoderSANM)):
        return 'feed_forward'
    return None


def _block_layouts(model) -> Dict[str, tuple]:
    """{JAX path: layout} where the port's layout is not the rule's: every
    parameter of the blocks that split whole (those of which a rule
    splits a part, and Whisper's MLP), and () for every parameter of what
    it keeps whole (`_whole_form`)."""
    from reverb_tpu_torch.models import whisper
    from reverb_tpu_torch.parallel.mesh import param_pspec
    out = {}
    for mn, m in model.named_modules():
        if _whole_form(m):
            out.update({tree_key(f'{mn}.{pn}'): ()
                        for pn, _ in m.named_parameters()})
            continue
        kind = _block_kind(m)
        if kind is None:
            continue
        spec = _BLOCK_SPECS[kind]
        own = {tree_key(f'{mn}.{pn}'): (spec[pn], p.dim())
               for pn, p in m.named_parameters() if pn in spec}
        if isinstance(m, whisper.MLP) or any(
                'model' in param_pspec(path, nd)
                for path, (_, nd) in own.items()):
            out.update({path: lay for path, (lay, _) in own.items()})
    return out


@dataclasses.dataclass
class ParamLayout:
    tp_axis: Optional[int] = None            # split over 'model'
    tp_index: Optional[torch.Tensor] = None  # this rank's rows of tp_axis
    zero_axis: Optional[int] = None          # moments split over 'data'
    zero3: bool = False                      # the parameter stored split
    # ((axis, coordinate), ...): kept only by the ranks at these
    # coordinates of 'pipe' (a region layer's stage) and 'expert' (an
    # expert's rank), in that order; () on every rank
    owners: tuple = ()
    full: tuple = ()                         # the single-process shape

    def owner(self, axis: str) -> Optional[int]:
        """The coordinate along `axis` of the ranks that keep it, or None
        when every coordinate does."""
        return dict(self.owners).get(axis)


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
        self.data_size = self.sizes['data']
        self.data_rank = self.coords['data']
        self.tp_size = self.sizes['model']
        self.tp_rank = self.coords['model']
        self.data_group = mesh.get_group('data')
        self.tp_group = mesh.get_group('model')
        # the gradient sums' groups (`_grad_axes`; collective: every rank
        # makes each, in one order)
        self._groups = {}
        for pipe in (True, False):
            for expert in (True, False):
                self._group(('data', 'seq') + ('pipe',) * pipe
                            + ('expert',) * expert)
        self.loss_scale = 1.0 / (self.sizes['seq'] * self.sizes['pipe'])
        self.layouts: Dict[str, ParamLayout] = {}
        self.model = None
        self.optimizer = None
        self.encoder = None          # the encoder with a GPipe region
        self._region_whole = False

    # ------------------------------ layout ------------------------------

    def _group(self, axes):
        """The group of the ranks that differ from this one only along
        `axes` (cached by the axes of more than one rank)."""
        key = tuple(a for a in AXES if a in axes and self.sizes[a] > 1)
        if key not in self._groups:
            self._groups[key] = axis_group(self.mesh, key)
        return self._groups[key]

    def _keeps(self, lay: ParamLayout) -> bool:
        return all(self.coords[a] == c for a, c in lay.owners)

    def _tp_index(self, name, n, device):
        """This rank's rows of the `n` rows a 'model'-split parameter
        splits: its block of each part of a fused projection (`_FUSED`),
        else its contiguous block."""
        tp, r = self.tp_size, self.tp_rank
        parts = next((k for sub, k in _FUSED.items()
                      if name.endswith((f'{sub}.weight', f'{sub}.bias'))), 1)
        c = n // parts
        if c % tp:
            raise ValueError(f'{name}: {c} rows a part over {tp} ranks')
        blk = torch.arange(r * (c // tp), (r + 1) * (c // tp))
        return torch.cat([blk + i * c for i in range(parts)]).to(device)

    def _owners(self, model) -> Dict[str, tuple]:
        """{parameter name: ((axis, coordinate of the ranks that keep
        it), ...)} of the GPipe region's layers ('pipe') and the experts
        ('expert'; an expert of a region layer has both)."""
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
                        out.setdefault(f'{mname}.experts.{e}.{pn}', []) \
                            .append(('expert', e // (E // n_exp)))
            region = (m.pipe_region(n_pipe) if n_pipe > 1 and
                      isinstance(m, ConformerEncoder) else None)
            if region is not None:
                lo, hi = region
                per = (hi - lo) // n_pipe
                for i in range(lo, hi):
                    for pn, _ in m.encoders[i].named_parameters():
                        out.setdefault(f'{mname}.encoders.{i}.{pn}', []) \
                            .append(('pipe', (i - lo) // per))
        return {k: tuple(sorted(v, key=lambda o: AXES.index(o[0])))
                for k, v in out.items()}

    def _layouts(self, model):
        shapes = {tree_key(n): tuple(p.shape)
                  for n, p in model.named_parameters()}
        overrides = _block_layouts(model)
        pspec = param_shardings(shapes, self.mesh, self.zero3,
                                self.zero3_min_size, overrides)
        mspec = opt_state_shardings(shapes, self.mesh, self.zero, overrides)
        owners = self._owners(model)
        out = {}
        for name, p in model.named_parameters():
            path = tree_key(name)
            lay = ParamLayout(full=tuple(p.shape))
            lay.owners = owners.get(name, ())
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

    def _split_layers(self, model) -> set:
        """Give each split layer its rank's share of the work; returns
        the names of the 'model'-split parameters whose layers took a
        split form."""
        from reverb_tpu_torch.models.encoder import (ConformerEncoder,
                                                     MoEFeedForward)
        from reverb_tpu_torch.parallel.pipeline import PipeStage
        sizes, coords = self.sizes, self.coords
        claimed = set()
        for mname, m in model.named_modules():
            if sizes['seq'] > 1 and hasattr(m, 'seq_split'):
                # an encoder: split where its forward can, else counted
                # whole (models/encoder.py:count_seq_step)
                m.seq_split = (self.mesh.get_group('seq'), coords['seq'],
                               sizes['seq'])
            if isinstance(m, ConformerEncoder) and sizes['pipe'] > 1 and \
                    m.pipe_region(sizes['pipe']):
                m.pipe = PipeStage(self.mesh.get_group('pipe'),
                                   coords['pipe'], sizes['pipe'],
                                   axis_ranks(self.mesh, 'pipe'),
                                   m.cfg.pipeline_microbatches)
                self.encoder = m
            if isinstance(m, MoEFeedForward) and sizes['expert'] > 1:
                m.expert_split = (self.mesh.get_group('expert'),
                                  coords['expert'], sizes['expert'])
            if self.tp_size > 1:
                claimed |= self._tp_form(mname, m)
        return claimed

    def _split(self, name) -> bool:
        lay = self.layouts.get(name)
        return lay is not None and lay.tp_axis is not None

    def _tp_linear(self, m, name, vocab: bool = False):
        """A split Linear or pointwise Conv1d: row-parallel where its
        input axis is split, else column- (or vocabulary-) parallel."""
        mode = ('row' if self.layouts[f'{name}.weight'].tp_axis == 1
                else 'vocab' if vocab else 'col')
        m.tp = (mode, self.tp_group, self.tp_rank)

    def _tp_form(self, mname, m) -> set:
        """The split form of module `m` (named `mname`) over 'model', if
        the layout splits it: the names of its split parameters (empty
        when it has no form, or nothing of it is split)."""
        from reverb_tpu_torch.models.encoder import ConvolutionModule
        from reverb_tpu_torch.models.modules import (Conv1d, Embedding,
                                                     LayerNorm, Linear)
        tp, r = self.tp_size, self.tp_rank
        pre = f'{mname}.' if mname else ''
        split = {pre + pn for pn, _ in m.named_parameters()
                 if self._split(pre + pn)}
        kind = _block_kind(m)
        if not split:
            return set()
        if kind == 'attention':
            if m.h % tp:
                raise ValueError(f'{mname}: {m.h} heads over {tp} ranks')
            m.h //= tp
            m.tp_split = (-1 if hasattr(m, 'fsmn_block') else 1, r, tp)
            for cn, c in m.named_children():
                if isinstance(c, Linear):
                    self._tp_linear(c, pre + cn)
                elif isinstance(c, Conv1d):          # the fsmn memory
                    c.groups //= tp
        elif kind == 'feed_forward':
            m.tp_split = (-1, r, tp)
            self._tp_linear(m.w_1, pre + 'w_1')
            self._tp_linear(m.w_2, pre + 'w_2')
            if isinstance(getattr(m, 'norm', None), LayerNorm):
                m.norm.tp = (self.tp_group, r, tp)
        elif isinstance(m, ConvolutionModule):
            self._tp_linear(m.pointwise_conv1, pre + 'pointwise_conv1')
            m.depthwise_conv.groups //= tp
            if isinstance(m.norm, LayerNorm):
                m.norm.tp = (self.tp_group, r, tp)
            self._tp_linear(m.pointwise_conv2, pre + 'pointwise_conv2')
        elif isinstance(m, Linear) and \
                mname.endswith(('output_layer', 'ctc_lo')):
            self._tp_linear(m, mname, vocab=True)
        elif isinstance(m, Embedding):
            m.tp = ('vocab', self.tp_group, r)
        else:
            # a child of a block above, or a parameter the rules split
            # outside any split form (`apply` raises for it)
            return set()
        return split

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
        claimed = self._split_layers(model)
        loose = sorted({n.rsplit('.', 1)[0] for n in self.layouts
                        if self._split(n) and n not in claimed})
        if loose:
            raise ValueError(
                f"{', '.join(loose)}: the 'model' rules split parameters "
                f'of these modules, which have no split form (add one, '
                f'or keep the module whole: parallel/sharding.py)')
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
                if self.layouts[n].owner('pipe') is not None]

    def _from_owners(self, lay, t, shape, axes=('pipe', 'expert')):
        """The kept tensor `t` broadcast from its owners along each of
        `axes` in turn; `shape` is what the other ranks receive.  Along
        one axis only the groups that sit at the owners' coordinates of
        the later axes take part (they alone hold it by then), so after
        the last axis every rank holds it."""
        todo = [(a, c) for a, c in lay.owners if a in axes]
        held = all(self.coords[a] == c for a, c in todo)
        for k, (a, c) in enumerate(todo):
            if any(self.coords[b] != d for b, d in todo[k + 1:]):
                continue
            buf = t.contiguous() if held else t.new_empty(shape)
            dist.broadcast(buf, src=axis_ranks(self.mesh, a)[c],
                           group=self.mesh.get_group(a))
            t, held = buf, True
        return t

    def gather_params(self, rows: Optional[int] = None):
        """ZeRO-3: every split parameter back to its whole (TP-local)
        shape, for a forward.  Under 'pipe', also every stage's region
        layers on every stage when a batch of `rows` does not run the
        GPipe region (None: whatever the batch, for an evaluation); under
        'expert' a rank gathers only its own experts of them."""
        self._gather_zero3()
        if self.encoder is not None and (
                rows is None or not self.encoder.pipe_engages(rows)):
            with torch.no_grad():
                for name, p in self._region_params():
                    lay = self.layouts[name]
                    e = lay.owner('expert')
                    if e is not None and e != self.coords['expert']:
                        continue
                    shape = list(lay.full)
                    if lay.tp_axis is not None:
                        shape[lay.tp_axis] = len(lay.tp_index)
                    p.data = self._from_owners(lay, p.data, shape,
                                               ('pipe',))
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

    def _grad_axes(self, lay: ParamLayout) -> tuple:
        """The axes a parameter's gradient is summed over: ('data',
        'seq'), 'pipe' unless its stage alone computed it, 'expert' unless
        it is an expert (module docstring)."""
        staged = lay.owner('pipe') is not None and not self._region_whole
        return ('data', 'seq') + ('pipe',) * (not staged) + \
            ('expert',) * (lay.owner('expert') is None)

    def reduce_grads(self, grads: List[torch.Tensor]):
        """Sum the gradients (aligned with model.parameters()) in place
        over `_grad_axes`, averaged over 'expert' where that is one of
        them (module docstring).  Frozen parameters (requires_grad off:
        LoRA's base) take part in no sum.  A region layer of another
        stage, gathered for a step that ran the region in order, leaves
        an empty gradient."""
        by_group: Dict[int, tuple] = {}
        shared = []
        for (name, p), g in zip(self.model.named_parameters(), grads):
            if not p.requires_grad:
                continue
            axes = self._grad_axes(self.layouts[name])
            if 'expert' in axes:
                shared.append(g)
            group = self._group(axes)
            if group is not None:
                by_group.setdefault(id(group), (group, []))[1].append(g)
        if self.sizes['expert'] > 1:
            torch._foreach_div_(shared, float(self.sizes['expert']))
        for group, gs in by_group.values():
            _sum_buckets(gs, group)
        if self._region_whole:
            for i, (name, _) in enumerate(self.model.named_parameters()):
                lay = self.layouts[name]
                if lay.owner('pipe') is not None and not self._keeps(lay):
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
        'expert' and of the region layers over 'pipe' (a region layer's
        expert over both); each rank holds the whole gradient of the rest
        after `reduce_grads`."""
        lays = [self.layouts[n] for n, _ in self.model.named_parameters()]
        sq = [n * n for n in torch._foreach_norm(grads)]
        for axis, split in (
                ('model', [lay.tp_axis is not None for lay in lays]),
                ('expert', [lay.owner('expert') is not None
                            for lay in lays]),
                ('pipe', [lay.owner('pipe') is not None for lay in lays])):
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
        'pipe' rank keeps it) → its whole tensor, on every rank (from its
        owners along 'pipe' and 'expert'); a parameter's with `data`
        False (whole over 'data' already)."""
        lay = self.layouts[name]
        if self._keeps(lay) and t.dim():
            if data and lay.zero_axis is not None:
                t = _all_gather(t, lay.zero_axis, self.data_group)
            if lay.tp_axis is not None:
                t = self._whole_tp(name, t)
        if lay.owners:
            t = self._from_owners(lay, t, lay.full if t.dim() else ())
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
                                    self.layouts[name].owners:
                                ms[j] = self._whole(name, ms[j])
            yield
        finally:
            for (_, p), d in zip(params, saved):
                p.data = d
            if moments:
                opt.mu[:], opt.nu[:] = moments
            self.release_params()
