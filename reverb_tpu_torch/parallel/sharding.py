"""A model and its optimizer laid out over a mesh for training.

Counterpart of what reverb_tpu/bin/train.py does with
`param_shardings` / `opt_state_shardings` and `jax.device_put`, and of the
collectives XLA then inserts into the jitted step.  `Sharding.apply` takes
a model and optimizer that hold the whole single-process state (the same
on every rank) and, in place:

- tensor parallelism over 'model' (`mesh.TP_RULES`): each split parameter
  keeps its rank's block, and its layer runs split (models/modules.py
  `tp`; attention keeps its rank's heads, the depthwise conv its
  channels).  The GLU after `pointwise_conv1` pairs channel i with channel
  i + C, so a rank keeps rows [rC/n, (r+1)C/n) of both halves.  The
  dropout of a split activation (attention probabilities on the rank's
  heads, the FFN's hidden units) keeps the rank's block of the unsplit
  mask (models/modules.py `keep_mask`): the ranks of a 'model' group
  share one generator, so masks neither repeat across the group's
  blocks nor differ from the unsplit model's;
- ZeRO-1/2 over 'data' (`zero`): each moment keeps its rank's block of the
  first free divisible axis; the optimizer updates that block of its
  parameter, and the blocks are all-gathered after the update;
- ZeRO-3 (`zero3`): every parameter of at least `zero3_min_size` elements
  is also STORED as its block between steps, gathered for the step
  (`gather_params`) and released after the update.

Gradients are summed over 'data' in buckets (`reduce_grads`); the global
norm sums the squares of 'model'-split gradients over 'model'
(`global_norm`), so every rank takes the same clip and skip decision.
`gathered()` gives the single-process layout for a checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from reverb_tpu_torch.convert import tree_key
from reverb_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                            opt_state_shardings,
                                            param_shardings)

_BUCKET = 1 << 25          # elements a gradient all-reduce moves at once


@dataclasses.dataclass
class ParamLayout:
    tp_axis: Optional[int] = None            # split over 'model'
    tp_index: Optional[torch.Tensor] = None  # this rank's rows of tp_axis
    zero_axis: Optional[int] = None          # moments split over 'data'
    zero3: bool = False                      # the parameter stored split


def _all_gather(t, axis: int, group) -> torch.Tensor:
    """The group's blocks of `t` along `axis`, concatenated in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, axis)


class Sharding:
    """The layout of one model and optimizer over `mesh`: 'model' is the
    tensor-parallel axis, 'data' the data-parallel one; `zero` shards the
    moments over 'data' (ZeRO-1/2, as the JAX package's bin/train always
    does), `zero3` the large parameters too."""

    def __init__(self, mesh, zero: bool = True, zero3: bool = False,
                 zero3_min_size: int = 65536):
        self.mesh = mesh
        self.zero = zero or zero3
        self.zero3 = zero3
        self.zero3_min_size = zero3_min_size
        self.data_size = axis_size(mesh, 'data')
        self.data_rank = axis_rank(mesh, 'data')
        self.tp_size = axis_size(mesh, 'model')
        self.tp_rank = axis_rank(mesh, 'model')
        self.data_group = mesh.get_group('data')
        self.tp_group = mesh.get_group('model')
        self.layouts: Dict[str, ParamLayout] = {}
        self.model = None
        self.optimizer = None

    # ------------------------------ layout ------------------------------

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

    def _layouts(self, model):
        shapes = {tree_key(n): tuple(p.shape)
                  for n, p in model.named_parameters()}
        pspec = param_shardings(shapes, self.mesh, self.zero3,
                                self.zero3_min_size)
        mspec = opt_state_shardings(shapes, self.mesh, self.zero)
        out = {}
        for name, p in model.named_parameters():
            path = tree_key(name)
            lay = ParamLayout()
            if self.tp_size > 1 and 'model' in pspec[path]:
                lay.tp_axis = pspec[path].index('model')
                lay.tp_index = self._tp_index(name, p.shape[lay.tp_axis],
                                              p.device)
            if self.data_size > 1 and 'data' in mspec[path]:
                lay.zero_axis = mspec[path].index('data')
                lay.zero3 = 'data' in pspec[path]
                if lay.zero3:
                    assert pspec[path].index('data') == lay.zero_axis
            out[name] = lay
        return out

    def _split_layers(self, model):
        """Give each split layer its rank's share of the work."""
        from reverb_tpu_torch.models.attention import MultiHeadedAttention
        from reverb_tpu_torch.models.encoder import FeedForward
        from reverb_tpu_torch.models.modules import (Conv1d, Embedding,
                                                     LayerNorm, Linear)
        tp = self.tp_size
        for mname, m in model.named_modules():
            lay = self.layouts.get(f'{mname}.weight')
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
            if isinstance(m, LayerNorm):
                raise NotImplementedError(
                    f"{mname}: cnn_module_norm 'layer_norm' normalises over "
                    f"all channels; under tensor parallelism only "
                    f"'batch_norm' is split")
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
        """The TP block, then the ZeRO block, of a whole-shaped tensor."""
        lay = self.layouts[name]
        if lay.tp_axis is not None:
            t = t.index_select(lay.tp_axis, lay.tp_index)
        return self._zero_view(lay, t).clone()

    def _zero_view(self, lay, t):
        if lay.zero_axis is None or t.dim() == 0:
            return t
        n = t.shape[lay.zero_axis] // self.data_size
        return t.narrow(lay.zero_axis, self.data_rank * n, n)

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
                if lay.tp_axis is not None:
                    p.data = p.data.index_select(lay.tp_axis,
                                                 lay.tp_index).contiguous()
            if optimizer is not None:
                names = [optimizer.names[i] for i in optimizer.train_idx]
                for moments in (optimizer.mu, optimizer.nu):
                    for j, name in enumerate(names):
                        if moments[j].dim():
                            moments[j] = self._local(name, moments[j])
                lays = [self.layouts[n] for n in names]
                optimizer.views = [
                    (lambda t, lay=lay: self._zero_view(lay, t))
                    for lay in lays]
                optimizer.leaf_sq = self._leaf_sq_fn(lays)
        self.release_params()
        return self

    # --------------------------- the step ---------------------------

    def _zero3_params(self):
        return [(n, p) for n, p in self.model.named_parameters()
                if self.layouts[n].zero3]

    def gather_params(self):
        """ZeRO-3: every split parameter back to its whole (TP-local)
        shape, for a forward."""
        with torch.no_grad():
            for name, p in self._zero3_params():
                lay = self.layouts[name]
                p.data = _all_gather(p.data, lay.zero_axis, self.data_group)

    def release_params(self):
        """ZeRO-3: keep only this rank's block of each split parameter."""
        with torch.no_grad():
            for name, p in self._zero3_params():
                p.data = self._zero_view(self.layouts[name], p.data).clone()

    def reduce_grads(self, grads: List[torch.Tensor]):
        """Sum the gradients over 'data' in place, in flat buckets."""
        if self.data_size == 1:
            return
        i = 0
        while i < len(grads):
            j, size = i, 0
            while j < len(grads) and (size == 0 or
                                      size + grads[j].numel() <= _BUCKET):
                size += grads[j].numel()
                j += 1
            flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
            dist.all_reduce(flat, group=self.data_group)
            off = 0
            for g in grads[i:j]:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            i = j

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
        'model'-split gradients summed over 'model'; each rank holds the
        whole gradient of the rest after `reduce_grads`."""
        names = [n for n, _ in self.model.named_parameters()]
        sq = [n * n for n in torch._foreach_norm(grads)]
        if self.tp_size > 1:
            sq = list(self._sum_over(
                sq, [self.layouts[n].tp_axis is not None for n in names],
                self.tp_group))
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
        """ZeRO-3 parameters gathered (for an evaluation) inside."""
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

    def _whole(self, name, t):
        """A moment's block (TP, then ZeRO) → its whole tensor."""
        lay = self.layouts[name]
        if lay.zero_axis is not None:
            t = _all_gather(t, lay.zero_axis, self.data_group)
        return t if lay.tp_axis is None else self._whole_tp(name, t)

    @contextlib.contextmanager
    def gathered(self):
        """Inside, every parameter and moment holds its whole
        single-process value (a collective: every rank enters), so
        `train/checkpoint.py:save_checkpoint` writes the one layout that
        any run resumes into; the split layout is restored after."""
        opt = self.optimizer
        params = list(self.model.named_parameters())
        saved, moments = [], []
        self.gather_params()
        try:
            with torch.no_grad():
                for name, p in params:
                    saved.append(p.data)
                    if self.layouts[name].tp_axis is not None:
                        p.data = self._whole_tp(name, p.data)
                if opt is not None:
                    names = [opt.names[i] for i in opt.train_idx]
                    for ms in (opt.mu, opt.nu):
                        moments.append(list(ms))
                        for j, name in enumerate(names):
                            if ms[j].dim():
                                ms[j] = self._whole(name, ms[j])
            yield
        finally:
            for (_, p), d in zip(params, saved):
                p.data = d
            if moments:
                opt.mu[:], opt.nu[:] = moments
            self.release_params()
