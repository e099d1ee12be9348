"""The collectives of the tensor-parallel layers, as autograd functions
(Megatron's f and g operators, and the vocabulary gather).

Over a 'model' group of size n each rank holds 1/n of a layer's heads,
hidden units, channels or vocabulary rows, and the activations between
those layers are replicated:

- `copy_in` (f) is the input of a column-parallel layer: the identity
  forward, a sum of the ranks' partial input gradients backward;
- `reduce_out` (g) is the output of a row-parallel layer: a sum of the
  ranks' partial products forward, the identity backward (every rank
  holds the whole output gradient);
- `gather_last` is the output of a vocabulary-parallel projection: the
  ranks' column blocks concatenated in rank order forward, each rank's
  own columns of the gradient backward.

`group` is a torch.distributed process group; a layer with none runs
unsplit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w], None, None


def copy_in(x, group):
    return _CopyIn.apply(x, group)


def reduce_out(x, group):
    return _ReduceOut.apply(x, group)


def gather_last(x, group, rank: int):
    return _GatherLast.apply(x, group, rank)
