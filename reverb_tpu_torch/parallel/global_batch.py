"""A loss as one data rank's share of the loss over the global batch.

JAX's losses are means over the GLOBAL batch: its rows, tokens, masked
frames or elements.  Inside `data_shard` (the sharded training step of
train/trainer.py wraps a model family's loss in it) each data rank sees
its own rows, and the helpers here give it the global quantities, so that
the ranks' losses and metrics summed over 'data' are the global batch's:

- `total(x)`: a count or denominator summed over the data ranks (no
  gradient);
- `mean(x)`: x's sum over this rank's elements / the global element count;
- `shared(x)`: a statistic summed over the data ranks whose gradient is
  summed back (for a nonlinear function of a global statistic, such as
  wav2vec 2.0's code perplexity of the global marginal; the term goes into
  the loss as its `share`, 1/N of it on each rank, so the ranks' gradients
  sum to the global one);
- `draw(t)`: data rank 0's draw on every rank, for draws that JAX makes
  once per global batch (the dynamic chunk, BEST-RQ's mask noise);
- `norms(batch)`: the global rows and tokens of an asr_model's loss
  (models/asr_model.py:compute_loss's `norm`).

Outside `data_shard` each helper is the identity of one process.  The
helpers sum over 'data' only: the ranks of one data coordinate ('model',
'seq', 'expert' and 'pipe' groups) hold the same rows, and the trainer's
`loss_scale` and gradient sums (parallel/sharding.py) cover them.

With gradient accumulation the global batch's micro-batch j is JAX's:
its rows [j·B/accum, (j+1)·B/accum) of the ranks' rows in rank order.
`regroup` gives each data rank its block of each micro-batch, so that the
helpers, inside micro-batch j, sum over exactly JAX's micro-batch j
(its denominators, wav2vec 2.0's code marginal, one draw of data rank 0).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_SHARD = None           # (group, size, global rank of data rank 0)


@contextlib.contextmanager
def data_shard(group, size: int):
    """Inside, the helpers sum over `group` (the data ranks, `size` of
    them)."""
    global _SHARD
    prev = _SHARD
    _SHARD = (group, size, dist.get_process_group_ranks(group)[0]) \
        if size > 1 else None
    try:
        yield
    finally:
        _SHARD = prev


def total(x):
    """x (a number or a tensor) summed over the data ranks, detached; x
    itself outside a data shard."""
    if _SHARD is None:
        return x
    if torch.is_tensor(x):
        t = x.detach().clone()
        dist.all_reduce(t, group=_SHARD[0])
        return t
    t = torch.tensor(float(x), dtype=torch.float64)
    if dist.get_backend(_SHARD[0]) == 'nccl':
        t = t.cuda()
    dist.all_reduce(t, group=_SHARD[0])
    return type(x)(t.item())


def mean(x):
    """The mean of x's elements over the global batch: this rank's sum /
    the global count (x.mean() outside a data shard)."""
    if _SHARD is None:
        return x.mean()
    return x.sum() / total(x.numel())


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def shared(x):
    """x summed over the data ranks, differentiably: the gradient of the
    sum is summed over the ranks too, so a term f(sum) that each rank adds
    as `share(f)` gives every rank's x the gradient f'(sum)."""
    return x if _SHARD is None else _Shared.apply(x, _SHARD[0])


def share(x):
    """A rank's share of a term computed whole on every rank: x / N."""
    return x if _SHARD is None else x / _SHARD[1]


def draw(t):
    """Data rank 0's `t` on every data rank (a draw JAX makes once for the
    global batch)."""
    if _SHARD is None:
        return t
    t = t.contiguous().clone()
    dist.broadcast(t, src=_SHARD[2], group=_SHARD[0])
    return t


def norms(batch: Dict) -> Optional[Dict]:
    """{'rows', 'tokens'} of the global batch (target length + 1 a row, eos
    included) for compute_loss's `norm`; None outside a data shard."""
    if _SHARD is None:
        return None
    B = batch['feats'].shape[0]
    tokens = (batch['target_lengths'] + 1).sum() \
        if 'target_lengths' in batch else torch.zeros((), dtype=torch.int64)
    counts = total(torch.stack([torch.as_tensor(B, device=tokens.device),
                                tokens.to(torch.int64)]))
    return {'rows': int(counts[0]), 'tokens': int(counts[1])}


def regroup(chunks: List[Dict], group, ranks: List[int],
            rank: int) -> List[Dict]:
    """This data rank's block of each micro-batch of the global batch.

    `chunks` are the rank's rows cut into accum equal micro-batches (its
    global chunks c = rank·accum + i, i < accum); `group` the data
    group, `ranks` its global ranks in data order, `rank` this rank's
    data coordinate.  Micro-batch j of the global batch is the chunks
    [j·N, (j+1)·N) for N data ranks, so this rank takes chunk j·N + rank,
    which data rank (j·N + rank) // accum holds: the chunks travel
    point to point, each with its own shapes (a rank's batch may be
    padded to other lengths), through host memory under gloo.  Every
    rank holds as many rows (train/trainer.py checks)."""
    N, accum = len(ranks), len(chunks)
    keys = sorted(chunks[0])
    meta = [[(k, tuple(c[k].shape), c[k].dtype) for k in keys]
            for c in chunks]
    metas = [None] * N
    dist.all_gather_object(metas, meta, group=group)
    host = dist.get_backend(group) == 'gloo'
    dev = chunks[0]['feats'].device
    ops, out, recv = [], [None] * accum, []
    for i, chunk in enumerate(chunks):           # what this rank sends
        c = rank * accum + i
        dst, j = c % N, c // N
        if dst == rank:
            out[j] = chunk
            continue
        for k in keys:
            t = chunk[k].contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if host else t,
                                  ranks[dst], group))
    for j in range(accum):                       # what it receives
        src, i = divmod(j * N + rank, accum)
        if src == rank:
            continue
        bufs = {k: torch.empty(shape, dtype=dtype,
                               device='cpu' if host else dev)
                for k, shape, dtype in metas[src][i]}
        for k in keys:
            ops.append(dist.P2POp(dist.irecv, bufs[k], ranks[src], group))
        recv.append((j, bufs))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for j, bufs in recv:
        out[j] = {k: v.to(dev) for k, v in bufs.items()}
    return out
