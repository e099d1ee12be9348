"""The collectives of the split layers, as autograd functions: Megatron's
f and g operators and the vocabulary gather (tensor and expert
parallelism), the time gather and the halo exchange ('seq'), and the
stage-to-stage transfer of the GPipe schedule ('pipe').

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
  own columns of the gradient backward; `gather_last_sum` the same with
  the ranks' gradients summed first (a reduce-scatter).

`group` is a torch.distributed process group; a layer with none runs
unsplit.

Under 'seq' (`TimeSplit`) the encoder's time axis of T frames is cut
into n blocks of b = ceil(T/n) frames (the last padded):

- `TimeSplit.gather` concatenates the ranks' blocks in rank order
  forward; backward each rank takes the sum over the group of the
  gradient's rows of its block (a reduce-scatter): the gathered tensor's
  consumers on every rank each contributed a part of its gradient (the
  attention keys of every rank's queries; the encoder output of a
  replicated loss scaled by 1/n, train/trainer.py);
- `TimeSplit.halo` puts `left` frames of the previous rank's block and
  `right` frames of the next rank's around this rank's (zeros past either
  end of the axis); backward each halo's gradient goes back to the
  neighbour it came from and is added to its frames.

gloo has no reduce-scatter: it is an all-reduce of which each rank keeps
its block.  The halo exchange is an all-gather of the blocks' edges (every
rank needs two neighbours' edges and gloo carries all-gathers of CUDA
tensors), and `send_recv` copies CUDA tensors through host memory under
gloo, whose point-to-point transfers take CPU tensors.
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


class _GatherLastSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group, ctx.rank = group, rank
        n = dist.get_world_size(group)
        return torch.cat(_gather_parts(x, group, n), -1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return _reduce_scatter(g, g.dim() - 1, ctx.group, n,
                               ctx.rank), None, None


def copy_in(x, group):
    return _CopyIn.apply(x, group)


def reduce_out(x, group):
    return _ReduceOut.apply(x, group)


def gather_last(x, group, rank: int):
    return _GatherLast.apply(x, group, rank)


def gather_last_sum(x, group, rank: int):
    """`gather_last` whose backward sums the ranks' gradients before
    taking this rank's columns: for a gathered tensor that every rank's
    consumer differentiates in part (the split conv channels under a
    LayerNorm)."""
    return _GatherLastSum.apply(x, group, rank)


def _reduce_scatter(g, axis: int, group, n: int, rank: int):
    """Σ of g over the group, this rank's block of it along `axis`."""
    blk = g.shape[axis] // n
    if dist.get_backend(group) == 'nccl':
        moved = g.movedim(axis, 0).contiguous()
        out = moved.new_empty((blk,) + tuple(moved.shape[1:]))
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out.movedim(0, axis)
    g = g.contiguous().clone()
    dist.all_reduce(g, group=group)
    return g.narrow(axis, rank * blk, blk)


def _gather_parts(x, group, n: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


class TimeSplit:
    """A time axis of `length` frames over a 'seq' group of n ranks: rank
    r holds frames [r·b, (r+1)·b) of the axis padded to n·b frames, b =
    ceil(length / n)."""

    def __init__(self, group, rank: int, n: int, length: int):
        self.group, self.rank, self.n, self.length = group, rank, n, length
        self.block = -(-length // n)
        self.padded = self.block * n
        self.start = rank * self.block

    def entry(self, axis: int):
        """This split of an activation's `axis`, for
        models/modules.py:keep_mask."""
        return (axis, self.rank, self.n, self.length)

    def take(self, x, axis: int = 1):
        """This rank's block of x's whole `axis` (zeros past its end)."""
        pad = self.padded - x.shape[axis]
        if pad:
            shape = list(x.shape)
            shape[axis] = pad
            x = torch.cat([x, x.new_zeros(shape)], axis)
        return x.narrow(axis, self.start, self.block)

    def valid(self, device):
        """(b,) bool: this rank's frames that lie inside the axis."""
        return torch.arange(self.start, self.start + self.block,
                            device=device) < self.length

    def gather(self, x):
        """x (B, b, ...) → the blocks of every rank (B, n·b, ...)."""
        return _GatherTime.apply(x, self)

    def halo(self, x, left: int, right: int):
        """x (B, b, C) → (B, left + b + right, C) with the neighbours'
        frames (zeros past the ends of the axis)."""
        if max(left, right) > self.block:
            raise ValueError(f'a halo of {max(left, right)} frames over '
                             f'blocks of {self.block}')
        return _Halo.apply(x, self, left, right)


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return torch.cat(_gather_parts(x, split.group, split.n), 1)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return _reduce_scatter(g, 1, s.group, s.n, s.rank), None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, left, right):
        ctx.split, ctx.left, ctx.right = split, left, right
        b, r, n = x.shape[1], split.rank, split.n
        edges = _gather_parts(torch.cat([x[:, :right], x[:, b - left:]], 1),
                              split.group, n)
        lh = edges[r - 1][:, right:] if r > 0 else \
            x.new_zeros((x.shape[0], left) + tuple(x.shape[2:]))
        rh = edges[r + 1][:, :right] if r < n - 1 else \
            x.new_zeros((x.shape[0], right) + tuple(x.shape[2:]))
        return torch.cat([lh, x, rh], 1)

    @staticmethod
    def backward(ctx, g):
        s, left, right = ctx.split, ctx.left, ctx.right
        r, n = s.rank, s.n
        b = g.shape[1] - left - right
        core = g[:, left:left + b].clone()
        parts = _gather_parts(torch.cat([g[:, :left], g[:, left + b:]], 1),
                              s.group, n)
        if r < n - 1 and left:       # the next rank's left halo: my tail
            core[:, b - left:] += parts[r + 1][:, :left]
        if r > 0 and right:          # the previous rank's right halo
            core[:, :right] += parts[r - 1][:, left:]
        return core, None, None, None


def send_recv(send, dst, recv_like, src, group):
    """Send `send` to global rank `dst` and receive from global rank `src`
    a tensor shaped like `recv_like` (either side None: nothing), both
    posted before either is waited on.  Under gloo CUDA tensors travel
    through host memory."""
    host = dist.get_backend(group) == 'gloo'
    ops, buf = [], None
    if send is not None:
        t = send.detach().contiguous()
        t = t.cpu() if host else t
        ops.append(dist.P2POp(dist.isend, t, dst, group))
    if src is not None:
        buf = torch.empty_like(recv_like, device='cpu' if host else
                               recv_like.device)
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if buf is not None and host:
        buf = buf.to(recv_like.device)
    return buf
