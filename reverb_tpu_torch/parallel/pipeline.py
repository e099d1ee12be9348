"""Pipeline parallelism: the GPipe schedule over a 'pipe' mesh axis.

Counterpart of reverb_tpu/parallel/pipeline.py (`pipeline_apply`).  Stage
s of S holds layers [s·L/S, (s+1)·L/S) of a region of L homogeneous
layers (models/encoder.py:ConformerEncoder.pipe_region); the batch is cut
into M microbatches, and the schedule runs M + S − 1 ticks: at tick t
stage s runs microbatch t − s through its layers and sends the result to
stage s + 1 (parallel/collectives.py:send_recv); the per-microbatch
arguments (key lengths, the pad mask, a chunk mask) go with their
microbatch.  The last stage's outputs are broadcast to every stage, as
JAX's psum of the emits gives them to every device, so the layers after
the region and the loss run whole on every 'pipe' rank.  Bubbles are
(S − 1)/(M + S − 1) of the ticks.

`gpipe` is one autograd function: its forward runs the ticks keeping each
microbatch's graph (or only its input, with `remat`: the stage's layers
are recomputed in the backward, as JAX's jax.checkpoint of the stage
body), and its backward runs them in reverse, `torch.autograd.backward`
on each saved graph with the cotangent the next stage sent back, so the
stage's parameters take their gradients there and the trainer's one
`loss.backward()` drives the whole schedule.  The output's cotangent is
summed over the stages first: each 'pipe' rank computed the loss whole,
scaled by 1/S (train/trainer.py), so the sum is the loss's.  The region's
input takes its gradient on stage 0 alone (zero elsewhere), so the
layers before the region, summed over 'pipe', take theirs once.  Every
rank issues the same collectives in the same order.

The schedule runs on whatever block of the batch's rows a rank holds: a
'pipe' group joins the stages of one coordinate along every other axis
(parallel/mesh.py:axis_ranks), so under 'seq' stage s passes its time
block (B/M, T/n, D) to the next stage's rank of the same block, and the
stage's 'seq' and 'expert' collectives (the K/V gather, the conv halo,
the experts' sums) run inside `stage_fn`, among the ranks of one stage,
which run the same ticks; a recomputation in the backward re-issues them
in the same order on each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from reverb_tpu_torch.parallel.collectives import send_recv


@dataclasses.dataclass
class PipeStage:
    """This rank's place in the pipeline: stage `rank` of `size` over
    `group`, whose global ranks in stage order are `ranks`, with
    `microbatches` microbatches a batch."""
    group: object
    rank: int
    size: int
    ranks: Sequence[int]
    microbatches: int


def mb_generator(seed: int, microbatch: int, device) -> torch.Generator:
    """The dropout generator of one region layer (its `seed`) on one
    microbatch."""
    s = int(np.random.SeedSequence([seed, microbatch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, st, batch_args, remat, x, *params):
        S, s, M = st.size, st.rank, st.microbatches
        mb = x.shape[0] // M
        micro = x.detach().split(mb)
        args = [[None if a is None else a[m * mb:(m + 1) * mb]
                 for a in batch_args] for m in range(M)]
        saved: List = [None] * M
        emits: List = [None] * M
        inbuf = None
        for t in range(M + S - 1):
            m = t - s
            out = None
            if 0 <= m < M:
                h = (micro[m] if s == 0 else inbuf).detach() \
                    .requires_grad_()
                with torch.set_grad_enabled(not remat):
                    out = stage_fn(h, m, *args[m])
                saved[m] = (h, None if remat else out)
                if s == S - 1:
                    emits[m] = out.detach()
            recv = s > 0 and 0 <= t + 1 - s < M
            inbuf = send_recv(
                out if out is not None and s < S - 1 else None,
                st.ranks[s + 1] if out is not None and s < S - 1 else None,
                micro[0], st.ranks[s - 1] if recv else None, st.group)
        y = torch.cat(emits) if s == S - 1 else torch.empty_like(x)
        dist.broadcast(y, src=st.ranks[S - 1], group=st.group)
        ctx.stage_fn, ctx.st, ctx.args, ctx.remat = stage_fn, st, args, remat
        ctx.saved, ctx.like = saved, micro[0]
        return y

    @staticmethod
    def backward(ctx, gy):
        st, saved = ctx.st, ctx.saved
        S, s, M = st.size, st.rank, st.microbatches
        gy = gy.contiguous().clone()
        dist.all_reduce(gy, group=st.group)
        g_out = gy.split(gy.shape[0] // M)
        gx: List = [None] * M
        buf = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            gin = None
            if 0 <= m < M:
                g = g_out[m] if s == S - 1 else buf
                h, out = saved[m]
                if ctx.remat:
                    with torch.enable_grad():
                        out = ctx.stage_fn(h, m, *ctx.args[m])
                torch.autograd.backward(out, g)
                gin = h.grad if h.grad is not None else torch.zeros_like(h)
                saved[m] = None
                if s == 0:
                    gx[m] = gin
            recv = s < S - 1 and 0 <= t - 1 - s < M
            buf = send_recv(
                gin if gin is not None and s > 0 else None,
                st.ranks[s - 1] if gin is not None and s > 0 else None,
                ctx.like, st.ranks[s + 1] if recv else None, st.group)
        grad_x = torch.cat(gx) if s == 0 else torch.zeros(
            (ctx.like.shape[0] * M,) + tuple(ctx.like.shape[1:]),
            dtype=gy.dtype, device=gy.device)
        return (None, None, None, None, grad_x) + (None,) * (
            len(ctx.needs_input_grad) - 5)


def gpipe(stage_fn: Callable, x, stage: PipeStage, batch_args=(),
          remat: bool = False, params=()):
    """x (B, ...) through every stage's layers, the GPipe schedule over
    `stage`'s group: `stage_fn(h, m, *args)` runs this stage's layers on
    microbatch m (h its B/M rows) with `args` the rows of each of
    `batch_args` (None stays None); `params`, this stage's parameters, are
    the function's inputs too, so that its backward runs wherever they
    train.  B must divide by stage.microbatches.  Returns the layers'
    output for the whole batch on every stage."""
    if x.shape[0] % stage.microbatches:
        raise ValueError(f'{x.shape[0]} rows do not split into '
                         f'{stage.microbatches} microbatches')
    return _GPipe.apply(stage_fn, stage, tuple(batch_args), remat, x,
                        *params)
