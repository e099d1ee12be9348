"""The forms of tests/test_torch_families_axes.py: one process's steps of
a form, and one rank of the world-2 group that runs every form.

Usage: python tests/torch_families_axes_worker.py <rank> <work_dir>

The parent writes forms.json ({form: {'conf', 'axes', 'opts', 'accum',
'init', 'seed'}}), the initial parameters of the forms held to the JAX
package (<form>.init.npz) and each form's global batches
(<form>.batches.npz) into work_dir.  Each rank joins a gloo group of two
through a file in work_dir, then runs every form in turn: its model from
the same initial parameters, split over make_mesh(**axes) (`opts` for
the Sharding), two steps with accum_grad `accum` on the rank's rows of
each global batch, after which rank 0 writes the metrics, the encoder's
'seq' counts, every attention's heads before and after the split and
the gathered parameters (<form>.json, <form>.npz).  Last, each rank
applies a 'model' Sharding to a model whose rule-matched parameters
have no split form and writes the error (refused_rank<r>.txt), and
sums a replicated gradient that differs by rank over an 'expert' mesh
(expert_average_rank<r>.json).
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

from torch_families_parallel_worker import (build, flat_params,  # noqa: E402
                                            load_batches, to_torch)


def one_process(work, form, spec):
    """The port's one-process steps on the whole batches (accum_grad of
    the form; a generator of its `seed`, if any): (metrics, flat
    parameters after the last)."""
    from reverb_tpu_torch.train import trainer as ttr
    model, loss_fn, cfg, opt, tc = build(work, form, spec)
    step = ttr.make_train_step(cfg, opt, spec['accum'], tc.grad_clip,
                               loss_fn=loss_fn)
    gen = (None if spec['seed'] is None
           else torch.Generator().manual_seed(spec['seed']))
    metrics = [step(model, to_torch(b), gen)
               for b in load_batches(work, form)]
    return metrics, flat_params(model)


def heads(model):
    """{attention module: heads} of every attention block."""
    from reverb_tpu_torch.parallel.sharding import _block_kind
    return {n: m.h for n, m in model.named_modules()
            if _block_kind(m) == 'attention'}


def refused(mesh) -> str:
    """The error of a 'model' Sharding over a model whose `feed_forward`
    (a ModuleDict, not a feed-forward with a split form) holds the
    parameters the FFN rule splits."""
    from torch import nn
    from reverb_tpu_torch.models.modules import Linear
    from reverb_tpu_torch.parallel.sharding import Sharding
    model = nn.Module()
    model.feed_forward = nn.ModuleDict({'w_1': Linear(8, 16),
                                        'w_2': Linear(16, 8)})
    try:
        Sharding(mesh).apply(model)
    except ValueError as e:
        return str(e)
    return ''


def expert_average(mesh) -> list:
    """A replicated parameter's gradient, which each 'expert' rank
    computed whole and (as on the card) with its own roundings — here
    rank + 1 — after `reduce_grads`: the group's mean on every rank."""
    import torch.distributed as dist
    from torch import nn
    from reverb_tpu_torch.models.modules import Linear
    from reverb_tpu_torch.parallel.sharding import Sharding
    model = nn.Module()
    model.head = Linear(4, 4)
    sh = Sharding(mesh).apply(model)
    grads = [torch.full_like(p, float(dist.get_rank() + 1))
             for p in model.parameters()]
    sh.reduce_grads(grads)
    return [float(g.flatten()[0]) for g in grads]


def main(rank: int, work: str):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from reverb_tpu_torch.parallel import mesh as pm
    from reverb_tpu_torch.parallel.sharding import Sharding
    from reverb_tpu_torch.train import trainer as ttr

    pm.init_distributed(f'file://{work}/pg', 2, rank, 'cpu')
    forms = json.load(open(f'{work}/forms.json'))
    for form, spec in forms.items():
        mesh = pm.make_mesh(**spec['axes'])
        model, loss_fn, cfg, opt, tc = build(work, form, spec)
        unsplit = heads(model)
        sh = Sharding(mesh, **spec['opts']).apply(model, opt)
        step = ttr.make_train_step(cfg, opt, spec['accum'], tc.grad_clip,
                                   sharding=sh, loss_fn=loss_fn)
        gen = (None if spec['seed'] is None
               else pm.dropout_generator(spec['seed'], mesh, 'cpu'))
        metrics = [step(model, to_torch(pm.local_rows(b, mesh)), gen)
                   for b in load_batches(work, form)]
        enc = model.encoder
        got = {'metrics': metrics, 'heads': [unsplit, heads(model)],
               'seq_steps': dict(getattr(enc, 'seq_steps', {})),
               'tp_split': sum(lay.tp_axis is not None
                               for lay in sh.layouts.values()),
               'pipe_region': sh.encoder is not None,
               'experts_split': sum(lay.owner('expert') is not None
                                    for lay in sh.layouts.values())}
        with sh.gathered():
            if rank == 0:
                np.savez(f'{work}/{form}.npz', **flat_params(model))
                with open(f'{work}/{form}.json', 'w') as f:
                    json.dump(got, f)
        dist.barrier()
    with open(f'{work}/refused_rank{rank}.txt', 'w') as f:
        f.write(refused(pm.make_mesh(model=2)))
    with open(f'{work}/expert_average_rank{rank}.json', 'w') as f:
        json.dump(expert_average(pm.make_mesh(expert=2)), f)
    dist.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), sys.argv[2])
