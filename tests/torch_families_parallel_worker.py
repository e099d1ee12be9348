"""The model families of tests/test_torch_families_parallel.py: how each
form builds its model and loss, one process's steps, and one rank of the
world-2 group.

Usage: python tests/torch_families_parallel_worker.py <rank> <work_dir>

The parent writes forms.json ({form: {'conf', 'opts', 'init', 'seed'}}),
each form's initial parameters where they are JAX's (<form>.init.npz)
and its global batches (<form>.batches.npz) into work_dir.  Each rank joins a
gloo group of two through a file in work_dir, then runs every form in
turn: its model from the same initial parameters, split over 'data' (DDP,
ZeRO-1/2 or ZeRO-3 as `opts` says), two steps on the rank's rows of each
global batch (with the rank's `dropout_generator` of the form's `seed`,
if any), after which rank 0 writes the metrics and the gathered
parameters (<form>.json, <form>.npz).
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 2


def load_batches(work, form):
    with np.load(f'{work}/{form}.batches.npz') as z:
        return [{k.split('/')[1]: z[k] for k in z.files
                 if k.startswith(f'{i}/')} for i in range(STEPS)]


def build(work, form, spec):
    """(model, loss_fn, cfg, optimizer, train config) of a form, on the
    CPU: from JAX's initial parameters (<form>.init.npz) or from seed 0;
    a `ts` form's student is an asr_model and its teacher (one block)
    comes from seed 1, frozen."""
    from reverb_tpu_torch import convert, init_model
    from reverb_tpu_torch.models import asr_model as tam
    from reverb_tpu_torch.train import teacher_student as tts
    from reverb_tpu_torch.train import trainer as ttr
    conf = spec['conf']
    state = None
    if spec['init'] == 'npz':
        with np.load(f'{work}/{form}.init.npz') as z:
            state = convert.state_dict_from_jax({k: z[k] for k in z.files})
    bundle = init_model(conf, torch.Generator().manual_seed(0), 'cpu',
                        state_dict=state)
    model, loss_fn = bundle.model, bundle.loss_fn
    if 'ts_conf' in conf:
        tconf = dict(conf, encoder_conf=dict(conf['encoder_conf'],
                                             num_blocks=1))
        teacher = tam.build_model(tam.ModelConfig.from_config(tconf), 'cpu',
                                  generator=torch.Generator().manual_seed(1))
        ts = tts.TSConfig(**conf['ts_conf'])

        def loss_fn(model, batch, generator=None):
            return tts.ts_loss(model, teacher, batch, ts, generator)
    tc = ttr.TrainConfig.from_config(conf)
    opt, _ = ttr.build_optimizer(tc, model)
    return model, loss_fn, model.cfg, opt, tc


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if v.dtype.kind in 'iu' else torch.from_numpy(v)
            for k, v in batch.items()}


def flat_params(model):
    from reverb_tpu_torch import convert
    return convert.flat_from_state_dict(model.state_dict())


def one_process(work, form, spec):
    """The port's one-process steps on the whole batches (with a
    generator of the form's `seed`, if any): (metrics, flat parameters
    after the last)."""
    model, loss_fn, cfg, opt, tc = build(work, form, spec)
    from reverb_tpu_torch.train import trainer as ttr
    step = ttr.make_train_step(cfg, opt, 1, tc.grad_clip, loss_fn=loss_fn)
    gen = (None if spec['seed'] is None
           else torch.Generator().manual_seed(spec['seed']))
    metrics = [step(model, to_torch(b), gen)
               for b in load_batches(work, form)]
    return metrics, flat_params(model)


def main(rank: int, work: str):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from reverb_tpu_torch.parallel import mesh as pm
    from reverb_tpu_torch.parallel.sharding import Sharding
    from reverb_tpu_torch.train import trainer as ttr

    pm.init_distributed(f'file://{work}/pg', 2, rank, 'cpu')
    forms = json.load(open(f'{work}/forms.json'))
    for form, spec in forms.items():
        mesh = pm.make_mesh(data=2)
        model, loss_fn, cfg, opt, tc = build(work, form, spec)
        sh = Sharding(mesh, **spec['opts']).apply(model, opt)
        step = ttr.make_train_step(cfg, opt, 1, tc.grad_clip, sharding=sh,
                                   loss_fn=loss_fn)
        gen = (None if spec['seed'] is None
               else pm.dropout_generator(spec['seed'], mesh, 'cpu'))
        metrics = [step(model, to_torch(pm.local_rows(b, mesh)), gen)
                   for b in load_batches(work, form)]
        split = {'zero3': sum(lay.zero3 for lay in sh.layouts.values()),
                 'zero': sum(lay.zero_axis is not None
                             for lay in sh.layouts.values())}
        with sh.gathered():
            if rank == 0:
                np.savez(f'{work}/{form}.npz', **flat_params(model))
                with open(f'{work}/{form}.json', 'w') as f:
                    json.dump({'metrics': metrics, 'split': split}, f)
        dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), sys.argv[2])
