"""One rank of the process groups of tests/test_torch_parallel.py.

Usage: python tests/torch_parallel_worker.py <rank> <world> <work_dir>

The parent writes the configs, the initial parameters (the JAX package's
init, flat) and the global batches into work_dir.  Each rank joins a gloo
group through a file in work_dir, then runs every form of its world in
turn, from the same initial parameters: two sharded steps on its rows of
each global batch (parallel/mesh.py:local_rows), after which rank 0
writes the metrics and the gathered parameters (<form>.json, <form>.npz),
and for the ZeRO-3, TP, pipeline and expert forms a checkpoint of the
gathered state.  World 2 also takes TP 2's and 'seq' 2's two steps with
dropout beside the unsplit step's on the same generator seed, and 'pipe'
2's with dropout, draws dropout masks, checks that unequal row counts
raise and resumes the ZeRO-3 checkpoint under TP for a third step; world
4 takes 'pipe' 2 × 'seq' 2's two steps with dropout.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# form: (mesh axes, Sharding options, config file)
FORMS = {
    2: [('ddp', {'data': 2}, {'zero': False}, 'conf.json'),
        ('zero12', {'data': 2}, {'zero': True}, 'conf.json'),
        ('zero3', {'data': 2}, {'zero3': True, 'zero3_min_size': 8192},
         'conf.json'),
        ('tp2', {'data': 1, 'model': 2}, {'zero': True}, 'conf.json'),
        ('accum2', {'data': 2}, {'zero': False}, 'conf_accum.json'),
        # the encoder's time axis (LSL layers, batch_norm; 17 frames in
        # blocks of 9, the last padded)
        ('seq2', {'data': 1, 'seq': 2}, {'zero': True}, 'conf.json'),
        # 4 MoE blocks (4 experts, 2 a token): two experts a rank
        ('expert2', {'data': 1, 'expert': 2}, {'zero': True},
         'conf_pipe_moe.json'),
        # the same blocks, the two middle ones as 2 stages, 2 microbatches
        ('pipe2', {'data': 1, 'pipe': 2}, {'zero': True},
         'conf_pipe_moe.json'),
        # TP over the conv modules' LayerNorms
        ('tp2_ln', {'data': 1, 'model': 2}, {'zero': True},
         'conf_pipe_ln.json')],
    4: [('dp2tp2', {'data': 2, 'model': 2}, {'zero': True}, 'conf.json'),
        # reverb_large's decoder (bitransformer: no language layers)
        ('dp2tp2_bitr', {'data': 2, 'model': 2}, {'zero': True},
         'conf_bitr.json'),
        # NovoGrad's per-leaf norms summed over both split axes
        ('dp2tp2_novograd', {'data': 2, 'model': 2}, {'zero': True},
         'conf_novograd.json'),
        # JAX's test_pp_composed_with_dp_tp_train_step_matches_single_device
        # composition: 6 blocks, layer_norm conv modules, stages × TP
        ('pipe2tp2', {'data': 1, 'pipe': 2, 'model': 2}, {'zero': True},
         'conf_pipe_ln.json'),
        ('seq2tp2', {'data': 1, 'seq': 2, 'model': 2}, {'zero': True},
         'conf.json'),
        # every stage on the rank's time block (the pipe2tp2 blocks)
        ('pipe2seq2', {'data': 1, 'pipe': 2, 'seq': 2}, {'zero': True},
         'conf_pipe_ln.json'),
        # the region layers' experts split inside each stage
        ('pipe2expert2', {'data': 1, 'pipe': 2, 'expert': 2},
         {'zero': True}, 'conf_pipe_moe.json')],
}
# the initial parameters of each config (the others start at init.npz)
INITS = {'conf_bitr.json': 'init_bitr.npz',
         'conf_pipe_moe.json': 'init_pipe_moe.npz',
         'conf_pipe_ln.json': 'init_pipe_ln.npz'}
# the forms whose gathered state is saved as a checkpoint
CKPT_FORMS = ('zero3', 'tp2', 'pipe2', 'expert2', 'pipe2expert2')


def main(rank: int, world: int, work: str):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from reverb_tpu_torch import convert
    from reverb_tpu_torch.models import asr_model as tam
    from reverb_tpu_torch.models.modules import dropout, keep_mask
    from reverb_tpu_torch.parallel import mesh as pm
    from reverb_tpu_torch.parallel.sharding import Sharding
    from reverb_tpu_torch.train import checkpoint as tckpt
    from reverb_tpu_torch.train import trainer as ttr

    pm.init_distributed(f'file://{work}/pg{world}', world, rank, 'cpu')
    inits = {}

    def init_of(conf_name):
        """The initial parameters of a config (INITS)."""
        name = INITS.get(conf_name, 'init.npz')
        if name not in inits:
            with np.load(f'{work}/{name}') as z:
                inits[name] = {k: z[k] for k in z.files}
        return inits[name]
    with np.load(f'{work}/batches.npz') as z:
        batches = [{k.split('/')[1]: z[k] for k in z.files
                    if k.startswith(f'{i}/')} for i in range(3)]

    def build(conf_name, state=None):
        conf = json.load(open(f'{work}/{conf_name}'))
        cfg = tam.ModelConfig.from_config(conf)
        tc = ttr.TrainConfig.from_config(conf)
        model = tam.build_model(cfg, 'cpu', convert.state_dict_from_jax(
            init_of(conf_name) if state is None else state), train=True)
        opt, _ = ttr.build_optimizer(tc, model)
        return cfg, tc, model, opt

    def run(form, axes, opts, conf_name, steps=(0, 1), ckpt=None,
            seed=None):
        """`seed`: dropout from a generator of that seed on every rank."""
        mesh = pm.make_mesh(**axes)
        cfg, tc, model, opt = build(conf_name)
        if ckpt is not None:
            tckpt.load_checkpoint(ckpt, model, opt)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        sh = Sharding(mesh, **opts).apply(model, opt)
        split = {'tp': sum(lay.tp_axis is not None
                           for lay in sh.layouts.values()),
                 'zero3': sum(lay.zero3 for lay in sh.layouts.values()),
                 'zero': sum(lay.zero_axis is not None
                             for lay in sh.layouts.values()),
                 'expert': sum(lay.owner('expert') is not None
                               for lay in sh.layouts.values()),
                 'pipe': sum(lay.owner('pipe') is not None
                             for lay in sh.layouts.values()),
                 # experts kept by one stage and one 'expert' rank
                 'stage_expert': sum(len(lay.owners) == 2
                                     for lay in sh.layouts.values())}
        step = ttr.make_train_step(cfg, opt, tc.accum_grad, tc.grad_clip,
                                   sharding=sh)
        metrics = [step(model, pm.put_batch(batches[i], mesh, 'cpu'), gen)
                   for i in steps]
        split['seq_steps'] = dict(model.encoder.seq_steps)
        with sh.gathered():
            if rank == 0:
                np.savez(f'{work}/{form}.npz', **convert.flat_from_state_dict(
                    model.state_dict()))
                with open(f'{work}/{form}.json', 'w') as f:
                    json.dump({'metrics': metrics, 'split': split}, f)
                if form in CKPT_FORMS:
                    tckpt.save_checkpoint(f'{work}/ckpt_{form}', 'step_2',
                                          model, opt, {'step': 2})
        dist.barrier()

    for form, axes, opts, conf_name in FORMS[world]:
        run(form, axes, opts, conf_name)

    if world == 4:
        # 'pipe' 2 × 'seq' 2 with dropout (world 2 takes the 'pipe' 2 step
        # it equals)
        run('pipe2seq2_dropout', {'data': 1, 'pipe': 2, 'seq': 2},
            {'zero': True}, 'conf_pipe_ln.json', seed=3)
        # every rank's coordinates under 'seq', 'pipe' or 'expert' with
        # 'model' (JAX's device layout: tests/test_torch_parallel.py)
        coords = {}

        def gathered(values):
            mine = torch.tensor(values)
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine)
            return [p.tolist() for p in parts]
        for axis in ('seq', 'pipe', 'expert'):
            mesh = pm.make_mesh(**{axis: 2, 'model': 2})
            coords[axis] = gathered([pm.axis_rank(mesh, a)
                                     for a in pm.AXES])
        # under 'pipe' with 'seq' or 'expert': each rank's coordinates and
        # the global ranks of its 'pipe' group in stage order (the ranks
        # a stage sends to and receives from)
        for axis in ('seq', 'expert'):
            mesh = pm.make_mesh(pipe=2, **{axis: 2})
            coords[f'pipe_{axis}'] = {
                'coords': gathered([pm.axis_rank(mesh, a)
                                    for a in pm.AXES]),
                'pipe_group': gathered(pm.axis_ranks(mesh, 'pipe'))}
        if rank == 0:
            with open(f'{work}/coords.json', 'w') as f:
                json.dump(coords, f)
    if world == 2:
        # TP 2 with dropout, and on rank 0 the unsplit step, from one seed
        run('tp2_dropout', {'data': 1, 'model': 2}, {'zero': True},
            'conf.json', seed=3)
        run('seq2_dropout', {'data': 1, 'seq': 2}, {'zero': True},
            'conf.json', seed=3)
        run('pipe2_dropout', {'data': 1, 'pipe': 2}, {'zero': True},
            'conf_pipe_ln.json', seed=3)
        if rank == 0:
            cfg, tc, model, opt = build('conf.json')
            step = ttr.make_train_step(cfg, opt, tc.accum_grad, tc.grad_clip)
            gen = torch.Generator().manual_seed(3)
            metrics = [step(model, pm.put_batch(batches[i], None, 'cpu'),
                            gen) for i in (0, 1)]
            np.savez(f'{work}/unsplit_dropout.npz',
                     **convert.flat_from_state_dict(model.state_dict()))
            with open(f'{work}/unsplit_dropout.json', 'w') as f:
                json.dump({'metrics': metrics}, f)

        def same(m):
            parts = [torch.empty_like(m) for _ in range(world)]
            dist.all_gather(parts, m.contiguous())
            return bool(torch.equal(parts[0], parts[1])), parts
        # each data rank its own masks; in one 'model' group one mask of
        # a replicated activation, and of a split one each rank's block
        # of one unsplit mask
        masks = {}
        for name, axes in (('data', {'data': 2}), ('model', {'model': 2})):
            gen = pm.dropout_generator(7, pm.make_mesh(**axes), 'cpu')
            masks[name], _ = same(dropout(torch.ones(256), 0.5, gen))
        gen = pm.dropout_generator(7, pm.make_mesh(model=2), 'cpu')
        masks['model_split'], parts = same(
            keep_mask((4, 256), 0.5, gen, 'cpu', (1, rank, 2)))
        whole = keep_mask((4, 512), 0.5, torch.Generator().manual_seed(7),
                          'cpu')
        masks['split_blocks_unsplit'] = bool(torch.equal(
            torch.cat(parts, 1), whole))
        # unequal row counts raise on every rank
        mesh = pm.make_mesh(data=2)
        cfg, tc, model, opt = build('conf.json')
        sh = Sharding(mesh).apply(model, opt)
        step = ttr.make_train_step(cfg, opt, sharding=sh)
        rows = 2 if rank == 0 else 1
        try:
            step(model, pm.put_batch({k: v[:rows] for k, v in
                                      batches[0].items()}, None, 'cpu'))
            unequal = 'no error'
        except ValueError as e:
            unequal = str(e)
        if rank == 0:
            with open(f'{work}/checks.json', 'w') as f:
                json.dump({'same_mask': masks, 'unequal': unequal}, f)
        # the ZeRO-3 checkpoint resumed under tensor parallelism
        run('resume', {'data': 1, 'model': 2}, {'zero': True}, 'conf.json',
            steps=(2,), ckpt=f'{work}/ckpt_zero3/step_2.npz')
    dist.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
