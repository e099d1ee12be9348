"""Data parallelism, ZeRO-1/2, ZeRO-3, tensor parallelism and the 'seq',
'expert' and 'pipe' axes of the port's training step
(reverb_tpu_torch/parallel/, train/trainer.py) against the JAX package's
single-device step, f32 on the CPU over gloo.

One world-2 and one world-4 process group are spawned once for the module
(tests/torch_parallel_worker.py, `torch.set_num_threads(1)` in every rank,
the rendezvous through a file); each rank runs every form of its world in
turn from the same initial parameters (the JAX package's init), two steps
on its rows of each global batch.  The forms: DDP, ZeRO-1/2, ZeRO-3 (a
minimum size that splits the tiny model's large weights), TP 2, DP 2 × TP
2 with ZeRO-1/2 (with Adam, with NovoGrad, whose per-leaf norms sum
over both split axes, and with reverb_large's plain bitransformer
decoder), DDP with accum_grad 2 and a length-normalised loss, 'seq' 2,
'expert' 2 (4 experts, 2 a token) and 'pipe' 2 (the two middle MoE
blocks of four as stages, 2 microbatches, batch_norm conv modules) on
one config, TP 2 over layer_norm conv modules, and at world 4 'pipe' 2 ×
TP 2 (six blocks, layer_norm: the composition of JAX's
test_pp_composed_with_dp_tp_train_step_matches_single_device), 'seq' 2 ×
TP 2, 'pipe' 2 × 'seq' 2 (every stage on the rank's time block, the same
six blocks) and 'pipe' 2 × 'expert' 2 (the MoE blocks, the region
layers' experts split inside each stage).  The JAX package composes both
of the last two under GSPMD; no test of its own covers them, so they are
held to its single-device step as the others are.
Bounds are the JAX package's own for its sharded steps
(tests/test_parallel_axes.py): loss and grad norm within rtol 1e-4, every
updated parameter within 1e-4.  No dropout where the packages are
compared; Adam's eps is 1e-3 (tests/test_torch_train.py says why).

The model is a tiny LSL conformer + LSL bitransformer (or bitransformer)
at width 128 with two 64-wide heads (K1/K4 and K5/K6 take their plain
versions on the CPU); V = 24, so the vocabulary splits over two ranks.
"""

import fcntl
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import presets as jpresets
from reverb_tpu.train import trainer as jtr
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.parallel.mesh import AXES
from reverb_tpu_torch.train import checkpoint as tckpt
from reverb_tpu_torch.train import trainer as ttr

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

D = 128
CLIP = 5.0
FORMS = ['ddp', 'zero12', 'zero3', 'tp2', 'dp2tp2', 'accum2',
         'dp2tp2_novograd', 'dp2tp2_bitr', 'seq2', 'expert2', 'pipe2',
         'tp2_ln', 'pipe2tp2', 'seq2tp2', 'pipe2seq2', 'pipe2expert2']
WANT = {'accum2': 'accum', 'dp2tp2_novograd': 'novograd',
        'dp2tp2_bitr': 'bitr', 'expert2': 'pipe_moe', 'pipe2': 'pipe_moe',
        'tp2_ln': 'pipe_ln', 'pipe2tp2': 'pipe_ln', 'pipe2seq2': 'pipe_ln',
        'pipe2expert2': 'pipe_moe'}
# the config (and initial parameters) of each key: file names
CONF_FILES = {'base': 'conf', 'accum': 'conf_accum',
              'novograd': 'conf_novograd', 'bitr': 'conf_bitr',
              'pipe_moe': 'conf_pipe_moe', 'pipe_ln': 'conf_pipe_ln'}


def _conf(accum=False, novograd=False, decoder='lsl_bitransformer',
          num_blocks=2, **enc):
    conf = jpresets.reverb_config(output_size=D, attention_heads=2,
                                  linear_units=96, num_blocks=num_blocks,
                                  dec_blocks=1, r_blocks=1, vocab_size=24)
    conf['encoder_conf'].update(enc)
    conf['decoder'] = decoder
    conf['optim_conf'] = {'lr': 1e-2, 'eps': 1e-3}
    conf['scheduler_conf'] = {'warmup_steps': 6}
    conf['grad_clip'] = CLIP
    if accum:
        conf['accum_grad'] = 2
        conf['model_conf'] = dict(conf['model_conf'],
                                  length_normalized_loss=True)
    if novograd:
        # an update of lr·g/‖g‖ a leaf: the rel-pos key biases, whose
        # gradient is rounding noise (0 in exact arithmetic), step lr in
        # a noise direction, so the rate bounds how far the two packages
        # part there (2.3e-5 at 0.1 for the unsharded port, 1.0e-4 at 0.5)
        conf['optim'] = 'novograd'
        conf['optim_conf'] = {'lr': 0.1}
    return conf


def _params(conf):
    jcfg = jam.ModelConfig.from_config(conf)
    rng = np.random.RandomState(0)
    cmvn = ((rng.randn(80) * 0.5).astype(np.float32),
            (rng.rand(80) + 0.5).astype(np.float32))
    params = jam.init_params(jax.random.PRNGKey(0), jcfg, cmvn=cmvn)
    for layer in params['encoder']['encoders']:
        n = layer['norm']
        if 'running_mean' in n:
            n['running_mean'] = jnp.asarray(
                rng.randn(D).astype(np.float32) * .1)
            n['running_var'] = jnp.asarray(rng.rand(D).astype(np.float32)
                                           + .5)
    return params


def _batch(seed, B=4, T=72, L=6):
    """B rows of unequal feature and target lengths."""
    rng = np.random.RandomState(seed)
    feats_lens = np.array([T, T - 11, T - 25, T - 4][:B], np.int32)
    tgt_lens = np.array([L, L - 3, 2, L - 1][:B], np.int32)
    target = rng.randint(1, 22, (B, L)).astype(np.int32)
    target[np.arange(L)[None, :] >= tgt_lens[:, None]] = -1
    cat = np.array([[1.0, 0.0], [0.0, 1.0], [0.6, 0.4], [1.0, 0.0]][:B],
                   np.float32)
    return {'feats': rng.randn(B, T, 80).astype(np.float32),
            'feats_lengths': feats_lens, 'target': target,
            'target_lengths': tgt_lens, 'cat_embs': cat}


def _jax_steps(conf, params, batches):
    """[(metrics, flat params)] after each of JAX's single-device steps."""
    jcfg = jam.ModelConfig.from_config(conf)
    tc = jtr.TrainConfig.from_config(conf)
    tx, _ = jtr.build_optimizer(tc, params)
    step = jax.jit(jtr.make_train_step(jcfg, tx, tc.accum_grad,
                                       grad_clip=tc.grad_clip))
    state, out = tx.init(params), []
    for i, b in enumerate(batches):
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                jnp.asarray(i), None)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: np.asarray(v)
                     for k, v in flatten_params(params).items()}))
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two process groups' results, the initial parameters (flat) and
    JAX's steps, computed once a pytest run: under pytest-xdist the
    first worker to get here computes them into the workers' shared
    temporary directory under a lock, and the others read them."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    work = root / 'torch_parallel_runs'
    with open(root / 'torch_parallel_runs.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (work / 'runs.pkl').exists():
            work.mkdir(exist_ok=True)
            out = _compute_runs(work)
            with open(work / 'runs.tmp', 'wb') as f:
                pickle.dump(out, f)
            os.replace(work / 'runs.tmp', work / 'runs.pkl')
    with open(work / 'runs.pkl', 'rb') as f:
        params, want = pickle.load(f)
    return work, params, want


def _compute_runs(work):
    """Spawn the process groups into `work`, take JAX's steps meanwhile,
    wait for the groups: ({key: initial flat parameters}, {key: JAX's
    steps})."""
    # the JAX package's single-device step ignores pipeline_stages (no
    # 'pipe' axis), as does the port's without one (expert2, tp2_ln)
    pipe = {'pipeline_stages': 2, 'pipeline_microbatches': 2}
    confs = {'base': _conf(), 'accum': _conf(accum=True),
             'novograd': _conf(novograd=True),
             'bitr': _conf(decoder='bitransformer'),
             'pipe_moe': _conf(num_blocks=4, positionwise_layer_type='moe',
                               n_expert=4, n_expert_per_token=2, **pipe),
             'pipe_ln': _conf(num_blocks=6, cnn_module_norm='layer_norm',
                              **pipe)}
    base = _params(confs['base'])     # accum and novograd start there too
    params = {k: base if k in ('base', 'accum', 'novograd')
              else _params(c) for k, c in confs.items()}
    batches = [_batch(i) for i in range(3)]
    for key, name in CONF_FILES.items():
        (work / f'{name}.json').write_text(json.dumps(confs[key]))
        if key not in ('accum', 'novograd'):
            np.savez(work / (name.replace('conf', 'init') + '.npz'),
                     **flatten_params(params[key]))
    np.savez(work / 'batches.npz', **{f'{i}/{k}': v for i, b in
                                      enumerate(batches)
                                      for k, v in b.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, 'tests', 'torch_parallel_worker.py')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), str(world), str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for world in (2, 4) for rank in range(world)]
    want = {k: _jax_steps(c, params[k], batches if k == 'base'
                          else batches[:2]) for k, c in confs.items()}
    logs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return {k: {n: np.asarray(a) for n, a in flatten_params(v).items()}
            for k, v in params.items()}, want


def _result(work, form):
    got = json.loads((work / f'{form}.json').read_text())
    with np.load(work / f'{form}.npz') as z:
        flat = {k: z[k] for k in z.files}
    return got, flat


def _assert_matches(got_metrics, flat, want):
    for g, (w, _) in zip(got_metrics, want):
        assert g['skipped'] == 0.0 and w['skipped'] == 0.0
        for k in ('loss', 'loss_att', 'loss_ctc', 'grad_norm'):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(g['th_accuracy'], w['th_accuracy'],
                                   rtol=0, atol=1e-6)
    want_flat = want[len(got_metrics) - 1][1]
    assert set(flat) == set(want_flat)
    dmax = max(float(np.abs(v - np.asarray(want_flat[k])).max())
               for k, v in flat.items())
    assert dmax <= 1e-4, dmax


@pytest.mark.parametrize('form', FORMS)
def test_sharded_step_matches_jax_single_device(runs, form):
    work, params, want = runs
    got, flat = _result(work, form)
    _assert_matches(got['metrics'], flat, want[WANT.get(form, 'base')][:2])
    # the clip engaged, and the parameters moved
    assert got['metrics'][0]['grad_norm'] > CLIP
    start = params[WANT.get(form, 'base')]
    assert max(float(np.abs(v - np.asarray(start[k])).max())
               for k, v in flat.items()) > 1e-3
    # the layout really split what the form splits
    split = got['split']
    assert (split['tp'] > 0) == ('tp2' in form)
    assert (split['zero3'] > 0) == (form == 'zero3')
    assert (split['zero'] > 0) == form.startswith(('zero', 'dp2tp2'))
    assert (split['expert'] > 0) == ('expert' in form)
    assert (split['pipe'] > 0) == ('pipe' in form)
    # an expert of a region layer kept by one stage and one 'expert' rank
    assert (split['stage_expert'] > 0) == ('pipe' in form and
                                           'expert' in form)
    # both steps ran split where the time axis is
    assert split['seq_steps'] == {'split': 2 if 'seq' in form else 0,
                                  'whole': 0}


@pytest.mark.parametrize('form', ['zero3', 'tp2', 'pipe2', 'expert2',
                                  'pipe2expert2'])
def test_split_checkpoint_reloads_on_one_rank(runs, form):
    """The gathered state saved under ZeRO-3, TP, 'pipe', 'expert' or
    both (an expert of a region layer on one of four ranks) loads into
    one rank's model and optimizer: the parameters are the run's, whole
    (every stage's layers, every expert), and the moments have the
    parameters' whole shapes."""
    work, params, want = runs
    _, flat = _result(work, form)
    key = WANT.get(form, 'base')
    conf = json.loads((work / f'{CONF_FILES[key]}.json').read_text())
    model = tam.build_model(tam.ModelConfig.from_config(conf), 'cpu',
                            convert.state_dict_from_jax(params[key]),
                            train=True)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), model)
    info = tckpt.load_checkpoint(work / f'ckpt_{form}' / 'step_2.npz',
                                 model, opt)
    assert info['step'] == 2 and opt.count == 2
    got = convert.flat_from_state_dict(model.state_dict())
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for i, mu, nu in zip(opt.train_idx, opt.mu, opt.nu):
        assert mu.shape == nu.shape == opt.params[i].shape
        assert float(nu.abs().sum()) > 0


def test_zero3_checkpoint_resumes_under_tensor_parallelism(runs):
    """The ZeRO-3 run's checkpoint, resumed on a TP-2 layout, takes JAX's
    third step."""
    work, _, want = runs
    got, flat = _result(work, 'resume')
    _assert_matches(got['metrics'], flat, want['base'][2:])


def test_dropout_masks_differ_across_data_ranks(runs):
    """Each data rank draws its own masks (parallel/mesh.py:
    dropout_generator).  The two ranks of one 'model' group draw one mask
    of a replicated activation, and of a split one (heads, FFN units)
    different masks: each rank's block of the unsplit mask
    (models/modules.py:keep_mask), so no unit's mask repeats another's."""
    checks = json.loads((runs[0] / 'checks.json').read_text())
    assert checks['same_mask'] == {'data': False, 'model': True,
                                   'model_split': False,
                                   'split_blocks_unsplit': True}


# a split form with dropout: (the step it equals, the form's step without
# dropout)
DROPOUT_REFS = {'tp2_dropout': ('unsplit_dropout', 'tp2'),
                'seq2_dropout': ('unsplit_dropout', 'tp2'),
                'pipe2seq2_dropout': ('pipe2_dropout', 'pipe2seq2')}


@pytest.mark.parametrize('form', list(DROPOUT_REFS))
def test_tp_dropout_matches_unsplit_step(runs, form):
    """TP 2's and 'seq' 2's two steps with dropout equal the unsplit
    port's two steps with the same generator seed: the split layers drop
    the heads, hidden units and time blocks the unsplit layers drop.
    'pipe' 2 × 'seq' 2's equal 'pipe' 2's (whose stages draw per layer
    and microbatch, parallel/pipeline.py:mb_generator): each stage's
    layers drop the time blocks of those masks.  The bounds are the
    sharded steps' (JAX draws other masks, so the reference is the
    port's own step)."""
    work = runs[0]
    ref, nodrop = DROPOUT_REFS[form]
    got, flat = _result(work, form)
    want = json.loads((work / f'{ref}.json').read_text())
    with np.load(work / f'{ref}.npz') as z:
        want_flat = {k: z[k] for k in z.files}
    _assert_matches(got['metrics'], flat,
                    [(m, want_flat) for m in want['metrics']])
    assert got['split']['tp'] > 0 or got['split']['seq_steps']['split'] == 2
    if 'pipe' in form:
        assert got['split']['pipe'] > 0 and want['split']['pipe'] > 0
    # dropout was on: the loss is not the dropout-free step's
    plain, _ = _result(work, nodrop)
    assert abs(got['metrics'][0]['loss'] - plain['metrics'][0]['loss']) \
        > 1e-3


def test_unequal_rows_raise(runs):
    checks = json.loads((runs[0] / 'checks.json').read_text())
    assert 'unequal batch rows [2, 1]' in checks['unequal']


@pytest.mark.parametrize('axis', ['seq', 'pipe', 'expert'])
def test_axes_match_jax_device_layout(runs, axis):
    """make_mesh(axis=2, model=2) over four ranks puts rank r where the
    JAX package's make_mesh puts device r: the same coordinate along
    every one of ('pipe', 'data', 'seq', 'expert', 'model')."""
    from reverb_tpu.parallel import mesh as jmesh
    got = json.loads((runs[0] / 'coords.json').read_text())[axis]
    devices = jax.devices()[:4]
    mesh = jmesh.make_mesh(**{axis: 2, 'model': 2}, devices=devices)
    for r, d in enumerate(devices):
        want = [int(i) for i in np.argwhere(mesh.devices == d)[0]]
        assert got[r] == want, (r, got[r], want)


@pytest.mark.parametrize('axis', ['seq', 'expert'])
def test_pipe_group_joins_one_coordinate(runs, axis):
    """Under make_mesh(pipe=2, axis=2) a rank's 'pipe' group, the ranks
    its GPipe stage sends to and receives from, holds one rank of each
    stage, in stage order, at the rank's own coordinate along `axis` (and
    every other axis): a stage passes its time block, or runs its
    experts, for the next stage's rank of the same block or experts."""
    got = json.loads((runs[0] / 'coords.json').read_text())[f'pipe_{axis}']
    coords, groups = got['coords'], got['pipe_group']
    pipe = AXES.index('pipe')
    for r, group in enumerate(groups):
        assert r in group and len(group) == 2
        assert [coords[g][pipe] for g in group] == [0, 1]
        for g in group:
            assert [c for i, c in enumerate(coords[g]) if i != pipe] == \
                [c for i, c in enumerate(coords[r]) if i != pipe]
    assert len({tuple(g) for g in groups}) == 2


def test_rules_match_jax():
    """The port's table is JAX's, plus the conv module's BatchNorm."""
    from reverb_tpu.parallel import mesh as jmesh
    from reverb_tpu_torch.parallel import mesh as tmesh
    port = [(p, s) for p, s in tmesh.TP_RULES if 'norm' not in p]
    assert [(p, tuple(s)) for p, s in jmesh.TP_RULES] == port


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.mark.parametrize('launch', ['coordinator', 'torchrun', 'pipe',
                                    'paraformer_tp'])
def test_bin_train_two_processes_match_one(tmp_path, launch):
    """Two processes of `bin.train`, each with half the batch (its
    partition of the list), give the losses, CV losses and checkpoints of
    one process with the whole batch: the counterpart of
    tests/test_multihost.py.  The processes join by `--coordinator
    file://... --num_processes 2 --process_id r`, or by torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).
    'pipe': two GPipe stages (`--num_devices_pipe 2
    --pipeline_microbatches 2`, a four-block encoder from the seed, both
    ranks reading the whole batch) against the one process's layers in
    order.  'paraformer_tp': the conformer Paraformer (`model:
    paraformer`, a registry family) over `--num_devices_model 2`, both
    ranks reading the whole batch.  The recipe of
    tests/test_torch_train_bin.py with the list, its shuffle and the sort
    kept in order, so that the two ranks' batches are the one process's
    batch (1.2 s utterances: one padded length)."""
    import yaml
    from reverb_tpu_torch.bin import train as ttrain
    from test_torch_train_bin import _train_argv, _write_recipe
    cfg_path = _write_recipe(tmp_path)
    whole = launch in ('pipe', 'paraformer_tp')    # both ranks all rows
    pipe = launch == 'pipe'

    def argv(model_dir, batch_size):
        out = _train_argv(tmp_path, cfg_path, model_dir, '--device', 'cpu',
                          '--override_config', 'dataset_conf.shuffle=false',
                          '--override_config', 'dataset_conf.sort=false',
                          '--override_config',
                          'dataset_conf.list_shuffle=false',
                          '--override_config',
                          f'dataset_conf.batch_conf.batch_size={batch_size}')
        if pipe:       # four blocks from the seed, not the one-block init
            i = out.index('--checkpoint')
            out[i:i + 2] = ['--override_config', 'encoder_conf.num_blocks=4']
        if launch == 'paraformer_tp':
            # from the seed, as a family, its encoder without LSL; the
            # last fire of the α scaled to sum to U sits on the threshold
            # within an ulp, which a TP rank's other rounding crosses:
            # fire at 0.999 (tests/test_torch_paraformer.py)
            i = out.index('--checkpoint')
            out[i:i + 2] = ['--override_config', 'model=paraformer',
                            '--override_config',
                            'dataset_conf.pass_cat_emb=false',
                            '--override_config', 'decoder=bitransformer',
                            '--override_config',
                            'paraformer_conf.cif_conf.threshold=0.999']
        return out
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS='1')
    port = _free_port()

    def launch_args(rank):
        if launch == 'pipe':
            return ['--coordinator', f'file://{tmp_path}/pg',
                    '--num_processes', '2', '--process_id', str(rank),
                    '--num_devices_pipe', '2', '--pipeline_microbatches',
                    '2'], env
        if launch == 'paraformer_tp':
            return ['--coordinator', f'file://{tmp_path}/pg',
                    '--num_processes', '2', '--process_id', str(rank),
                    '--num_devices_model', '2'], env
        if launch == 'coordinator':
            return ['--coordinator', f'file://{tmp_path}/pg',
                    '--num_processes', '2', '--process_id', str(rank)], env
        return [], dict(env, RANK=str(rank), LOCAL_RANK=str(rank),
                        WORLD_SIZE='2', MASTER_ADDR='127.0.0.1',
                        MASTER_PORT=str(port))
    procs = []
    for rank in range(2):
        extra, penv = launch_args(rank)
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'reverb_tpu_torch.bin.train',
             *argv(tmp_path / 'two', 4 if whole else 2), *extra], env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    ex = ttrain.main(argv(tmp_path / 'one', 4))
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert ex.step == 2

    def records(d):
        return [json.loads(line) for line in
                (d / 'metrics.jsonl').read_text().splitlines()]
    want, got = records(tmp_path / 'one'), records(tmp_path / 'two')
    assert [r['step'] for r in got] == [r['step'] for r in want] == [1, 2]
    for g, w in zip(got, want):
        keys = [k for k in w if k.startswith('train/') and k != 'train/lr']
        assert set(keys) >= {'train/loss', 'train/grad_norm'}
        assert set(keys) <= set(g)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    for tag in ('epoch_0', 'epoch_1'):
        info = [yaml.safe_load((tmp_path / d / f'{tag}.yaml').read_text())
                for d in ('one', 'two')]
        np.testing.assert_allclose(info[1]['cv_loss'], info[0]['cv_loss'],
                                   rtol=1e-4)
        with np.load(tmp_path / 'one' / f'{tag}.npz') as a, \
                np.load(tmp_path / 'two' / f'{tag}.npz') as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-4,
                                           err_msg=k)


@pytest.mark.parametrize('extra,error,match', [
    (['--num_devices_expert', '2'], ValueError, 'several processes'),
    (['--num_devices_model', '2'], ValueError, 'several processes'),
    (['--zero3'], ValueError, 'several processes')])
def test_bin_train_refuses_what_one_process_cannot_split(tmp_path, extra,
                                                         error, match):
    from reverb_tpu_torch.bin import train as ttrain
    from test_torch_train_bin import _train_argv, _write_recipe
    cfg_path = _write_recipe(tmp_path)
    with pytest.raises(error, match=match):
        ttrain.main(_train_argv(tmp_path, cfg_path, tmp_path / 'x',
                                '--device', 'cpu', *extra))
