"""Every model family of the registry and teacher-student distillation
under the 'model', 'seq', 'expert' and 'pipe' axes, and with accum_grad 2
over data-parallel ranks (reverb_tpu_torch/parallel/sharding.py's split
forms, parallel/global_batch.py), f32 on the CPU over gloo.

The forms, each on a world-2 mesh:
- 'model' 2 for the fourteen forms of tests/test_torch_families_parallel.py
  (nine families, the four alternative encoders, a ts_conf) and for an
  asr_model with the deep-biasing context adaptor (an attention block that
  no rule splits, which must keep its heads);
- 'seq' 2 for a transducer, the Branchformer, the E-Branchformer (their
  time axis split) and the CTL model (its full view split, its chunk view
  whole), and Whisper (whole on every rank);
- 'pipe' 2 for a k2_model (its conformer's GPipe region, one layer a
  stage) and a Squeezeformer (no region: whole on both ranks);
- 'expert' 2 for a transducer over an MoE conformer (4 experts, 2 a
  token);
- DDP 2 × accum_grad 2 for the SANM Paraformer (its glancing sampler)
  and wav2vec 2.0 (its code perplexity, a nonlinear function of the
  global micro-batch's marginal).

One world-2 group is spawned once for the module
(tests/torch_families_axes_worker.py, rendezvous through a file, one
thread a rank); each rank runs every form for two steps on its rows of
each global batch of four.  Each form is held to the port's own
one-process step on the whole batch (accum_grad as the form's): loss,
grad norm and every metric within rtol 1e-4, every updated parameter
within 1e-4.  tp2_whisper, tp2_paraformer and seq2_branchformer are also
held to the JAX package's single-device step from JAX's initial
parameters (the Paraformer's glancing uniforms are those JAX's loss
draws without an rng).  No dropout; the CTL forms' steps take generators
(their dynamic chunk, one draw a global batch).  Widths 128, two layers.
"""

import fcntl
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import presets as jpresets
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu.train import trainer as jtr
from test_torch_families_parallel import OPT, B, U, _batch, _forms
from torch_families_axes_worker import one_process

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

FAMILIES = ['k2_model', 'transducer', 'bitransducer', 'paraformer',
            'ctl_model', 'bestrq', 'wav2vec2', 'w2vbert', 'whisper',
            'branchformer', 'e_branchformer', 'squeezeformer',
            'efficient_conformer', 'ts_conf']
SEQ = ['transducer', 'branchformer', 'e_branchformer', 'ctl_model',
       'whisper']
# the encoders that split their time axis (the others run whole)
SEQ_SPLIT = ('transducer', 'branchformer', 'e_branchformer', 'ctl_model')
JAX_FORMS = ('tp2_whisper', 'tp2_paraformer', 'seq2_branchformer')
ZERO12 = {'zero': True}


def _deep_bias_conf():
    conf = jpresets.reverb_config(output_size=128, attention_heads=2,
                                  linear_units=64, num_blocks=2, dec_blocks=1,
                                  r_blocks=1, vocab_size=24, dropout=0.0)
    conf['dataset_conf']['deep_bias_conf'] = {'deep_biasing': True}
    conf['encoder_conf']['use_dynamic_chunk'] = False
    return conf


def _specs(work):
    """{form: spec} (the worker's forms.json) and {form: base family}."""
    fams = _forms(work)
    specs, bases = {}, {}

    def add(name, base, conf, axes, accum=1, init='seed'):
        specs[name] = {'conf': conf, 'axes': axes, 'opts': ZERO12,
                       'accum': accum, 'init': init,
                       'seed': 7 if base == 'ctl_model' else None}
        bases[name] = base
    for f in FAMILIES:
        add(f'tp2_{f}', f, fams[f][0], {'model': 2},
            init='npz' if f'tp2_{f}' in JAX_FORMS else 'seed')
    add('tp2_deep_bias', 'deep_bias', {**_deep_bias_conf(), **OPT},
        {'model': 2})
    for f in SEQ:
        add(f'seq2_{f}', f, fams[f][0], {'seq': 2},
            init='npz' if f'seq2_{f}' in JAX_FORMS else 'seed')
    k2 = json.loads(json.dumps(fams['k2_model'][0]))
    k2['encoder_conf'].update(pipeline_stages=2, pipeline_microbatches=2)
    add('pipe2_k2_model', 'k2_model', k2, {'pipe': 2})
    add('pipe2_squeezeformer', 'squeezeformer', fams['squeezeformer'][0],
        {'pipe': 2})
    moe = json.loads(json.dumps(fams['transducer'][0]))
    moe['encoder_conf'] = dict(moe['encoder_conf'],
                               positionwise_layer_type='moe', n_expert=4,
                               n_expert_per_token=2)
    add('expert2_transducer', 'transducer', moe, {'expert': 2})
    for f in ('paraformer', 'wav2vec2'):
        add(f'ddp2_accum2_{f}', f, fams[f][0], {'data': 2}, accum=2)
    return specs, bases


def _deep_bias_batch(seed):
    """A deep-biasing batch: four rows, language one-hots and four
    context phrases."""
    b = _batch('k2_model', {'output_dim': 24}, seed)
    b['cat_embs'] = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    b['cv_list'] = np.array([[3, 4, 0], [5, 6, 7], [9, 0, 0], [11, 12, 0]],
                            np.int64)
    b['cv_list_lengths'] = np.array([2, 3, 1, 2], np.int32)
    return b


def _batches(form, base, conf):
    if base == 'deep_bias':
        return [_deep_bias_batch(10 * i + 1) for i in range(2)]
    out = [_batch(base, conf, 10 * i + 1) for i in range(2)]
    if form == 'tp2_paraformer':
        # the uniforms JAX's glancing sampler draws without an rng
        u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (B, U)))
        for b in out:
            b['glance_u'] = u
    return out


def _jax_steps(conf, params, batches):
    """JAX's single-device steps without an rng: [(metrics, flat
    parameters)]."""
    jb = jinit(conf, jax.random.PRNGKey(0))
    tc = jtr.TrainConfig.from_config(conf)
    tx, _ = jtr.build_optimizer(tc, params)
    step = jax.jit(jtr.make_train_step(None, tx, 1, loss_fn=jb.loss_fn,
                                       grad_clip=tc.grad_clip))
    state, out = tx.init(params), []
    for i, b in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        params, state, m = step(params, state, jbatch, jnp.asarray(i), None)
        out.append(({k: float(v) for k, v in m.items()
                     if not k.startswith('_')},
                    {k: np.asarray(v)
                     for k, v in flatten_params(params).items()}))
    return out


def _compute(work):
    """Write the forms, spawn the group, take the one-process and JAX
    steps meanwhile: ({form: one-process (metrics, flat)}, {form: JAX's
    steps})."""
    specs, bases = _specs(work)
    jparams = {}
    for form, spec in specs.items():
        batches = _batches(form, bases[form], spec['conf'])
        if form in JAX_FORMS:
            jparams[form] = jinit(spec['conf'], jax.random.PRNGKey(0)).params
            np.savez(work / f'{form}.init.npz',
                     **flatten_params(jparams[form]))
        np.savez(work / f'{form}.batches.npz',
                 **{f'{i}/{k}': v for i, b in enumerate(batches)
                    for k, v in b.items()})
    (work / 'forms.json').write_text(json.dumps(specs))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, 'tests', 'torch_families_axes_worker.py')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    # forms of one family, batches and init share their one-process steps
    cache, want = {}, {}
    for form, spec in specs.items():
        key = json.dumps([bases[form], spec['conf'], spec['accum'],
                          spec['seed'], form if spec['init'] == 'npz'
                          else None], sort_keys=True)
        if key not in cache:
            cache[key] = one_process(str(work), form, spec)
        want[form] = cache[key]
    from torch_families_parallel_worker import load_batches
    jax_want = {form: _jax_steps(specs[form]['conf'], jparams[form],
                                 load_batches(str(work), form))
                for form in JAX_FORMS}
    logs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return want, jax_want


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The group's results and the references, computed once for the
    pytest run (under pytest-xdist by the first worker to get here, under a
    lock, into the workers' shared temporary directory)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    work = root / 'torch_families_axes_runs'
    with open(root / 'torch_families_axes_runs.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (work / 'runs.pkl').exists():
            work.mkdir(exist_ok=True)
            out = _compute(work)
            with open(work / 'runs.tmp', 'wb') as f:
                pickle.dump(out, f)
            os.replace(work / 'runs.tmp', work / 'runs.pkl')
    with open(work / 'runs.pkl', 'rb') as f:
        want, jax_want = pickle.load(f)
    return work, want, jax_want


def _result(work, form):
    got = json.loads((work / f'{form}.json').read_text())
    with np.load(work / f'{form}.npz') as z:
        return got, {k: z[k] for k in z.files}


def _close(got_metrics, got_flat, want_metrics, want_flat, keys):
    for g, w in zip(got_metrics, want_metrics):
        assert g['skipped'] == 0.0 and w['skipped'] == 0.0
        for k in keys(w):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert set(got_flat) == set(want_flat)
    dmax = max(float(np.abs(v - np.asarray(want_flat[k])).max())
               for k, v in got_flat.items())
    assert dmax <= 1e-4, dmax


def _check(runs, form):
    work, want, _ = runs
    got, flat = _result(work, form)
    want_metrics, want_flat = want[form]
    assert set(got['metrics'][0]) == set(want_metrics[0])
    _close(got['metrics'], flat, want_metrics, want_flat, lambda w: w)
    return got


@pytest.mark.parametrize('form', FAMILIES + ['deep_bias'])
def test_family_tp2_step_matches_one_process(runs, form):
    """'model' 2: every block that the rules split in part runs split
    whole (heads, fused thirds, the fsmn memory, the gathered hidden
    LayerNorm) and the rest whole; two steps equal the one-process steps.
    An attention no rule splits (the context adaptor's) keeps its heads."""
    got = _check(runs, f'tp2_{form}')
    assert got['tp_split'] > 0
    unsplit, split = got['heads']
    if form == 'deep_bias':
        # one head, which two ranks cannot share: whole on both
        assert split['context_adaptor.attention'] == \
            unsplit['context_adaptor.attention'] == 1
    assert any(split[n] * 2 == h for n, h in unsplit.items())


@pytest.mark.parametrize('form', SEQ)
def test_family_seq2_step_matches_one_process(runs, form):
    """'seq' 2: the conformer and Branchformer encoders split their time
    axis (the CTL chunk view whole), Whisper runs whole on both ranks;
    the loss, computed whole on each rank and scaled by 1/2, sums to the
    one-process step's."""
    got = _check(runs, f'seq2_{form}')
    steps = got['seq_steps']
    if form in SEQ_SPLIT:
        assert steps['split'] == 2, steps
    else:
        assert steps == {'split': 0, 'whole': 2}, steps
    if form == 'ctl_model':
        assert steps['whole'] == 2, steps        # the chunk views


@pytest.mark.parametrize('form', ['pipe2_k2_model', 'pipe2_squeezeformer',
                                  'expert2_transducer'])
def test_family_pipe_and_expert_steps_match_one_process(runs, form):
    """'pipe' 2: the k2_model's conformer runs its GPipe region, the
    Squeezeformer (no region) whole on both stages; 'expert' 2: each rank
    keeps two of the MoE conformer's four experts."""
    got = _check(runs, form)
    assert got['pipe_region'] == (form == 'pipe2_k2_model')
    assert (got['experts_split'] > 0) == (form == 'expert2_transducer')


@pytest.mark.parametrize('form', ['paraformer', 'wav2vec2'])
def test_family_ddp_accum2_matches_one_process(runs, form):
    """DDP 2 × accum_grad 2: each rank's micro-batch j is its row of the
    global micro-batch j, so each micro-batch's denominators, statistics
    (wav2vec 2.0's perplexity) and draws are the one process's."""
    _check(runs, f'ddp2_accum2_{form}')


@pytest.mark.parametrize('form', JAX_FORMS)
def test_family_axes_match_jax_single_device(runs, form):
    """Whisper and the SANM Paraformer under 'model' 2 and the
    Branchformer under 'seq' 2 against the JAX package's single-device
    steps from its initial parameters."""
    work, _, jax_want = runs
    got, flat = _result(work, form)
    _close(got['metrics'], flat, [m for m, _ in jax_want[form]],
           jax_want[form][-1][1],
           lambda w: [k for k in ('loss', 'grad_norm') if k in w])


def test_sharding_refuses_a_split_without_a_form(runs):
    """A parameter that the 'model' rules split must lie in a layer with a
    split form: a `feed_forward` that is no feed-forward raises, naming
    the module, on every rank."""
    work = runs[0]
    for r in range(2):
        msg = (work / f'refused_rank{r}.txt').read_text()
        assert 'feed_forward.w_1' in msg and 'no split form' in msg, msg


def test_replicated_gradients_average_over_expert(runs):
    """Each 'expert' rank computes a replicated parameter's gradient whole
    (on the card with its own roundings: CTC's backward adds with
    atomics); `reduce_grads` averages them over the group, so the copies
    stay one: ranks that computed 1 and 2 both take 1.5."""
    work = runs[0]
    for r in range(2):
        got = json.loads((work / f'expert_average_rank{r}.json').read_text())
        assert got == [1.5, 1.5], got
