"""Every model family of the registry and teacher-student distillation
under data parallelism (reverb_tpu_torch/parallel/global_batch.py), f32
on the CPU over gloo.

Fourteen forms: the nine families besides the asr_model (k2_model with
its LF-MMI loss, transducer, bitransducer, the SANM Paraformer, ctl_model,
BEST-RQ, wav2vec 2.0, w2v-BERT, Whisper), the four alternative encoders
and a ts_conf.  One world-2 group is spawned once for the module
(tests/torch_families_parallel_worker.py, rendezvous through a file, one
thread a rank) and runs each form for two steps on its rows of each
global batch of four, as DDP (ZeRO-1/2 on two forms, ZeRO-3 with a
small minimum size on two).  Each form is held to the port's own
one-process step on the whole batch (which the family tests hold to the
JAX package), and BEST-RQ and wav2vec 2.0 also to the JAX package's
single-device step: loss, grad norm and every metric within rtol 1e-4,
every updated parameter within 1e-4.  The draws that a loss makes per
row (SSL masks, negatives, gumbels, noise; the Paraformer's glancing
uniforms) come with the batch, so that each rank takes its rows' draws;
no dropout.  The CTL form's steps take generators (each data rank its
own, `dropout_generator`; the one process one of the same seed): its
chunk view's dynamic chunk is a draw JAX makes once for the global
batch, and every rank must take data rank 0's.  The widths are the family tests' (128 where a LayerNorm
takes the K5/K6 functions).
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
from reverb_tpu.models import ssl as jssl
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu.train import trainer as jtr
from test_torch_ctl_k2 import _asr_conf, _lfmmi_dir
from torch_families import ENC, alt_conf, transducer_conf
from torch_families_parallel_worker import STEPS, one_process

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

B, T, U = 4, 60, 4
OPT = {'optim_conf': {'lr': 1e-2, 'eps': 1e-3},
       'scheduler_conf': {'warmup_steps': 6}, 'grad_clip': 5.0}
SSL_ENC = dict(ENC, output_size=128, attention_heads=2, linear_units=64)
W2V = {'codebook_size': 16, 'num_codebooks': 2, 'num_negatives': 5,
       'diversity_weight': 0.1,
       'features_regularization_weight': 0.1}
WHISPER = {'n_mels': 16, 'n_audio_state': 128, 'n_audio_head': 2,
           'n_audio_layer': 2, 'n_vocab': 50, 'n_audio_ctx': 40,
           'n_text_ctx': 24, 'n_text_state': 128, 'n_text_head': 2,
           'n_text_layer': 2}
DDP = {'zero': False}
ZERO12 = {'zero': True}
ZERO3 = {'zero3': True, 'zero3_min_size': 1024}
# the forms held to the JAX package's step too
JAX_FORMS = ('bestrq', 'wav2vec2')


def _ssl_conf(kind, **extra):
    return {'input_dim': 80, 'output_dim': 50, 'model': kind,
            'encoder': 'conformer', 'encoder_conf': SSL_ENC,
            'decoder': 'transformer',
            'decoder_conf': {'attention_heads': 2, 'linear_units': 48,
                             'num_blocks': 1, 'dropout_rate': 0.0,
                             'positional_dropout_rate': 0.0}, **extra}


def _forms(work):
    """{form: (config, Sharding options)}."""
    sanm = {'model': 'paraformer', 'encoder': 'sanm_encoder',
            'input_dim': 80, 'output_dim': 50,
            'encoder_conf': {'output_size': 128, 'attention_heads': 2,
                             'linear_units': 48, 'num_blocks': 2,
                             'dropout_rate': 0.0},
            'decoder_conf': {'num_blocks': 2},
            'lfr_conf': {'lfr_m': 3, 'lfr_n': 2},
            # the last fire of a step's α, scaled to sum to U, sits on
            # the threshold within an ulp: fire at 0.999
            # (tests/test_torch_paraformer.py)
            'cif_conf': {'cnn_groups': 1, 'residual': False,
                         'threshold': 0.999},
            'model_conf': {'ctc_weight': 0.3}}
    k2 = _asr_conf('k2_model', lfmmi_dir=_lfmmi_dir(work, False))
    k2['encoder_conf'] = dict(k2['encoder_conf'], use_dynamic_chunk=False)
    k2['output_dim'] = 10
    ts = _asr_conf('asr_model')
    ts['encoder_conf'] = dict(ts['encoder_conf'], use_dynamic_chunk=False)
    ts['ts_conf'] = {'ts_weight': 0.5, 'top_k_entries': 3}
    forms = {
        'k2_model': (k2, DDP),
        'transducer': (transducer_conf(width=128), ZERO3),
        'bitransducer': (transducer_conf('bitransducer', 'conv', 128), DDP),
        'paraformer': (sanm, ZERO12),
        'ctl_model': (_asr_conf('ctl_model', n_negatives=0,
                                ctl_weight=0.5), DDP),
        'bestrq': (_ssl_conf('bestrq', bestrq_conf={
            'codebook_size': 32, 'mask_prob': 0.15, 'mask_length': 6,
            'features_regularization_weight': 0.1}), DDP),
        'wav2vec2': (_ssl_conf('wav2vec2', wav2vec2_conf=W2V), ZERO3),
        'w2vbert': (_ssl_conf('w2vbert', wav2vec2_conf=W2V,
                              w2vbert_conf={'warmup_steps': 10}), DDP),
        'whisper': ({'model': 'whisper', 'whisper_conf': WHISPER}, ZERO12),
        'ts_conf': (ts, DDP)}
    for enc in ('branchformer', 'e_branchformer', 'squeezeformer',
                'efficient_conformer'):
        forms[enc] = (alt_conf(enc, width=128), DDP)
    return {k: ({**c, **OPT}, o) for k, (c, o) in forms.items()}


def _sub_len(n):
    return ((n - 1) // 2 - 1) // 2


def _batch(form, conf, seed):
    """A global batch of B rows of unequal lengths, with the per-row
    draws the form's loss takes."""
    rng = np.random.RandomState(seed)
    V = conf.get('output_dim', WHISPER['n_vocab'])
    lens = np.array([T, T - 9, T - 20, T - 4], np.int32)
    tgt_lens = np.array([U, U - 1, 2, U], np.int32)
    target = rng.randint(1, min(V, 10) - 1, (B, U)).astype(np.int32)
    target[np.arange(U)[None, :] >= tgt_lens[:, None]] = -1
    F = WHISPER['n_mels'] if form == 'whisper' else 80
    b = {'feats': rng.randn(B, T, F).astype(np.float32),
         'feats_lengths': lens, 'target': target,
         'target_lengths': tgt_lens}
    if form == 'whisper':
        b['feats'] = b['feats'][:, :30]
        del b['feats_lengths']
    Tz = _sub_len(T)
    valid = np.arange(Tz)[None, :] < _sub_len(lens)[:, None]
    if form in ('wav2vec2', 'w2vbert'):
        span = (rng.rand(B, Tz) < 0.4) & valid
        span[:, 1] = True
        b['span_mask'] = span
        b['neg_pos'] = rng.randint(0, Tz, (B, Tz, W2V['num_negatives']))
        b['gumbels'] = rng.gumbel(size=(B, Tz, 2, W2V['codebook_size'])
                                  ).astype(np.float32)
        if form == 'w2vbert':
            b['mask_noise'] = (rng.randn(B, Tz, 128) * 0.1).astype(
                np.float32)
    if form == 'paraformer':
        b['glance_u'] = rng.rand(B, U).astype(np.float32)
    return b


def _bestrq_draws(conf, b, key):
    """JAX's BEST-RQ draws from the key its loss gets (the loss's own
    split, rebuilt: it takes no injection)."""
    from reverb_tpu.models.ssl import BestRQConfig
    bconf = conf['bestrq_conf']
    k1, k2 = jax.random.split(key)
    bcfg = BestRQConfig(mask_prob=bconf['mask_prob'],
                        mask_length=bconf['mask_length'])
    mask = np.asarray(jssl.make_mask(k1, B, T, bcfg))
    noise = np.asarray(jax.random.normal(k2, (1, 1, 80)) * 0.1)
    return {'mask': mask, 'noise': noise}


def _step_key(i):
    """The key a JAX loss gets in step i of make_train_step(rng=
    PRNGKey(i)) (the step splits its rng first)."""
    return jax.random.split(jax.random.PRNGKey(i))[1]


def _jax_steps(form, conf, params, batches):
    """JAX's single-device steps: [(metrics, flat parameters)]."""
    from reverb_tpu.models.asr_model import _get_cmvn
    jb = jinit(conf, jax.random.PRNGKey(0))
    loss_fn = jb.loss_fn
    if form == 'wav2vec2':
        acfg, wcfg = jb.cfg

        def loss_fn(p, batch, rng):          # noqa: F811 (JAX's draws)
            return jssl.wav2vec2_loss(
                p, p['encoder'], batch['feats'], batch['feats_lengths'], rng,
                wcfg, acfg.encoder, cmvn=_get_cmvn(p),
                span_mask=batch['span_mask'], neg_pos=batch['neg_pos'],
                gumbels=batch['gumbels'])
    tc = jtr.TrainConfig.from_config(conf)
    tx, _ = jtr.build_optimizer(tc, params)
    step = jax.jit(jtr.make_train_step(jb.cfg[0], tx, 1, loss_fn=loss_fn,
                                       grad_clip=tc.grad_clip))
    state, out = tx.init(params), []
    for i, b in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in b.items()
                  if k not in ('mask', 'noise')}
        params, state, m = step(params, state, jbatch, jnp.asarray(i),
                                jax.random.PRNGKey(i))
        out.append(({k: float(v) for k, v in m.items()
                     if not k.startswith('_')},
                    {k: np.asarray(v)
                     for k, v in flatten_params(params).items()}))
    return out


def _compute(work):
    """Write the forms, spawn the group, take the one-process and JAX
    steps meanwhile: ({form: one-process (metrics, flat)}, {form: JAX's
    steps}, {form: initial flat parameters})."""
    forms = _forms(work)
    specs, jparams = {}, {}
    for form, (conf, opts) in forms.items():
        specs[form] = {'conf': conf, 'opts': opts,
                       'init': 'npz' if form in JAX_FORMS else 'seed',
                       'seed': 7 if form == 'ctl_model' else None}
        batches = [_batch(form, conf, 10 * i + 1) for i in range(STEPS)]
        if form in JAX_FORMS:
            jparams[form] = jinit(conf, jax.random.PRNGKey(0)).params
            np.savez(work / f'{form}.init.npz',
                     **flatten_params(jparams[form]))
        if form == 'bestrq':
            for i, b in enumerate(batches):
                b.update(_bestrq_draws(conf, b, _step_key(i)))
        np.savez(work / f'{form}.batches.npz',
                 **{f'{i}/{k}': v for i, b in enumerate(batches)
                    for k, v in b.items()})
    (work / 'forms.json').write_text(json.dumps(specs))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, 'tests', 'torch_families_parallel_worker.py')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    want = {form: one_process(str(work), form, spec)
            for form, spec in specs.items()}
    from torch_families_parallel_worker import load_batches
    jax_want = {form: _jax_steps(form, specs[form]['conf'], jparams[form],
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
    work = root / 'torch_families_parallel_runs'
    with open(root / 'torch_families_parallel_runs.lock', 'w') as lock:
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


FORMS = ['k2_model', 'transducer', 'bitransducer', 'paraformer',
         'ctl_model', 'bestrq', 'wav2vec2', 'w2vbert', 'whisper',
         'branchformer', 'e_branchformer', 'squeezeformer',
         'efficient_conformer', 'ts_conf']


@pytest.mark.parametrize('form', FORMS)
def test_family_ddp_step_matches_one_process(runs, form):
    """Two data-parallel steps of the form equal the one-process steps on
    the whole batch: every metric (each rank's share of the global batch's
    loss and statistics, summed), the grad norm and every parameter."""
    work, want, _ = runs
    got, flat = _result(work, form)
    want_metrics, want_flat = want[form]
    assert set(got['metrics'][0]) == set(want_metrics[0])
    _close(got['metrics'], flat, want_metrics, want_flat, lambda w: w)
    # the parameters moved, and the layout split what the form splits
    zero = json.loads((work / 'forms.json').read_text())[form]['opts']
    assert (got['split']['zero3'] > 0) == zero.get('zero3', False)
    assert (got['split']['zero'] > 0) == (zero.get('zero', True) or
                                          zero.get('zero3', False))


@pytest.mark.parametrize('form', JAX_FORMS)
def test_ssl_ddp_step_matches_jax_single_device(runs, form):
    """BEST-RQ (its masked-code count and mean(feats²) over the global
    batch) and wav2vec 2.0 (its code perplexity, a nonlinear function of
    the global marginal) under DDP or ZeRO-3 against the JAX package's
    single-device steps with the same draws."""
    work, _, jax_want = runs
    got, flat = _result(work, form)
    _close(got['metrics'], flat, [m for m, _ in jax_want[form]],
           jax_want[form][-1][1],
           lambda w: [k for k in ('loss', 'grad_norm') if k in w])
