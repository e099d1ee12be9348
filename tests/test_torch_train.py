"""The training slice of the PyTorch port against the JAX package, f32 on
CPU: the hybrid CTC/attention loss and every parameter gradient (the
batch-norm statistics and the CMVN stats included), three optimizer steps
(Adam with warmuplr, clipping, freeze rules), the non-finite skip, the
schedules, the freeze rules, checkpoints in both directions, and dropout's
seeding.

Same weights on both sides: the JAX parameter tree is initialized, then
carried into the port with convert.state_dict_from_jax.  The model is a
tiny LSL conformer + LSL bitransformer at width 128 with 64-wide heads, so
every LayerNorm takes the K5/K6 route (plain versions on the CPU) and the
rel-pos attention the K1/K4 route.  No dropout where the two frameworks
are compared (rng=None / no generator): their random streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.convert.torch_ckpt import nest_state_dict as jam_nest
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import presets as jpresets
from reverb_tpu.train import checkpoint as jckpt
from reverb_tpu.train import scheduler as jsched
from reverb_tpu.train import trainer as jtr
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.models import modules
from reverb_tpu_torch.ops import flash_attention as fa
from reverb_tpu_torch.ops import layer_norm as ln
from reverb_tpu_torch.train import checkpoint as tckpt
from reverb_tpu_torch.train import scheduler as tsched
from reverb_tpu_torch.train import trainer as ttr

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

D = 128


def _conf():
    conf = jpresets.reverb_config(output_size=D, attention_heads=2,
                                  linear_units=96, num_blocks=3, dec_blocks=2,
                                  r_blocks=2, vocab_size=23)
    conf['decoder'] = 'lsl_bitransformer'
    conf['scheduler_conf'] = {'warmup_steps': 6}
    return conf


def _jax_params(conf, seed=0):
    jcfg = jam.ModelConfig.from_config(conf)
    rng = np.random.RandomState(seed)
    cmvn = ((rng.randn(80) * 0.5).astype(np.float32),
            (rng.rand(80) + 0.5).astype(np.float32))
    params = jam.init_params(jax.random.PRNGKey(seed), jcfg, cmvn=cmvn)
    # non-trivial batch-norm statistics and affines
    for layer in params['encoder']['encoders']:
        n = layer['norm']
        n['running_mean'] = jnp.asarray(rng.randn(D).astype(np.float32) * .1)
        n['running_var'] = jnp.asarray(rng.rand(D).astype(np.float32) + .5)
        n['weight'] = jnp.asarray(rng.rand(D).astype(np.float32) + .5)
    return jcfg, params


def _port_model(conf, params):
    tcfg = tam.ModelConfig.from_config(conf)
    sd = convert.state_dict_from_jax(flatten_params(params))
    return tam.build_model(tcfg, 'cpu', sd, train=True)


def _batch(seed=0, B=3, T=75, L=6):
    rng = np.random.RandomState(seed)
    feats_lens = np.array([T, T - 14, T - 30][:B], np.int32)
    tgt_lens = np.array([L, L - 2, 3][:B], np.int32)
    target = rng.randint(1, 21, (B, L)).astype(np.int32)
    target[np.arange(L)[None, :] >= tgt_lens[:, None]] = -1
    cat = np.array([[1.0, 0.0], [0.0, 1.0], [0.6, 0.4]][:B], np.float32)
    return {'feats': rng.randn(B, T, 80).astype(np.float32),
            'feats_lengths': feats_lens, 'target': target,
            'target_lengths': tgt_lens, 'cat_embs': cat}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _port_flat(model):
    return convert.flat_from_state_dict(model.state_dict())


@pytest.fixture(scope='module')
def setup():
    conf = _conf()
    jcfg, params = _jax_params(conf)
    return conf, jcfg, params


def test_loss_and_gradients_match_jax(setup):
    """compute_loss (CTC + label-smoothed attention loss of both decoder
    directions) and the gradient of every parameter, the batch-norm running
    statistics and the CMVN stats included, against JAX compute_loss +
    jax.grad: loss within 1e-5 relative, gradients within 1e-4."""
    conf, jcfg, params = setup
    batch = _batch()

    def loss_fn(p):
        out = jam.compute_loss(p, jcfg, _jb(batch))
        return out['loss'], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    jgrads = flatten_params(jgrads)

    model = _port_model(conf, params)
    launches = (fa.LAUNCHES, fa.BWD_LAUNCHES, ln.LAUNCHES, ln.BWD_LAUNCHES)
    out = tam.compute_loss(model, _tb(batch))
    out['loss'].backward()
    assert launches == (fa.LAUNCHES, fa.BWD_LAUNCHES, ln.LAUNCHES,
                        ln.BWD_LAUNCHES)
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   rtol=1e-5, err_msg=k)
    names = dict(model.named_parameters())
    assert {convert.tree_key(n) for n in names} == set(jgrads)
    for name, p in names.items():
        want = jgrads[convert.tree_key(name)]
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    bn = names['encoder.encoders.1.conv_module.norm.running_var'].grad
    assert float(bn.abs().max()) > 0
    assert float(names['encoder.global_cmvn.mean'].grad.abs().max()) > 0


def test_three_train_steps_match_jax(setup):
    """Three make_train_step updates (adam, warmuplr over 6 steps, clip 5.0
    so the clip engages) against JAX's, no dropout: loss within 1e-5 and
    grad_norm within 1e-4 relative, every parameter within 1e-5 after each
    step.  Adam's eps is 1e-3 here: Adam divides each gradient element by
    its own magnitude, and some gradients are rounding noise on both sides
    (a rel-pos key bias shifts every score of a query alike, so softmax
    gives it an exactly zero gradient), which with eps 1e-8 would step by
    ±lr at random.  The update arithmetic at the default eps is held to
    optax on identical gradients below."""
    conf, jcfg, params = setup
    conf = dict(conf, optim_conf={'lr': 1e-3, 'eps': 1e-3})
    clip = 5.0
    tx, _ = jtr.build_optimizer(jtr.TrainConfig.from_config(conf), params)
    jstep = jax.jit(jtr.make_train_step(jcfg, tx, grad_clip=clip))
    opt_state = tx.init(params)

    model = _port_model(conf, params)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), model)
    step = ttr.make_train_step(model.cfg, opt, grad_clip=clip)
    jp = params
    for i in range(3):
        batch = _batch(seed=i)
        jp, opt_state, jm = jstep(jp, opt_state, _jb(batch), jnp.asarray(i),
                                  None)
        m = step(model, _tb(batch))
        assert m['skipped'] == 0.0 and float(jm['skipped']) == 0.0
        np.testing.assert_allclose(m['grad_norm'], float(jm['grad_norm']),
                                   rtol=1e-4)
        assert m['grad_norm'] > clip
        np.testing.assert_allclose(m['loss'], float(jm['loss']), rtol=1e-5)
        want = flatten_params(jp)
        for k, v in _port_flat(model).items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f'step {i}: {k}')
    assert opt.count == 3
    start = flatten_params(params)
    assert max(np.abs(v - start[k]).max()
               for k, v in _port_flat(model).items()) > 1e-4


@pytest.mark.parametrize('conf', [
    {'optim': 'adam'},
    {'optim': 'adamw', 'freeze_modules': ['encoder.embed'],
     'optim_conf': {'lr': 2e-3, 'weight_decay': 0.01, 'betas': [0.9, 0.98],
                    'eps': 1e-6}}])
def test_optimizer_update_matches_optax(setup, conf):
    """Adam/AdamW updates on the same given gradients (scaled by a clip
    factor) against the JAX package's optax chain, frozen parameters and
    weight decay included: parameters and moments within 1e-6 after three
    updates, frozen parameters unchanged."""
    base, jcfg, params = setup
    c = dict(base, **conf)
    tx, _ = jtr.build_optimizer(jtr.TrainConfig.from_config(c), params)
    state = tx.init(params)
    model = _port_model(c, params)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(c), model)
    rng = np.random.RandomState(4)
    jp = params
    for i in range(3):
        grads = {k: (rng.randn(*np.shape(v)) * 10.0 ** rng.randint(-6, 1)
                     ).astype(np.float32)
                 for k, v in flatten_params(params).items()}
        scale = 0.5 if i == 1 else 1.0
        gtree = jax.tree.map(lambda x: x * scale, jam_nest(grads))
        updates, state = tx.update(gtree, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        opt.step([torch.from_numpy(grads[convert.tree_key(n)])
                  for n in opt.names], scale)
    want = flatten_params(jp)
    for k, v in _port_flat(model).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    frozen = ttr.trainable_mask(model, ttr.TrainConfig.from_config(c))
    ref = flatten_params(params)
    for n, p in model.named_parameters():
        if not frozen[n]:
            assert np.array_equal(p.detach().numpy(),
                                  ref[convert.tree_key(n)]), n


def test_non_finite_batch_skips_the_update(setup):
    """A NaN in the features makes the gradient norm non-finite: the step
    is skipped, and parameters, Adam moments and the schedule's count stay
    exactly as they were."""
    conf, jcfg, params = setup
    model = _port_model(conf, params)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), model)
    step = ttr.make_train_step(model.cfg, opt, grad_clip=50.0)
    assert step(model, _tb(_batch()))['skipped'] == 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [t.clone() for t in opt.mu + opt.nu]
    bad = _tb(_batch(seed=1))
    bad['feats'][0, 0, 0] = float('nan')
    m = step(model, bad)
    assert m['skipped'] == 1.0 and not np.isfinite(m['grad_norm'])
    assert opt.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(opt.mu + opt.nu, moments):
        assert torch.equal(a, b)


def test_gradient_accumulation_averages_micro_batches(setup):
    """accum_grad=3 over a batch of three single-utterance micro-batches
    gives the mean of their gradients: one update equal to the one made
    from the averaged gradients by hand."""
    conf, jcfg, params = setup
    batch = _tb(_batch())
    a = _port_model(conf, params)
    opt_a, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), a)
    m = ttr.make_train_step(a.cfg, opt_a, accum_grad=3)(a, batch)
    b = _port_model(conf, params)
    opt_b, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), b)
    losses = []
    for i in range(3):
        out = tam.compute_loss(b, {k: v[i:i + 1] for k, v in batch.items()})
        out['loss'].backward()
        losses.append(float(out['loss'].detach()))
    grads = [p.grad / 3 for p in opt_b.params]
    opt_b.step(grads)
    np.testing.assert_allclose(m['loss'], np.mean(losses), rtol=1e-6)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=1e-6, atol=1e-7, msg=k)


@pytest.mark.parametrize('name', ['warmuplr', 'steadylr', 'NoamHoldAnnealing',
                                  'cosineannealing'])
def test_schedules_match_jax(name):
    conf = {'warmup_steps': 10, 'hold_steps': 5, 'max_steps': 100,
            'decay_rate': 0.5, 'min_lr': 1e-5}
    js = jsched.build_scheduler(name, 1e-3, conf)
    ts = tsched.build_scheduler(name, 1e-3, conf)
    for s in [0, 1, 5, 9, 10, 11, 14, 15, 16, 50, 99, 100, 101, 250]:
        np.testing.assert_allclose(ts(s), float(js(jnp.asarray(s))),
                                   rtol=1e-6, err_msg=f'{name} step {s}')


def test_freeze_rules_match_jax(setup):
    """trainable_mask over the same tree: freeze_modules prefixes, the
    restrict_learning include/exclude rules in order (first match wins),
    global_cmvn always frozen."""
    conf, jcfg, params = setup
    model = _port_model(conf, params)
    cases = [
        {},
        {'freeze_modules': ['encoder.encoders.0', 'decoder.right_decoder']},
        {'restrict_learning': [{'exclude': r'encoders\.1\.norm\.'},
                               {'include': r'language_layers|norm'},
                               {'exclude': r'.*'}]},
    ]
    for case in cases:
        c = dict(conf, **case)
        jmask = flatten_params(jtr.trainable_mask(
            params, jtr.TrainConfig.from_config(c)))
        tmask = ttr.trainable_mask(model, ttr.TrainConfig.from_config(c))
        assert {convert.tree_key(k): v for k, v in tmask.items()} == \
            {k: bool(v) for k, v in jmask.items()}, case
        assert not tmask['encoder.global_cmvn.mean']


def test_checkpoints_cross_load(setup, tmp_path):
    """The port writes `<tag>.npz` + `<tag>.yaml` that the JAX package
    loads, and loads what the JAX package writes; the optimizer state
    round-trips through the port's own file."""
    conf, jcfg, params = setup
    model = _port_model(conf, params)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), model)
    ttr.make_train_step(model.cfg, opt)(model, _tb(_batch()))
    path = tckpt.save_checkpoint(tmp_path / 'port', 'step_1', model, opt,
                                 {'step': 1, 'lr': 1.5e-4, 'tag': 'x'})
    jparams, _, info = jckpt.load_checkpoint(path)
    assert info == {'step': 1, 'lr': 1.5e-4, 'tag': 'x'}
    want = _port_flat(model)
    got = flatten_params(jparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jpath = jckpt.save_checkpoint(tmp_path / 'jax', 'init', params,
                                  info={'epoch': 2})
    other = _port_model(conf, jparams)
    opt2, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), other)
    assert tckpt.load_checkpoint(jpath, other) == {'epoch': 2}
    ref = flatten_params(params)
    for k, v in _port_flat(other).items():
        np.testing.assert_array_equal(v, np.asarray(ref[k]), err_msg=k)
    tckpt.load_checkpoint(path, other, opt2)
    assert opt2.count == opt.count == 1
    for a, b in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
        assert torch.equal(a, b)


def test_dropout_is_seeded_and_unbiased(setup):
    """With a generator the loss runs with dropout (every rate 0.1): the
    same seed repeats it exactly, another seed changes it, and without a
    generator the loss is the deterministic one.  modules.dropout keeps
    ≈ 1 − rate of the entries, scaled by 1/(1 − rate)."""
    conf, jcfg, params = setup
    model = _port_model(conf, params)
    batch = _tb(_batch())
    with torch.no_grad():
        a, b, c = (float(tam.compute_loss(
            model, batch, torch.Generator().manual_seed(s))['loss'])
            for s in (3, 3, 4))
        plain = float(tam.compute_loss(model, batch)['loss'])
    assert a == b and a != c and a != plain
    x = torch.ones(200, 500)
    y = modules.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert modules.dropout(x, 0.1, None) is x
