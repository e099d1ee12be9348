"""The port's optimizers against the JAX package, f32 on CPU: Adam, AdamW
and NovoGrad, each with and without a bf16 first moment
(`optim_conf.mu_dtype`), three updates on the same given gradients against
the optax chain of reverb_tpu's build_optimizer (tests/test_torch_resume.py
resumes each from a JAX optimizer state).

With a bf16 first moment optax runs op by op (tx.update outside jit),
whose arithmetic the port follows: inside a jitted program XLA may keep
the bf16 product b1·mu in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.convert.torch_ckpt import nest_state_dict as jam_nest
from reverb_tpu.train import trainer as jtr
from reverb_tpu_torch import convert
from reverb_tpu_torch.train import trainer as ttr
from reverb_tpu.models import presets as jpresets
from test_torch_train import _jax_params, _port_flat, _port_model

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

OPTIMS = {
    'adam': {'optim': 'adam'},
    'adamw': {'optim': 'adamw', 'freeze_modules': ['encoder.embed'],
              'optim_conf': {'lr': 2e-3, 'weight_decay': 0.01,
                             'betas': [0.9, 0.98], 'eps': 1e-6}},
    'novograd': {'optim': 'novograd', 'freeze_modules': ['decoder.right'],
                 'optim_conf': {'lr': 2e-3, 'weight_decay': 0.001,
                                'betas': [0.95, 0.5], 'eps': 1e-8}},
}


def _conf():
    """tests/test_torch_train.py's tiny model, two encoder layers and one
    decoder layer each way (the optimizers see ~130 leaves)."""
    conf = jpresets.reverb_config(output_size=128, attention_heads=2,
                                  linear_units=96, num_blocks=2, dec_blocks=1,
                                  r_blocks=1, vocab_size=23)
    conf['decoder'] = 'lsl_bitransformer'
    conf['scheduler_conf'] = {'warmup_steps': 6}
    return conf


@pytest.fixture(scope='module')
def setup():
    conf = _conf()
    jcfg, params = _jax_params(conf)
    return conf, jcfg, params


def _with_mu(conf, mu_dtype):
    conf = dict(conf)
    oc = dict(conf.get('optim_conf', {'lr': 1e-3}))
    if mu_dtype:
        oc['mu_dtype'] = mu_dtype
    conf['optim_conf'] = oc
    return conf


def _grads(params, rng):
    return {k: (rng.randn(*np.shape(v)) * 10.0 ** rng.randint(-6, 1)
                ).astype(np.float32)
            for k, v in flatten_params(params).items()}


_JITTED = {}


def _jax_update(tx, state, jp, grads, scale):
    """One optax update; op by op where a moment is bf16, else jitted."""
    gtree = jax.tree.map(lambda x: x * scale, jam_nest(grads))
    update = tx.update
    if all(x.dtype != jnp.bfloat16 for x in jax.tree.leaves(state)):
        update = _JITTED.setdefault(tx, jax.jit(tx.update))
    updates, state = update(gtree, state, jp)
    return jax.tree.map(lambda p, u: p + u, jp, updates), state


def _moment_state(state):
    """The ScaleByAdamState / ScaleByNovogradState inside the chain."""
    return [s for s in jax.tree.leaves(
        state, is_leaf=lambda x: hasattr(x, 'mu')) if hasattr(s, 'mu')][0]


def _assert_params(model, jp, tol, what):
    want = flatten_params(jp)
    for k, v in _port_flat(model).items():
        np.testing.assert_allclose(v, want[k], rtol=tol, atol=tol,
                                   err_msg=f'{what}: {k}')


@pytest.mark.parametrize('mu_dtype', [None, 'bfloat16'])
@pytest.mark.parametrize('name', list(OPTIMS))
def test_optimizer_matches_optax(setup, name, mu_dtype):
    """Three updates on the same given gradients (one scaled by a clip
    factor): parameters within 1e-6, frozen ones unchanged, and the first
    moment equal to optax's (a bf16 one equal in storage); novograd takes
    no mu_dtype in either package."""
    base, jcfg, params = setup
    c = _with_mu(dict(base, **OPTIMS[name]), mu_dtype)
    tc = ttr.TrainConfig.from_config(c)
    model = _port_model(c, params)
    if name.startswith('novograd') and mu_dtype:
        with pytest.raises(TypeError):
            jtr.build_optimizer(jtr.TrainConfig.from_config(c), params)
        with pytest.raises(TypeError):
            ttr.build_optimizer(tc, model)
        return
    tx, _ = jtr.build_optimizer(jtr.TrainConfig.from_config(c), params)
    state = tx.init(params)
    opt, _ = ttr.build_optimizer(tc, model)
    rng = np.random.RandomState(4)
    jp = params
    for i in range(3):
        grads = _grads(params, rng)
        scale = 0.5 if i == 1 else 1.0
        jp, state = _jax_update(tx, state, jp, grads, scale)
        opt.step([torch.from_numpy(grads[convert.tree_key(n)])
                  for n in opt.names], scale)
    _assert_params(model, jp, 1e-6, name)
    jmu = flatten_params(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), _moment_state(state).mu))
    trainable = ttr.trainable_mask(model, tc)
    ref = flatten_params(params)
    for n, p in model.named_parameters():
        if not trainable[n]:
            assert np.array_equal(p.detach().numpy(),
                                  ref[convert.tree_key(n)]), n
    for i, m in zip(opt.train_idx, opt.mu):
        got = m.float().numpy()
        want = jmu[convert.tree_key(opt.names[i])]
        if mu_dtype:
            assert m.dtype == torch.bfloat16
            assert np.array_equal(got, want), opt.names[i]
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=opt.names[i])
