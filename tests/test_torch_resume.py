"""Resuming the port from the JAX package's optimizer state, f32 on CPU:
JAX saves `<tag>.npz` + `<tag>.opt.npz` (the optax leaves), the port's
train/checkpoint.py:load_checkpoint reads both, and both take one more
step, for Adam, AdamW and NovoGrad, and through both packages' train
steps for Adam with a bf16 first moment; a file of another layout raises.  The tiny model and the optimizer configs are
tests/test_torch_optim.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.train import checkpoint as jckpt
from reverb_tpu.train import trainer as jtr
from reverb_tpu_torch import convert
from reverb_tpu_torch.train import checkpoint as tckpt
from reverb_tpu_torch.train import trainer as ttr
from test_torch_optim import (OPTIMS, _assert_params, _conf, _grads,
                              _jax_update, _with_mu)
from test_torch_train import _batch, _jax_params, _jb, _port_model, _tb

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker


@pytest.fixture(scope='module')
def setup():
    conf = _conf()
    jcfg, params = _jax_params(conf)
    return conf, jcfg, params


@pytest.mark.parametrize('name,mu_dtype', [
    ('adam', None), ('adamw', None), ('novograd', None)])
def test_resume_from_jax_opt_state(setup, tmp_path, name, mu_dtype):
    """JAX takes two updates and saves `<tag>.npz` + `<tag>.opt.npz`; the
    port's load_checkpoint reads both (the optax leaves mapped by
    jax.tree.flatten order); then both take a third update: parameters
    within 1e-5, the count carried.  A state of another optimizer (other
    leaf count) raises naming the count it expected."""
    base, jcfg, params = setup
    c = _with_mu(dict(base, **OPTIMS[name]), mu_dtype)
    tx, _ = jtr.build_optimizer(jtr.TrainConfig.from_config(c), params)
    state = tx.init(params)
    rng = np.random.RandomState(7)
    jp = params
    for i in range(2):
        jp, state = _jax_update(tx, state, jp, _grads(params, rng), 1.0)
    jckpt.save_checkpoint(tmp_path, 'step_2', jp, state, {'step': 2})
    model = _port_model(c, params)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(c), model)
    info = tckpt.load_checkpoint(tmp_path / 'step_2.npz', model, opt)
    assert info['step'] == 2 and opt.count == 2
    grads = _grads(params, rng)
    jp, state = _jax_update(tx, state, jp, grads, 0.7)
    opt.step([torch.from_numpy(grads[convert.tree_key(n)])
              for n in opt.names], 0.7)
    _assert_params(model, jp, 1e-5, f'{name} resumed')

    other = dict(base, **OPTIMS['novograd' if name != 'novograd'
                                  else 'adam'])
    model2 = _port_model(other, params)
    opt2, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(other), model2)
    with pytest.raises(ValueError, match='optimizer holds'):
        tckpt.load_optax_state(tmp_path / 'step_2.opt.npz', opt2)
    n = len(opt.names)
    bad = tmp_path / 'bad.opt.npz'
    with np.load(tmp_path / 'step_2.opt.npz') as d:
        np.savez(bad, **{f'leaf_{i}': d[f'leaf_{i}']
                         for i in range(2 * n + 1)})
    with pytest.raises(ValueError, match=f'expected {2 * n + 2}'):
        tckpt.load_optax_state(bad, opt)


def test_resumed_train_step_matches_jax(setup, tmp_path):
    """The whole resume path: JAX's make_train_step takes two steps (adam,
    a bf16 first moment, clip 5) and saves; the port resumes through
    load_checkpoint and takes the third through its make_train_step, as
    JAX does: loss within 1e-5, parameters within 1e-5."""
    base, jcfg, params = setup
    c = _with_mu(dict(base, optim_conf={'lr': 1e-3, 'eps': 1e-3}),
                 'bfloat16')
    tx, _ = jtr.build_optimizer(jtr.TrainConfig.from_config(c), params)
    jstep = jax.jit(jtr.make_train_step(jcfg, tx, grad_clip=5.0))
    state = tx.init(params)
    jp = params
    for i in range(2):
        jp, state, _ = jstep(jp, state, _jb(_batch(seed=i)), jnp.asarray(i),
                             None)
    jckpt.save_checkpoint(tmp_path, 'step_2', jp, state, {'step': 2})
    model = _port_model(c, params)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(c), model)
    tckpt.load_checkpoint(tmp_path / 'step_2.npz', model, opt)
    step = ttr.make_train_step(model.cfg, opt, grad_clip=5.0)
    batch = _batch(seed=2)
    jp, state, jm = jstep(jp, state, _jb(batch), jnp.asarray(2), None)
    m = step(model, _tb(batch))
    np.testing.assert_allclose(m['loss'], float(jm['loss']), rtol=1e-5)
    assert opt.count == 3
    _assert_params(model, jp, 1e-5, 'resumed step')
