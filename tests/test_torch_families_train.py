"""`bin.train` of the port on the registry's families, f32 on the CPU: a
transducer, a bitransducer, an MoE conformer and each alternative
encoder train from a JAX-written initial checkpoint for an epoch (the
port's bundle loss on the batch the first step took equal to the JAX
bundle's `loss_fn` on the initial weights, and the step's own loss too
where the path draws no dropout), write `epoch_0.npz` that the JAX
package loads, and resume from it with the optimizer state.  The recipe
is tests/test_torch_train_bin.py's (4 WAVs, the rev_bpe tokenizer, CMVN
stats, width 128), with the family's keys over its config.  A family
over processes split along another axis than 'data' raises."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from reverb_tpu.convert.torch_ckpt import flatten_params, load_npz, save_npz
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu_torch import convert
from reverb_tpu_torch import init_model as tinit
from reverb_tpu_torch.bin import train as ttrain
from reverb_tpu_torch.train import trainer as ttr
from test_torch_train_bin import _write_recipe

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

FAMILIES = {
    'transducer': {'model': 'transducer', 'predictor': 'rnn',
                   'predictor_conf': {'predictor_embed_size': 32,
                                      'predictor_hidden_size': 32},
                   'joint_conf': {'join_dim': 32}},
    'bitransducer': {'model': 'bitransducer', 'predictor': 'conv',
                     'predictor_conf': {'predictor_embed_size': 32},
                     'joint_conf': {'join_dim': 32}},
    'moe': {'encoder_conf': {'positionwise_layer_type': 'moe',
                             'n_expert': 3, 'n_expert_per_token': 2}},
    'branchformer': {'encoder': 'branchformer',
                     'encoder_conf': {'cgmlp_linear_units': 256}},
    'e_branchformer': {'encoder': 'e_branchformer',
                       'encoder_conf': {'cgmlp_linear_units': 256,
                                        'ffn_units': 64}},
    'squeezeformer': {'encoder': 'squeezeformer',
                      'encoder_conf': {'num_blocks': 2, 'reduce_idx': 0,
                                       'recover_idx': 1}},
    'efficient_conformer': {'encoder': 'efficient_conformer',
                            'encoder_conf': {'num_blocks': 2,
                                             'group_layer_idx': [0],
                                             'stride_layer_idx': [0],
                                             'stride': [2], 'group_size': 2,
                                             'cnn_module_kernel': 7}},
}


# Branchformer and the Efficient Conformer keep the JAX encoders' fixed
# positional dropout of 0.1 after the subsampling, which a training step
# draws (the config's dropout_rate is 0 here)
NOISY = ('branchformer', 'e_branchformer', 'efficient_conformer')


@pytest.fixture(scope='module')
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp('families_recipe')
    cfg_path = _write_recipe(d)
    return d, yaml.safe_load(cfg_path.read_text())


def _argv(d, cfg, model_dir, ckpt, epochs):
    return ['--config', str(cfg), '--train_data', str(d / 'train.list'),
            '--cv_data', str(d / 'cv.list'), '--model_dir', str(model_dir),
            '--checkpoint', str(ckpt), '--max_epoch', str(epochs),
            '--log_interval', '1', '--seed', '3', '--device', 'cpu']


@pytest.mark.parametrize('family', list(FAMILIES))
def test_bin_train_trains_and_resumes(base, tmp_path, monkeypatch, family):
    d, conf = base
    conf = json.loads(json.dumps(conf))
    extra = json.loads(json.dumps(FAMILIES[family]))
    conf['encoder_conf'].update(extra.pop('encoder_conf', {}))
    conf.update(extra)
    if conf.get('encoder', 'conformer') != 'conformer':
        # the alternative encoders' hybrid loss feeds the decoder no
        # cat_embs: a plain transformer decoder
        conf['decoder'] = 'transformer'
    cfg_path = tmp_path / 'train.yaml'
    cfg_path.write_text(yaml.safe_dump(conf))
    jb = jinit(conf, jax.random.PRNGKey(0))
    save_npz(str(tmp_path / 'init.npz'), jb.params)

    steps = []
    make = ttr.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(model, b, generator=None):
            kept = {k: v.clone() for k, v in b.items()}
            steps.append((kept, step(model, b, generator)))
            return steps[-1][1]
        return run
    monkeypatch.setattr(ttr, 'make_train_step', recording)
    ex = ttrain.main(_argv(d, cfg_path, tmp_path / 'exp', tmp_path /
                           'init.npz', 1))
    assert ex.step == 2 and len(steps) == 2
    first, metrics = steps[0]
    want = float(jb.loss_fn(jb.params, {k: jnp.asarray(v.numpy())
                                        for k, v in first.items()},
                            None)['loss'])
    # the port's bundle on the initial weights, on the batch the step took
    tb = tinit(conf, device='cpu', state_dict=convert.state_dict_from_jax(
        flatten_params(jb.params)))
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tb.loss_fn(tb.model, first, None)['loss']), want,
            rtol=1e-5)
    if family not in NOISY:
        # no dropout on this path: the step's own loss is the same
        np.testing.assert_allclose(metrics['loss'], want, rtol=1e-4)
    assert all(np.isfinite(m['loss']) and m['skipped'] == 0.0
               for _, m in steps)
    # the JAX package loads the port's checkpoint, every leaf moved
    params, _ = load_npz(str(tmp_path / 'exp' / 'epoch_0.npz'))
    got, init = flatten_params(params), flatten_params(jb.params)
    assert set(got) == set(init)
    assert max(float(np.abs(np.asarray(v) - np.asarray(init[k])).max())
               for k, v in got.items()) > 1e-4
    # resume from epoch_0 with its optimizer state: the run starts at
    # the checkpoint's epoch and step (as the JAX package's), epochs 0-1
    ex = ttrain.main(_argv(d, cfg_path, tmp_path / 'exp',
                           tmp_path / 'exp' / 'epoch_0.npz', 2))
    assert ex.step == 6 and len(steps) == 6
    info = yaml.safe_load((tmp_path / 'exp' / 'epoch_1.yaml').read_text())
    assert info['epoch'] == 1 and info['step'] == 6
    assert np.isfinite(info['cv_loss'])


@pytest.mark.parametrize('family,split', [
    ('transducer', '--num_devices_model'),
    ('squeezeformer', '--num_devices_seq')])
def test_bin_train_refuses_a_family_over_several_processes(base, tmp_path,
                                                           family, split):
    """A registry family splits over 'model' or 'seq' in several
    processes only (tests/test_torch_families_axes.py trains every family
    under each axis): in one process the split flag raises ValueError
    before any step, as for the asr_model."""
    d, conf = base
    conf = json.loads(json.dumps(conf))
    extra = json.loads(json.dumps(FAMILIES[family]))
    conf['encoder_conf'].update(extra.pop('encoder_conf', {}))
    conf.update(extra)
    cfg_path = tmp_path / 'train.yaml'
    cfg_path.write_text(yaml.safe_dump(conf))
    with pytest.raises(ValueError, match='several processes'):
        ttrain.main(_argv(d, cfg_path, tmp_path / 'exp', d / 'init.npz', 1)
                    + [split, '2'])
