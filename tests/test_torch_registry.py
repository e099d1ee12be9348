"""The port's model registry against the JAX package's, f32 on the CPU:
`init_model` dispatch for asr_model, transducer, bitransducer, the four
alternative encoders and the six families ported last (k2_model,
ctl_model, bestrq, wav2vec2, w2vbert, whisper): each bundle's loss
against the JAX bundle's `loss_fn` on the same weights and batch; an
unknown name raising ValueError, and `.npz` checkpoints crossing both
ways."""

import jax
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params, load_npz, save_npz
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu_torch import convert
from reverb_tpu_torch import init_model as tinit
from reverb_tpu_torch.models import registry as treg
from reverb_tpu_torch.train import checkpoint as tckpt
from torch_families import (ALT, DEC, ENC, V, alt_conf, batch, both_bundles,
                            to_jax, to_torch, transducer_conf)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

ASR = {'input_dim': 80, 'output_dim': V, 'encoder': 'conformer',
       'encoder_conf': ENC, 'decoder': 'bitransformer',
       'decoder_conf': dict(DEC, r_num_blocks=1),
       'model_conf': {'ctc_weight': 0.3, 'reverse_weight': 0.3}}


def _conf(kind):
    if kind == 'asr_model':
        return ASR
    if kind in ('transducer', 'bitransducer'):
        return transducer_conf(kind)
    return alt_conf(kind)


@pytest.mark.parametrize('kind', ['asr_model', 'transducer', 'bitransducer',
                                  *ALT])
def test_init_model_dispatch_and_loss_match_jax(kind):
    jb, tb = both_bundles(_conf(kind))
    assert tb.kind == jb.kind == kind
    b = batch(T=24 if 'transducer' in kind else 70, U=3)
    want = jb.loss_fn(jb.params, to_jax(b), None)
    got = tb.loss_fn(tb.model, to_torch(b), None)
    assert set(got) == set(want)
    for k, v in want.items():
        if v is not None:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # built from a generator instead: trainable, in training mode
    fresh = tinit(_conf(kind), torch.Generator().manual_seed(0), 'cpu')
    assert fresh.model.training and all(
        p.requires_grad for n, p in fresh.model.named_parameters()
        if not convert.lstm_second_bias(n))
    assert set(convert.flat_from_state_dict(fresh.model.state_dict())) == \
        set(flatten_params(jb.params))


# the families that raised until they were ported; at mask_prob 0 the SSL
# losses draw nothing that reaches their value, so the bundles' own losses
# compare (tests/test_torch_ssl.py feeds both packages the same draws)
FORMER_UNPORTED = ('k2_model', 'ctl_model', 'bestrq', 'wav2vec2', 'w2vbert',
                   'whisper')


def _family_conf(kind):
    if kind == 'whisper':
        return {'model': 'whisper', 'whisper_conf': {
            'n_mels': 80, 'n_audio_state': 32, 'n_audio_head': 2,
            'n_audio_layer': 1, 'n_text_state': 32, 'n_text_head': 2,
            'n_text_layer': 1, 'n_vocab': V, 'n_audio_ctx': 40,
            'n_text_ctx': 20}}
    conf = dict(ASR, model=kind)
    if kind in ('wav2vec2', 'w2vbert'):
        conf['wav2vec2_conf'] = {'codebook_size': 8, 'mask_prob': 0.0,
                                 'num_negatives': 3}
    if kind == 'bestrq':
        conf['bestrq_conf'] = {'codebook_size': 16, 'mask_prob': 0.0}
    return conf


@pytest.mark.parametrize('kind', FORMER_UNPORTED)
def test_unported_families_raise(kind):
    """No family raises any more: `init_model` builds each of the six the
    port once lacked, and its bundle's loss equals the JAX bundle's."""
    assert treg.UNPORTED == () and kind in treg.PORTED
    jb, tb = both_bundles(_family_conf(kind))
    assert tb.kind == jb.kind == kind
    b = batch(T=70, U=3)
    want = jb.loss_fn(jb.params, to_jax(b), jax.random.PRNGKey(0))
    got = tb.loss_fn(tb.model, to_torch(b), torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k, v in want.items():
        if v is not None:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    fresh = tinit(_family_conf(kind), torch.Generator().manual_seed(0),
                  'cpu')
    assert set(convert.flat_from_state_dict(fresh.model.state_dict())) == \
        set(flatten_params(jb.params))


def test_unknown_model_raises():
    with pytest.raises(ValueError, match='unknown model type'):
        tinit({'model': 'bogus'}, device='cpu')
    with pytest.raises(ValueError, match='unknown model type'):
        jinit({'model': 'bogus'}, jax.random.PRNGKey(0))


def test_init_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='cuda'):
        tinit(transducer_conf())


@pytest.mark.parametrize('kind', ['transducer', 'bitransducer', *ALT])
def test_npz_round_trips_both_ways(kind, tmp_path):
    """A JAX `.npz` loads into the port (`load_checkpoint`) with the same
    loss; the port's `save_checkpoint` loads into the JAX tree leaf for
    leaf."""
    conf = _conf(kind)
    jb = jinit(conf, jax.random.PRNGKey(1))
    save_npz(str(tmp_path / 'jax.npz'), jb.params)
    tb = tinit(conf, torch.Generator().manual_seed(5), 'cpu')
    tckpt.load_checkpoint(tmp_path / 'jax.npz', tb.model)
    b = batch(T=24 if 'transducer' in kind else 70, U=3)
    np.testing.assert_allclose(
        float(tb.loss_fn(tb.model, to_torch(b), None)['loss']),
        float(jb.loss_fn(jb.params, to_jax(b), None)['loss']), rtol=1e-5)
    tckpt.save_checkpoint(tmp_path, 'port', tb.model, info={'step': 1})
    params, _ = load_npz(str(tmp_path / 'port.npz'))
    want = flatten_params(jb.params)
    got = flatten_params(params)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=k)


def test_jax_optimizer_state_resumes_a_transducer(tmp_path):
    """The JAX package's `<tag>.opt.npz` of a transducer (one Adam update
    applied, so every moment is non-zero) loads into the port's optimizer:
    the moments of each parameter, the LSTM's `b` into `bias_ih` (the port's
    frozen `bias_hh` has no leaf), and the count."""
    import jax.numpy as jnp
    from reverb_tpu.train import checkpoint as jckpt
    from reverb_tpu.train import trainer as jtrainer
    from reverb_tpu_torch.train import trainer as ttrainer
    conf = dict(transducer_conf('transducer', 'rnn'),
                optim_conf={'lr': 1e-3})
    jb = jinit(conf, jax.random.PRNGKey(2))
    tx, _ = jtrainer.build_optimizer(jtrainer.TrainConfig.from_config(conf),
                                     jb.params)
    state = tx.init(jb.params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), jb.params)
    _, state = tx.update(grads, state, jb.params)
    jckpt.save_checkpoint(tmp_path, 'epoch_0', jb.params, state,
                          {'epoch': 0, 'step': 1})
    tb = tinit(conf, torch.Generator().manual_seed(0), 'cpu')
    opt, _ = ttrainer.build_optimizer(
        ttrainer.TrainConfig.from_config(conf), tb.model)
    info = tckpt.load_checkpoint(tmp_path / 'epoch_0.npz', tb.model, opt)
    assert info['step'] == 1 and opt.count == 1
    names = [opt.names[i] for i in opt.train_idx]
    assert 'predictor.rnn.bias_ih_l0' in names
    assert not any(convert.lstm_second_bias(n) for n in names)
    for m, v in zip(opt.mu, opt.nu):
        np.testing.assert_allclose(m.numpy(), 0.05, rtol=1e-6)
        np.testing.assert_allclose(v.numpy(), 0.00025, rtol=1e-6)
