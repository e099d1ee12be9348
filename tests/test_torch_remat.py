"""Gradient checkpointing and the non-blank-embedding loss in the port, f32
on CPU.

Checkpointing (`gradient_checkpointing` with `remat_policy` full, dots or
dots_no_ln, in the encoder and the decoder) must not change a value: with
dropout 0.1 everywhere (attention dropout through K1's keep-mask route
included) the checkpointed loss and every gradient are bitwise those of
the unchecked step at the same seed, and the generator ends where it
does.  Against the JAX package (no dropout: the two random streams
differ) the checkpointed step matches JAX's make_train_step, which remats
its layers because it is given an rng.  The non-blank-embedding loss and
its gradient are held to JAX's compute_loss on a CTC head sharpened so
that about half the frames survive the filter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import asr_model as jam
from reverb_tpu.train import trainer as jtr
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.train import trainer as ttr
from test_torch_train import (_batch, _jax_params, _jb, _port_flat,
                              _port_model, _tb)
from test_torch_optim import _conf

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker


def _remat(conf, policy, dyn=False):
    conf = dict(conf)
    for part in ('encoder_conf', 'decoder_conf'):
        conf[part] = dict(conf[part], gradient_checkpointing=policy is not None,
                          remat_policy=policy or 'dots')
    if dyn:
        conf['encoder_conf'].update(use_dynamic_chunk=True)
    return conf


def _no_dropout(conf):
    conf = dict(conf)
    conf['encoder_conf'] = dict(conf['encoder_conf'], dropout_rate=0.0,
                                positional_dropout_rate=0.0,
                                attention_dropout_rate=0.0)
    conf['decoder_conf'] = dict(conf['decoder_conf'], dropout_rate=0.0,
                                positional_dropout_rate=0.0,
                                self_attention_dropout_rate=0.0,
                                src_attention_dropout_rate=0.0)
    return conf


@pytest.fixture(scope='module')
def setup():
    conf = _conf()
    jcfg, params = _jax_params(conf)
    return conf, jcfg, params


def _loss_and_grads(conf, params, batch, seed):
    """(loss terms, gradients, the generator's state after, layer forward
    calls: a checkpointed layer runs again in the backward)."""
    model = _port_model(conf, params)
    calls = []
    layers = [*model.encoder.encoders, *model.decoder.left_decoder.decoders,
              *model.decoder.right_decoder.decoders]
    for layer in layers:
        layer.register_forward_pre_hook(lambda *a: calls.append(1))
    g = torch.Generator().manual_seed(seed)
    out = tam.compute_loss(model, _tb(batch), g)
    out['loss'].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out, grads, g.get_state(), len(calls) / len(layers)


@pytest.mark.parametrize('dyn,policies', [
    (False, ('full', 'dots', 'dots_no_ln')), (True, ('dots',))])
def test_checkpointed_step_is_bitwise_the_plain_one(setup, dyn, policies):
    """Loss, every gradient and the generator's state after the step are
    bitwise equal with checkpointing off, 'full', 'dots' and 'dots_no_ln';
    with use_dynamic_chunk the chunk draw comes first and the layers take
    the masked route."""
    conf, _, params = setup
    batch = _batch(seed=5)
    want, wgrads, wstate, runs = _loss_and_grads(_remat(conf, None, dyn),
                                                 params, batch, 11)
    assert runs == 1
    for policy in policies:
        c = _remat(conf, policy, dyn)
        assert tam.ModelConfig.from_config(c).encoder.gradient_checkpointing
        out, grads, state, runs = _loss_and_grads(c, params, batch, 11)
        assert runs == 2, policy
        for k in ('loss', 'loss_att', 'loss_ctc'):
            assert torch.equal(out[k], want[k]), (policy, k)
        for n, gr in grads.items():
            assert torch.equal(gr, wgrads[n]), (policy, n)
        assert torch.equal(state, wstate), policy
    if not dyn:
        # dropout was on: another seed gives another loss
        other = _loss_and_grads(_remat(conf, None), params, batch, 12)[0]
        assert not torch.equal(other['loss'], want['loss'])


def test_checkpointed_step_matches_jax():
    """Two make_train_step updates of the checkpointed tiny model (one
    layer in the encoder and in each decoder: JAX compiles the step;
    'full' in the encoder and 'dots' in the decoder), no dropout, against
    JAX's step given an rng (which remats): loss and the updated
    parameters within 1e-4."""
    base = _conf()
    for part in ('encoder_conf', 'decoder_conf'):
        base[part] = dict(base[part], num_blocks=1)
    base['decoder_conf']['r_num_blocks'] = 1
    c = _no_dropout(_remat(base, 'full'))
    c['decoder_conf']['remat_policy'] = 'dots'
    c['optim_conf'] = {'lr': 1e-3, 'eps': 1e-3}
    jcfg, params = _jax_params(c)
    assert jcfg.encoder.gradient_checkpointing
    tx, _ = jtr.build_optimizer(jtr.TrainConfig.from_config(c), params)
    jstep = jax.jit(jtr.make_train_step(jcfg, tx, grad_clip=5.0))
    state = tx.init(params)
    model = _port_model(c, params)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(c), model)
    step = ttr.make_train_step(model.cfg, opt, grad_clip=5.0)
    g = torch.Generator().manual_seed(0)
    jp = params
    for i in range(2):
        batch = _batch(seed=i)
        jp, state, jm = jstep(jp, state, _jb(batch), jnp.asarray(i),
                              jax.random.PRNGKey(i))
        m = step(model, _tb(batch), g)
        np.testing.assert_allclose(m['loss'], float(jm['loss']), rtol=1e-4)
    want = flatten_params(jp)
    for k, v in _port_flat(model).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _sharpened(conf, params, batch):
    """params with the CTC head scaled and its blank bias set so that the
    blank is the argmax on about half of the valid frames (the port's
    encoder, on the same weights, finds the split)."""
    w = np.asarray(params['ctc']['ctc_lo']['weight']) * 8
    model = _port_model(conf, params)
    tb = _tb(batch)
    with torch.no_grad():
        enc, mask = model.forward_encoder(tb['feats'], tb['feats_lengths'],
                                          tb['cat_embs'])
        logits = (enc @ torch.from_numpy(w).T).numpy()
    gap = (logits[..., 1:].max(-1) - logits[..., 0])[mask[:, 0].numpy()]
    bias = np.zeros(w.shape[0], np.float32)
    bias[0] = float(np.median(gap))
    return dict(params, ctc={'ctc_lo': {'weight': jnp.asarray(w),
                                        'bias': jnp.asarray(bias)}})


def test_non_blank_embedding_loss_matches_jax(setup):
    """model_conf.apply_non_blank_embedding: the decoder sees only the
    frames whose CTC argmax is not blank.  Loss terms and every gradient
    against JAX compute_loss + jax.grad within 1e-4; the filter keeps
    some frames and drops others."""
    conf, _, params = setup
    c = dict(conf, model_conf=dict(conf['model_conf'],
                                   apply_non_blank_embedding=True))
    jcfg = jam.ModelConfig.from_config(c)
    batch = _batch(seed=3)
    params = _sharpened(c, params, batch)

    def loss_fn(p):
        out = jam.compute_loss(p, jcfg, _jb(batch))
        return out['loss'], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    jgrads = flatten_params(jgrads)
    model = _port_model(c, params)
    assert model.cfg.apply_non_blank_embedding
    tb = _tb(batch)
    with torch.no_grad():
        enc, mask = model.forward_encoder(tb['feats'], tb['feats_lengths'],
                                          tb['cat_embs'])
        _, kept = tam.filter_blank_embedding(
            model.cfg, tam.ctc_mod.ctc_logprobs(model.ctc, enc), enc, mask)
    frac = float(kept.sum()) / float(mask.sum())
    assert 0.2 < frac < 0.8, frac
    out = tam.compute_loss(model, tb)
    out['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   rtol=1e-4, err_msg=k)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   jgrads[convert.tree_key(name)],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
