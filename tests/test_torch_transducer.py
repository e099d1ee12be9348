"""The transducer family of the port against the JAX package's, f32 on the
CPU: the exact RNN-T loss and its gradient (also against the brute-force
sum), the three predictors (step by step against the whole sequence),
the transducer and bitransducer losses and gradients of the registry's
bundles, greedy search, the five ESPnet searches (nbest, batch, the
unknown-type error) and the device TSD per predictor.

Search ties: the searches are held to JAX's tokens exactly on joints
sharpened to a margin (tests/test_transducer_search.py's fixture: the
output layer ×3 and the blank bias +2), and, where the beam holds every
alignment, their scores to the exact log P(y|x) of the brute force."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.decode import transducer_device as jdev
from reverb_tpu.decode import transducer_search as jsearch
from reverb_tpu.models import transducer as jtr
from reverb_tpu_torch import convert
from reverb_tpu_torch.decode import transducer_device as tdev
from reverb_tpu_torch.decode import transducer_search as tsearch
from reverb_tpu_torch.models import transducer as ttr
from test_transducer import rnnt_nll_bruteforce
from torch_families import (assert_grads_close, batch, both_bundles,
                            losses_and_grads, transducer_conf)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker


def _port_pair(params, kw):
    """The port's Predictor and Joint holding JAX's transducer params."""
    cfg = ttr.TransducerConfig(**kw)
    sd = convert.state_dict_from_jax(flatten_params(params))
    pred, joint = ttr.Predictor(cfg), ttr.Joint(cfg)
    for name, mod in (('predictor', pred), ('joint', joint)):
        mod.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()
                             if k.startswith(name + '.')})
    return pred.requires_grad_(False), joint.requires_grad_(False)


@pytest.mark.parametrize('seed', [0, 1])
def test_rnnt_loss_and_gradient_match_jax(seed):
    rng = np.random.RandomState(seed)
    B, T, U, V = 3, 7, 4, 9
    logits = rng.randn(B, T, U + 1, V).astype(np.float32) * 2
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    t_lens = np.array([T, T - 2, 1], np.int32)
    u_lens = np.array([U, U - 1, 0], np.int32)

    def jloss(x):
        return jnp.sum(jtr.rnnt_loss(x, jnp.asarray(t_lens),
                                     jnp.asarray(labels),
                                     jnp.asarray(u_lens)) * jnp.arange(1, 4))
    want, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    nll = ttr.rnnt_loss(x, torch.from_numpy(t_lens), torch.from_numpy(labels),
                        torch.from_numpy(u_lens))
    (nll * torch.arange(1, 4)).sum().backward()
    np.testing.assert_allclose(float((nll * torch.arange(1, 4)).sum()),
                               float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-5)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    for b in range(B):
        np.testing.assert_allclose(
            float(nll[b]), rnnt_nll_bruteforce(logp[b], labels[b], t_lens[b],
                                               u_lens[b]), rtol=1e-5)


@pytest.mark.parametrize('kind', ['rnn', 'embedding', 'conv'])
def test_predictor_step_matches_forward_and_jax(kind):
    kw = dict(vocab_size=20, encoder_output_size=16, predictor=kind,
              predictor_embed_size=16, predictor_hidden_size=12,
              predictor_layers=2, predictor_kernel=3, join_dim=16)
    params = jtr.init_transducer(jax.random.PRNGKey(1),
                                 jtr.TransducerConfig(**kw))
    pred, _ = _port_pair(params, kw)
    ys = np.array([[0, 3, 7, 2, 9], [0, 5, 5, 1, 0]], np.int32)
    want = np.asarray(jtr.predictor_forward(params['predictor'],
                                            jnp.asarray(ys),
                                            jtr.TransducerConfig(**kw)))
    full = pred(torch.from_numpy(ys))
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5)
    state = pred.init_state(2, 'cpu')
    outs = []
    for i in range(ys.shape[1]):
        out, state = pred.step(torch.from_numpy(ys[:, i]), state)
        outs.append(out)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('model,predictor', [('transducer', 'conv'),
                                             ('bitransducer', 'rnn'),
                                             ('bitransducer', 'embedding')])
def test_transducer_loss_and_gradients_match_jax(model, predictor):
    jb, tb = both_bundles(transducer_conf(model, predictor))
    assert tb.kind == jb.kind == model
    jout, tout, jg, tg = losses_and_grads(jb, tb, batch(T=24, U=3))
    for k in ('loss', 'loss_rnnt', 'loss_ctc'):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5,
                                   err_msg=k)
    assert_grads_close(jg, tg)
    # the rnn predictor's second LSTM bias stays out of the gradient
    assert all(p.grad is None for n, p in tb.model.named_parameters()
               if convert.lstm_second_bias(n))


def test_greedy_matches_jax():
    kw = dict(vocab_size=20, encoder_output_size=16,
              predictor_embed_size=16, predictor_hidden_size=16,
              predictor_layers=1, join_dim=32)
    params = jtr.init_transducer(jax.random.PRNGKey(0),
                                 jtr.TransducerConfig(**kw))
    pred, joint = _port_pair(params, kw)
    enc = np.random.RandomState(2).randn(2, 6, 16).astype(np.float32)
    lens = np.array([6, 4])
    want = jtr.transducer_greedy_search(params, jnp.asarray(enc), lens,
                                        jtr.TransducerConfig(**kw))
    got = ttr.transducer_greedy_search(pred, joint, torch.from_numpy(enc),
                                       lens)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert any(r.tokens for r in got)
    want = jtr.transducer_beam_search(params, jnp.asarray(enc), lens,
                                      jtr.TransducerConfig(**kw), 3)
    got = ttr.transducer_beam_search(pred, joint, torch.from_numpy(enc),
                                     lens, beam_size=3)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], atol=1e-4)


# ---------------- the five searches (tiny sharpened lattice) -------------

TV, TD, TT = 4, 8, 3
TINY = dict(vocab_size=TV, encoder_output_size=TD, predictor='embedding',
            predictor_embed_size=TD, predictor_kernel=2, join_dim=8)


@pytest.fixture(scope='module')
def tiny():
    params = jtr.init_transducer(jax.random.PRNGKey(3),
                                 jtr.TransducerConfig(**TINY))
    ffn = params['joint']['ffn_out']
    ffn['weight'] = ffn['weight'] * 3.0
    ffn['bias'] = ffn['bias'].at[0].add(2.0)
    pred, joint = _port_pair(params, TINY)
    enc = np.random.RandomState(0).randn(1, TT, TD).astype(np.float32) * 1.5
    # the exact log P(y|x) of every sequence up to T labels, by the
    # port's rnnt_loss
    seqs = [y for U in range(TT + 1)
            for y in itertools.product(range(1, TV), repeat=U)]
    labels = np.zeros((len(seqs), TT), np.int64)
    for i, y in enumerate(seqs):
        labels[i, :len(y)] = y
    lens = torch.tensor([len(y) for y in seqs])
    with torch.no_grad():
        ys_in = torch.cat([torch.zeros(len(seqs), 1, dtype=torch.int64),
                           torch.from_numpy(labels)], 1)
        encN = torch.from_numpy(enc).expand(len(seqs), TT, TD)
        logits = joint(encN[:, :, None], pred(ys_in)[:, None])
        nll = ttr.rnnt_loss(logits, torch.full((len(seqs),), TT),
                            torch.from_numpy(labels), lens)
    log_p = {y: -float(n) for y, n in zip(seqs, nll)}
    return params, pred, joint, enc, log_p


SEARCHES = [('default', {}, True), ('tsd', {'max_sym_exp': 3}, True),
            ('tsd_host', {'max_sym_exp': 3}, True),
            ('alsd', {'u_max_ratio': 1.0}, True),
            ('nsc', {'nstep': 3}, False),       # prefix-alpha over-counts
            ('maes', {'nstep': 3, 'expansion_gamma': 10.0}, True)]


@pytest.mark.parametrize('search_type,kwargs,exact_score', SEARCHES)
def test_search_matches_jax_and_finds_map(tiny, search_type, kwargs,
                                          exact_score):
    params, pred, joint, enc, log_p = tiny
    want = jsearch.beam_search_transducer(
        params, jtr.TransducerConfig(**TINY), enc, np.array([TT]),
        search_type=search_type, beam_size=6, nbest=4, **kwargs)
    got = tsearch.beam_search_transducer(
        pred, joint, torch.from_numpy(enc), torch.tensor([TT]),
        search_type=search_type, beam_size=6, nbest=4, **kwargs)
    assert [[r.tokens for r in n] for n in got] == \
        [[r.tokens for r in n] for n in want]
    np.testing.assert_allclose([r.score for r in got[0]],
                               [r.score for r in want[0]], atol=1e-4)
    best = max(log_p, key=lambda y: log_p[y] / max(len(y), 1))
    assert tuple(got[0][0].tokens) == best
    if exact_score:
        assert abs(got[0][0].score - log_p[best]) < 5e-3


@pytest.mark.parametrize('search_type', ['alsd', 'maes'])
def test_search_nbest_and_batch_match_jax(tiny, search_type):
    params, pred, joint, enc, _ = tiny
    enc2 = np.concatenate([enc, enc[:, ::-1]], 0).copy()
    lens = np.array([TT, 2])
    kw = {'alsd': {'u_max_ratio': 1.0}, 'maes': {'nstep': 2}}[search_type]
    want = jsearch.beam_search_transducer(
        params, jtr.TransducerConfig(**TINY), enc2, lens,
        search_type=search_type, beam_size=4, nbest=3, **kw)
    got = tsearch.beam_search_transducer(
        pred, joint, torch.from_numpy(enc2), torch.from_numpy(lens),
        search_type=search_type, beam_size=4, nbest=3, **kw)
    assert len(got) == 2 and all(1 <= len(n) <= 3 for n in got)
    for g, w in zip(got, want):
        assert [r.tokens for r in g] == [r.tokens for r in w]
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], atol=1e-4)
    s = [r.score / max(len(r.tokens), 1) for r in got[0]]
    assert s == sorted(s, reverse=True)


def test_unknown_search_type_raises(tiny):
    _, pred, joint, enc, _ = tiny
    with pytest.raises(ValueError, match='unknown transducer search'):
        tsearch.beam_search_transducer(pred, joint, torch.from_numpy(enc),
                                       torch.tensor([TT]),
                                       search_type='bogus')


@pytest.mark.parametrize('predictor', ['embedding', 'rnn', 'conv'])
def test_tsd_device_matches_jax(predictor):
    """The batched device TSD against JAX's, prefixes and scores, over a
    batch of uneven lengths (and against the port's host TSD)."""
    T, D, V = 12, 8, 6
    kw = dict(vocab_size=V, encoder_output_size=D, predictor=predictor,
              predictor_embed_size=D, predictor_hidden_size=8,
              predictor_layers=1, predictor_kernel=2, join_dim=8)
    params = jtr.init_transducer(jax.random.PRNGKey(11),
                                 jtr.TransducerConfig(**kw))
    params['joint']['ffn_out']['bias'] = \
        params['joint']['ffn_out']['bias'].at[0].add(1.5)
    pred, joint = _port_pair(params, kw)
    enc = np.random.RandomState(predictor == 'rnn').randn(
        2, T, D).astype(np.float32) * 1.2
    lens = np.array([T, T - 5], np.int32)
    want = jdev.tsd_device_host(params, jtr.TransducerConfig(**kw), enc,
                                lens, beam_size=4, max_sym_exp=3)
    got = tdev.tsd_device_host(pred, joint, torch.from_numpy(enc),
                               torch.from_numpy(lens), beam_size=4,
                               max_sym_exp=3)
    for g, w in zip(got, want):
        assert [y for y, _ in g] == [y for y, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=1e-4)
    host = tsearch.beam_search_transducer(
        pred, joint, torch.from_numpy(enc), torch.from_numpy(lens),
        search_type='tsd_host', beam_size=4, nbest=4, max_sym_exp=3)
    for g, h in zip(got, host):
        hd = {tuple(r.tokens): r.score for r in h}
        assert set(dict(g)) == set(hd)
        for y, s in g:
            assert abs(s - hd[y]) < 2e-3, (y, s, hd[y])
