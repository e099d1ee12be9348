"""The port's CTL model, FSA scorers and LF-MMI k2_model against the JAX
package's, f32 on the CPU: the CTL full view, chunk view (JAX's chunk
draws fed to both) and contrastive term with injected negatives, loss and
gradient; both denominator scorers against JAX and against brute-force
enumeration (tests/test_k2_lfmmi.py's cases), batched with ragged
lengths; the LF-MMI loss and its gradient through the k2_model bundle
with the unigram and the bigram graph; and the CTC numerator on a row
with no alignment, where optax gives a large finite loss and
`F.ctc_loss` inf (models/ctc.py:ctc_per_seq takes optax's value)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reverb_tpu.models import ctl as jctl
from reverb_tpu.ops import fsa as jfsa
from reverb_tpu_torch.models import ctc as tctc
from reverb_tpu_torch.models import ctl as tctl
from reverb_tpu_torch.ops import fsa as tfsa
from reverb_tpu_torch.utils import common as tcommon
from test_k2_lfmmi import _brute_force_den, _rand_logp
from torch_families import (ENC, V, assert_metrics_close, batch,
                            both_bundles, grads_close, jax_loss_and_grads,
                            port_loss_and_grads, to_jax, to_torch)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

W = 128


def _asr_conf(kind, **model_conf):
    return {'input_dim': 80, 'output_dim': V, 'model': kind,
            'encoder': 'conformer',
            'encoder_conf': dict(ENC, output_size=W, linear_units=64,
                                 use_dynamic_chunk=True,
                                 use_dynamic_left_chunk=True),
            'decoder': 'bitransformer',
            'decoder_conf': {'attention_heads': 2, 'linear_units': 48,
                             'num_blocks': 1, 'r_num_blocks': 1,
                             'dropout_rate': 0.0,
                             'positional_dropout_rate': 0.0},
            'model_conf': {'ctc_weight': 0.3, 'reverse_weight': 0.3,
                           **model_conf}}


@pytest.mark.parametrize('raw_chunk,n_neg', [(3, 4), (2, 0)])
def test_ctl_views_and_contrastive_term_match_jax(raw_chunk, n_neg,
                                                  monkeypatch):
    """loss = loss_full + loss_chunk + ctl_weight · CTL with the same chunk
    draws (raw_chunk 3 → a 4-frame chunk, never the full context) and the
    same negatives; every term and the gradient."""
    conf = _asr_conf('ctl_model', n_negatives=n_neg, ctl_weight=0.5,
                     logit_temp=0.2)
    jb, tb = both_bundles(conf)
    b = batch(T=70, U=4)
    B, T_enc = 2, ((70 - 1) // 2 - 1) // 2
    draws = [raw_chunk, 7]
    it = iter(draws)
    monkeypatch.setattr(jax.random, 'randint',
                        lambda *a, **k: jnp.asarray(next(it)))
    neg = np.random.RandomState(1).randint(0, T_enc - 6, (B, T_enc,
                                                          max(n_neg, 1)))
    neg[0, 0, 0] = 0                 # a negative on its own positive
    jneg = jnp.asarray(neg[..., :n_neg]) if n_neg else None

    def jloss(p):
        return jctl.ctl_compute_loss(p, jb.cfg, to_jax(b),
                                     rng=jax.random.PRNGKey(0),
                                     ctl_weight=0.5, temperature=0.2,
                                     n_negatives=n_neg, neg_idxs=jneg)
    jout, jg = jax_loss_and_grads(jloss, jb.params)
    monkeypatch.setattr(tcommon, 'draw_dynamic_chunk',
                        lambda size, g, dyn_left, full=True:
                        tcommon.dynamic_chunk_from_draws(
                            size, torch.tensor(draws[0]),
                            torch.tensor(draws[1]), dyn_left, full))
    tneg = torch.from_numpy(neg[..., :n_neg]) if n_neg else None

    def port(model):
        return tctl.ctl_compute_loss(model, to_torch(b), None,
                                     ctl_weight=0.5, temperature=0.2,
                                     n_negatives=n_neg, neg_idxs=tneg)
    tout, tg = port_loss_and_grads(tb.model, port)
    assert set(tout) == set(jout)
    assert_metrics_close(tout, jout)
    # the two views differ: the chunk view saw a 4-frame chunk
    assert abs(float(tout['loss_full']) - float(tout['loss_chunk'])) > 1e-3
    assert (float(tout['loss_ctl']) > 0) == (n_neg > 0)
    grads_close(jg, tg)


def test_ctl_negatives_and_loss_pieces():
    """The port's negative draw never lands on its own position and stays
    inside the utterance; the contrastive loss against JAX's on the same
    inputs, value collisions at −inf."""
    g = torch.Generator().manual_seed(0)
    y = torch.randn(2, 12, 6, generator=g)
    lens = torch.tensor([12, 7])
    negs, idx = tctl.sample_negatives(y, 5, lens, g)
    t = torch.arange(12)[None, :, None]
    assert (idx != t).all()
    assert (idx[1] < 7).all() and (idx >= 0).all()
    x = torch.randn(2, 12, 6, generator=g)
    negs[0, 0, 3] = y[0, 3]
    mask = (torch.arange(12)[None] < lens[:, None])[:, None]
    got = tctl.ctl_contrastive_loss(x, y, negs, mask, 0.1)
    want = jctl.ctl_contrastive_loss(*(jnp.asarray(a.numpy()) for a in
                                       (x, y, negs, mask)), 0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _lfmmi_dir(tmp_path, bigram):
    d = tmp_path / 'lfmmi'
    d.mkdir()
    (d / 'tokens.txt').write_text(''.join(f't{i} {i}\n' for i in range(9))
                                  + '<sos/eos> 9\n')
    (d / 'words.txt').write_text('<eps> 0\nab 1\n')
    if bigram:
        rng = np.random.RandomState(0)
        (d / 'bigram.txt').write_text(''.join(
            f'{u} {v} {np.log(p):.6f}\n' for u in range(1, 9)
            for v, p in zip(range(1, 9), rng.dirichlet(np.ones(8)))))
    return str(d)


def test_fsa_scorers_match_jax_and_brute_force():
    """Each scorer over a batch of ragged rows against JAX's per row, and
    against enumerating every frame-label path (unigram and bigram)."""
    rng = np.random.RandomState(1)
    T, Vs, blank = 4, 4, 0
    logps = np.stack([_rand_logp(rng, T, Vs) for _ in range(3)])
    lens = np.array([4, 3, 1])
    uni = np.full((Vs,), -np.log(Vs - 1), np.float32)
    uni[blank] = tfsa.NEG_INF
    got = tfsa.dense_unigram_den_score(torch.from_numpy(logps),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(uni), blank).numpy()
    K = Vs - 1
    big = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    sos = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    tokens = np.array([1, 2, 3], np.int32)
    arcs = tfsa.bigram_den_arcs(big, blank, sos_logp=sos, tokens=tokens)
    want_arcs = jfsa.bigram_den_arcs(big, blank, sos_logp=sos, tokens=tokens)
    for a, w in zip(arcs, want_arcs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
    src, dst, lab, w, S, final = arcs
    got_b = tfsa.fsa_forward_score(
        torch.from_numpy(logps), torch.from_numpy(lens),
        *(torch.from_numpy(a).long() for a in (src, dst, lab)),
        torch.from_numpy(w), S, torch.from_numpy(final)).numpy()
    row = {int(t): i for i, t in enumerate(tokens)}

    def lm(emitted):
        s, prev = 0.0, None
        for e in emitted:
            s += sos[row[e]] if prev is None else big[row[prev], row[e]]
            prev = e
        return s
    for i in range(3):
        want_u = float(jfsa.dense_unigram_den_score(
            jnp.asarray(logps[i]), jnp.int32(lens[i]), jnp.asarray(uni),
            blank))
        want_b = float(jfsa.fsa_forward_score(
            jnp.asarray(logps[i]), jnp.int32(lens[i]),
            *(jnp.asarray(a) for a in (src, dst, lab, w)), S,
            jnp.asarray(final)))
        np.testing.assert_allclose(got[i], want_u, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_b[i], want_b, rtol=1e-5, atol=1e-5)
        n = int(lens[i])
        np.testing.assert_allclose(
            got[i], _brute_force_den(logps[i], n, blank,
                                     lambda em: -np.log(Vs - 1) * len(em)),
            atol=1e-4)
        np.testing.assert_allclose(
            got_b[i], _brute_force_den(logps[i], n, blank, lm), atol=1e-4)


@pytest.mark.parametrize('bigram', [False, True])
def test_k2_model_lfmmi_loss_and_gradient_match_jax(bigram, tmp_path):
    conf = _asr_conf('k2_model', lfmmi_dir=_lfmmi_dir(tmp_path, bigram))
    conf['encoder_conf'] = dict(conf['encoder_conf'],
                                use_dynamic_chunk=False)
    conf['output_dim'] = 10
    jb, tb = both_bundles(conf)
    b = batch(T=70, U=4)
    b['target'] = np.where(b['target'] >= 0, b['target'] % 8 + 1, -1)
    jout, jg = jax_loss_and_grads(lambda p: jb.loss_fn(p, to_jax(b), None),
                                  jb.params)
    tout, tg = port_loss_and_grads(
        tb.model, lambda m: tb.loss_fn(m, to_torch(b), None))
    assert_metrics_close(tout, jout)
    grads_close(jg, tg)


def test_ctc_numerator_of_an_impossible_row_is_optax_value():
    """A row with fewer frames than labels and repeats: optax's large
    finite loss (the port's asr_model CTC and the LF-MMI numerator take
    it), the other rows F.ctc_loss's; gradients finite and optax's."""
    rng = np.random.RandomState(0)
    B, T, Vs, L = 3, 6, 7, 5
    logits = rng.randn(B, T, Vs).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 5], [1, 1, 2, 3, 0], [2, 2, 2, 0, 0]])
    ll = np.array([5, 4, 3])
    tl = np.array([4, 6, 5])                 # row 0 has no alignment
    want = optax.ctc_loss(
        jnp.asarray(logits),
        jnp.asarray((np.arange(T)[None] >= tl[:, None]).astype(np.float32)),
        jnp.asarray(labels),
        jnp.asarray((np.arange(L)[None] >= ll[:, None]).astype(np.float32)))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tctc.ctc_per_seq(torch.log_softmax(x, -1), torch.from_numpy(tl),
                           torch.from_numpy(labels), torch.from_numpy(ll))
    assert float(want[0]) > 1e4
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    got.sum().backward()
    assert torch.isfinite(x.grad).all()
    jgrad = jax.grad(lambda z: optax.ctc_loss(
        z, jnp.asarray((np.arange(T)[None] >= tl[:, None]).astype(
            np.float32)), jnp.asarray(labels),
        jnp.asarray((np.arange(L)[None] >= ll[:, None]).astype(
            np.float32))).sum())(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy()[1:], np.asarray(jgrad)[1:],
                               atol=1e-4)
    # row 0's recursion runs at ~1e5, where an f32 spacing is ~0.008, so
    # its gradient (differences of such sums) agrees to about 1e-2 only,
    # in either package
    np.testing.assert_allclose(x.grad.numpy()[0], np.asarray(jgrad)[0],
                               atol=1e-2)
