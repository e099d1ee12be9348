"""Diarization training in the port against the JAX package, f32 on CPU,
same weights (diar/convert.py) and inputs: the segmentation loss (powerset
CE + 0.5 · VAD BCE, the native net and PyanNet through `forward=`), the
AM-softmax embedding loss with JAX's head, and one step of each trainer
(Adam after global-norm clipping) — all within 1e-5.  The TDNN is 128
channels wide, so its LayerNorms take the K5/K6 functions (their plain
versions on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.diar import train_embedding as jte
from reverb_tpu.diar import train_segmentation as jts
from reverb_tpu_torch.diar import convert as tc
from reverb_tpu_torch.diar import pyannet as tp
from reverb_tpu_torch.diar import train_embedding as tte
from reverb_tpu_torch.diar import train_segmentation as tts
from test_torch_diar import SEG_SMALL, _emb_pair, _np_tree, _seg_pair

from tests.pyannet_oracle import PyanNet as OraclePyanNet

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

EMB_128 = dict(feat_dim=80, channels=128, embed_dim=16, layers=4)


def _seg_data(seed, B=2, S=16000, T=None, C=7):
    rng = np.random.RandomState(seed)
    wave = (rng.randn(B, S) * 0.1).astype(np.float32)
    T = T or 60
    labels = np.eye(C, dtype=np.float32)[rng.randint(0, C, (B, T))]
    return wave, labels


def _emb_data(seed, B=6, T=50, S=4):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, 80).astype(np.float32)
    lens = np.array([T, T - 7, T - 20, T, T - 3, T - 11][:B], np.int32)
    labels = rng.randint(0, S, B).astype(np.int32)
    return feats, lens, labels


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close_state(net, jtree, kind, tol=1e-5):
    want = tc.state_dict_from_jax(_np_tree(jtree), kind)
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def test_segmentation_loss_matches_jax():
    """The loss and its parts on the native net and on PyanNet (through
    forward=, as the JAX trainer fine-tunes a converted checkpoint)."""
    p, jcfg, net = _seg_pair(3, **SEG_SMALL)
    wave, labels = _seg_data(0, T=70)          # longer labels: truncated
    want, jaux = jax.jit(lambda q: jts.segmentation_loss(
        q, jnp.asarray(wave), jnp.asarray(labels), jcfg))(p)
    got, aux = tts.segmentation_loss(net, *_t(wave, labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ('ce', 'vad_bce'):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    # forward= (how a PyanNet is fine-tuned): both losses on the port
    # PyanNet's log-probabilities (its forward is held to JAX's in
    # tests/test_torch_diar.py)
    torch.manual_seed(0)
    pyan = tp.build_pyannet({k: v.clone() for k, v in
                             OraclePyanNet().state_dict().items()}, 'cpu')
    wave, labels = _seg_data(1, S=32000, T=110)
    with torch.no_grad():
        logp = pyan(torch.from_numpy(wave)).numpy()
    want, _ = jts.segmentation_loss(None, jnp.asarray(wave),
                                    jnp.asarray(labels), jcfg,
                                    forward=lambda q, w: jnp.asarray(logp))
    with torch.no_grad():
        got, _ = tts.segmentation_loss(None, *_t(wave, labels), forward=pyan)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize('margin', [0.0, 0.2])
def test_embedding_loss_matches_jax(margin):
    """AM-softmax CE and accuracy with the same head, with and without
    the margin, and the gradient of every weight and of the head (within
    1e-5 of each tensor's largest gradient)."""
    p, jcfg, net = _emb_pair(4, **EMB_128)
    feats, lens, labels = _emb_data(0)
    head = (np.random.RandomState(2).randn(4, 16) * 0.1).astype(np.float32)

    def loss(q, h):
        return jte.embedding_loss(q, {'weight': h}, jnp.asarray(feats),
                                  jnp.asarray(lens), jnp.asarray(labels),
                                  jcfg, margin=margin)
    (want, jaux), (jg, jgh) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(p, jnp.asarray(head))
    th = torch.from_numpy(head).requires_grad_(True)
    net.requires_grad_(True)
    got, aux = tte.embedding_loss(net, th, *_t(feats, lens, labels),
                                  margin=margin)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(aux['acc']) == float(jaux['acc'])
    got.backward()
    want_g = tc.state_dict_from_jax(_np_tree(jg), 'embedding')
    pairs = [(n, q.grad.numpy(), want_g[n].numpy())
             for n, q in net.named_parameters()]
    pairs.append(('head', th.grad.numpy(), np.asarray(jgh)))
    for n, a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=n)


def test_one_segmentation_step_matches_jax():
    """train_segmentation for one epoch of one batch (Adam, clip 0.5):
    the weights within 1e-5 of JAX's; the LSTM's bias_hh stays zero."""
    p, jcfg, net = _seg_pair(5, **SEG_SMALL)
    wave, labels = _seg_data(2)
    want = jts.train_segmentation(
        p, lambda: [(wave, labels)], cfg=jcfg, lr=1e-3, max_epochs=1)
    tts.train_segmentation(net, lambda: [_t(wave, labels)], lr=1e-3,
                           max_epochs=1)
    _close_state(net, want, 'segmentation')
    assert not net.training and not any(
        q.requires_grad for q in net.parameters())
    assert all(not v.any() for k, v in net.state_dict().items()
               if 'bias_hh' in k)


def test_one_embedding_step_matches_jax():
    """train_embedding for one epoch of one batch with JAX's head (drawn
    from PRNGKey(seed)): the weights within 1e-5 of JAX's; by default the
    head comes from a torch.Generator of the seed.  lr 1e-4: Adam's first
    step moves each element by about lr whatever its gradient's size, so an
    element whose gradient sits at the f32 noise floor (a cancelling sum
    over the batch's frames) moves by a different share of lr in each
    package; at lr 1e-4 that share stays under the bar (the gradients
    themselves are held in test_embedding_loss_matches_jax)."""
    p, jcfg, net = _emb_pair(6, **EMB_128)
    batches = [_emb_data(3)]
    head = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (4, 16),
                                        jnp.float32) * 0.1)
    want = jte.train_embedding(p, 4, lambda: batches, cfg=jcfg, lr=1e-4,
                               max_epochs=1, seed=9, margin=0.2)
    tte.train_embedding(net, 4, lambda: [_t(*b) for b in batches], lr=1e-4,
                        max_epochs=1, margin=0.2,
                        head=torch.from_numpy(np.array(head)))
    _close_state(net, want, 'embedding')
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tte.train_embedding(net, 4, lambda: [_t(*batches[0])], max_epochs=1)
    assert any(not torch.equal(v, before[k])
               for k, v in net.state_dict().items())
