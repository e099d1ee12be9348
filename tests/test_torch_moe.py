"""The MoE feed-forward of the port against the JAX package's, f32 on the
CPU: the routing (top-k expert indices exactly, ties to the lower index)
and the layer's output, then a conformer with MoE FFNs at width 128 (every
LayerNorm through the K5/K6 functions) — the encoder forward and the
hybrid loss's gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.models import encoder as jenc
from reverb_tpu.models.asr_model import _init_moe_ffn
from reverb_tpu.models.asr_model import forward_encoder as jforward_encoder
from reverb_tpu_torch.models import encoder as tenc
from torch_families import (assert_grads_close, batch, both_bundles,
                            losses_and_grads, moe_conf)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker


@pytest.mark.parametrize('E,k', [(4, 2), (8, 2), (3, 3)])
def test_moe_ffn_routing_and_output_match_jax(E, k):
    D, H = 16, 32
    cfg = jenc.EncoderConfig(output_size=D, linear_units=H, n_expert=E,
                             n_expert_per_token=k, dropout_rate=0.0,
                             positionwise_layer_type='moe')
    p = _init_moe_ffn(jax.random.PRNGKey(E), D, H, E)
    x = np.random.RandomState(E).randn(2, 9, D).astype(np.float32)
    # a seed with a margin between the k-th and (k+1)-th router logits
    router = x.reshape(-1, D) @ np.asarray(p['gate']['weight']).T
    srt = np.sort(router, -1)[:, ::-1]
    if k < E:
        assert (srt[:, k - 1] - srt[:, k]).min() > 1e-4
    want = np.asarray(jenc.moe_feed_forward(p, jnp.asarray(x), cfg))
    _, want_idx = jax.lax.top_k(jnp.asarray(router), k)
    mod = tenc.MoEFeedForward(D, H, 'swish', 0.0, E, k)
    mod.load_state_dict({
        'gate.weight': torch.from_numpy(np.asarray(p['gate']['weight'])),
        **{f'experts.{e}.{w}.{n}': torch.from_numpy(np.asarray(
            p['experts'][e][w][n])) for e in range(E)
           for w in ('w_1', 'w_2') for n in ('weight', 'bias')}})
    with torch.no_grad():
        _, idx = mod.route(torch.from_numpy(x).reshape(-1, D))
        got = mod(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_moe_router_ties_go_to_the_lower_index():
    mod = tenc.MoEFeedForward(4, 8, 'swish', 0.0, 4, 2)
    with torch.no_grad():
        mod.gate.weight.zero_()
        mod.gate.weight[2] = 1.0
        _, idx = mod.route(torch.ones(3, 4))
    # expert 2 first, then the lowest of the tied zeros
    assert idx.tolist() == [[2, 0]] * 3
    _, want = jax.lax.top_k(jnp.asarray([[0.0, 0.0, 4.0, 0.0]]), 2)
    assert np.asarray(want).tolist() == [[2, 0]]


def test_moe_conformer_forward_and_gradients_match_jax():
    jb, tb = both_bundles(moe_conf(width=128))
    lp = tb.model.encoder.encoders[0]
    assert isinstance(lp.feed_forward, tenc.MoEFeedForward)
    assert isinstance(lp.feed_forward_macaron, tenc.MoEFeedForward)
    b = batch(T=60, U=4)
    enc, mask = jforward_encoder(jb.params, jb.cfg,
                                 jnp.asarray(b['feats']),
                                 jnp.asarray(b['feats_lengths']))
    with torch.no_grad():
        got, tmask = tb.model.forward_encoder(
            torch.from_numpy(b['feats']),
            torch.from_numpy(b['feats_lengths']))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), atol=1e-4)
    jout, tout, jg, tg = losses_and_grads(jb, tb, b)
    np.testing.assert_allclose(float(tout['loss']), float(jout['loss']),
                               rtol=1e-5)
    assert_grads_close(jg, tg)
