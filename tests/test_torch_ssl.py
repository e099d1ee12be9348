"""The port's self-supervised objectives against the JAX package's, f32 on
the CPU at width 128 (every LayerNorm through the K5/K6 functions), 2
conformer layers: BEST-RQ, wav2vec 2.0 and w2v-BERT on carried weights.
torch cannot reproduce jax.random, so each test computes JAX's draws with
the JAX package's own functions and feeds them to both sides (BEST-RQ's
loss takes no injection in JAX: the test rebuilds its rng split).  Each
loss, its gradient and one optimizer step (AdamW for BEST-RQ, whose
frozen random quantizer has a zero gradient and moves by weight decay
alone, as optax moves it) are held to JAX's; the port's own draws are
checked for their support."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.models import ssl as jssl
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import ssl as tssl
from reverb_tpu_torch.models.modules import Linear
from torch_families import (ENC, adam_step_both, assert_metrics_close,
                            batch, both_bundles, grads_close,
                            jax_loss_and_grads, port_loss_and_grads, to_jax,
                            to_torch)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

V = 50
W = 128
SSL_ENC = dict(ENC, output_size=W, attention_heads=2, linear_units=64)
W2V = {'codebook_size': 16, 'num_negatives': 5, 'mask_prob': 0.2,
       'mask_length': 3, 'diversity_weight': 0.1}


def ssl_conf(kind, **extra):
    conf = {'input_dim': 80, 'output_dim': V, 'model': kind,
            'encoder': 'conformer', 'encoder_conf': SSL_ENC,
            'decoder': 'transformer',
            'decoder_conf': {'attention_heads': 2, 'linear_units': 48,
                             'num_blocks': 1, 'dropout_rate': 0.0,
                             'positional_dropout_rate': 0.0},
            'optim': 'adamw',
            'optim_conf': {'lr': 1e-3, 'eps': 1e-3, 'weight_decay': 0.01},
            'scheduler_conf': {'warmup_steps': 1}}
    conf.update(extra)
    return conf


def _bestrq_conf():
    return ssl_conf('bestrq', bestrq_conf={
        'codebook_size': 64, 'mask_prob': 0.15, 'mask_length': 6})


def test_bestrq_loss_gradient_and_adamw_step_match_jax():
    conf = _bestrq_conf()
    jb, tb = both_bundles(conf)
    bcfg = jb.cfg[1]
    b = batch(T=90, U=3)
    rng = jax.random.PRNGKey(11)
    # the JAX loss's own split, rebuilt
    k1, k2 = jax.random.split(rng)
    B, T, F = b['feats'].shape
    mask = np.asarray(jssl.make_mask(k1, B, T, bcfg))
    noise = np.asarray(jax.random.normal(k2, (1, 1, F)) * 0.1)
    assert mask.any() and not mask.all()

    jout, jg = jax_loss_and_grads(
        lambda p: jb.loss_fn(p, to_jax(b), rng), jb.params)
    tbatch = to_torch(b)

    def port(model):
        return tssl.bestrq_loss(model, tbatch['feats'],
                                tbatch['feats_lengths'], tb.cfg[1],
                                mask=torch.from_numpy(mask),
                                noise=torch.from_numpy(noise))
    tout, tg = port_loss_and_grads(tb.model, port)
    assert int(tout['num_masked']) == int(jout['num_masked']) > 0
    assert_metrics_close(tout, jout)
    grads_close(jg, tg)
    # the random quantizer takes no gradient in either package
    for k in ('projection', 'codebook'):
        assert not np.asarray(jg[k]).any() and not tg[k].any()
    # the code ids are JAX's
    np.testing.assert_array_equal(
        tssl.bestrq_targets(tb.model, tbatch['feats'], tb.cfg[1]).numpy(),
        np.asarray(jssl.bestrq_targets(jb.params, jnp.asarray(b['feats']),
                                       bcfg)))
    new_j, new_t = adam_step_both(conf, jb.params, jg, tb.model, tg)
    for k, v in new_t.items():
        np.testing.assert_allclose(v, np.asarray(new_j[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
    # AdamW moves the zero-gradient quantizer by its decay, as optax does
    assert not np.array_equal(new_t['projection'],
                              np.asarray(jb.params['projection']))


def test_bestrq_helpers_match_jax():
    """stack_features, subsampled_mask and the span mask's shape of
    support (JAX's make_mask on its draws against the port's on the same
    starts)."""
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 37, 5).astype(np.float32)
    for size, step in ((7, 4), (1, 1), (3, 2)):
        np.testing.assert_array_equal(
            tssl.stack_features(torch.from_numpy(feats), size, step).numpy(),
            np.asarray(jssl.stack_features(jnp.asarray(feats), size, step)))
        m = rng.rand(2, 37) < 0.6
        np.testing.assert_array_equal(
            tssl.subsampled_mask(torch.from_numpy(m), size, step).numpy(),
            np.asarray(jssl.subsampled_mask(jnp.asarray(m), size, step)))
    # the port's span mask is the union of mask_length spans from its
    # starts, as JAX's (draws from the generator)
    g = torch.Generator().manual_seed(0)
    got = tssl.make_mask(3, 40, 0.1, 4, g, 'cpu').numpy()
    starts = (torch.rand((3, 40), generator=torch.Generator().manual_seed(0))
              < 0.1).numpy()
    want = np.zeros_like(got)
    for b_, t in zip(*np.nonzero(starts)):
        want[b_, t:t + 4] = True
    np.testing.assert_array_equal(got, want)


def _wav2vec2_draws(jb, b, cfg, seed, w2vbert=False):
    """JAX's draws for the wav2vec2 / w2v-BERT losses, made by the JAX
    package's functions: span mask (within the valid frames), negatives
    from it, gumbels (and w2v-BERT's mask noise)."""
    from reverb_tpu.models.asr_model import _get_cmvn
    params = jb.params
    ecfg = jb.cfg[0].encoder
    xs, _, masks = jssl.ssl_subsample(params['encoder'],
                                      jnp.asarray(b['feats']),
                                      jnp.asarray(b['feats_lengths']), ecfg,
                                      cmvn=_get_cmvn(params))
    B, Tz, D = xs.shape
    valid = masks[:, 0, :]
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    span = jssl.make_mask(ks[0], B, Tz, jssl.BestRQConfig(
        mask_prob=cfg.mask_prob, mask_length=cfg.mask_length)) & valid
    neg = jssl.sample_negative_indices(ks[1], span, cfg.num_negatives)
    u = jax.random.uniform(ks[2], (B, Tz, cfg.num_codebooks,
                                   cfg.codebook_size),
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    draws = {'span_mask': span, 'neg_pos': neg,
             'gumbels': -jnp.log(-jnp.log(u))}
    if w2vbert:
        draws['mask_noise'] = jax.random.normal(ks[3], (B, Tz, D)) * 0.1
    assert bool(span.any())
    return draws


@pytest.mark.parametrize('kind', ['wav2vec2', 'w2vbert'])
def test_wav2vec2_and_w2vbert_match_jax(kind):
    """The loss and every reported term, the gradient and one Adam step
    with JAX's draws injected into both."""
    from reverb_tpu.models.asr_model import _get_cmvn
    extra = {'wav2vec2_conf': W2V}
    if kind == 'w2vbert':
        extra['w2vbert_conf'] = {'warmup_steps': 10}
    conf = ssl_conf(kind, optim='adam', optim_conf={'lr': 1e-3, 'eps': 1e-3},
                    **extra)
    jb, tb = both_bundles(conf)
    b = batch(T=90, U=3, seed=4)
    wcfg = jb.cfg[1]
    draws = _wav2vec2_draws(jb, b, wcfg, 5, kind == 'w2vbert')
    jbatch = to_jax(b)
    ecfg = jb.cfg[0].encoder

    def jloss(p):
        kw = dict(steps=3, cmvn=_get_cmvn(p), **draws)
        if kind == 'wav2vec2':
            return jssl.wav2vec2_loss(p, p['encoder'], jbatch['feats'],
                                      jbatch['feats_lengths'],
                                      jax.random.PRNGKey(0), wcfg, ecfg, **kw)
        return jssl.w2vbert_loss(p, p['encoder'], jbatch['feats'],
                                 jbatch['feats_lengths'],
                                 jax.random.PRNGKey(0), wcfg, jb.cfg[2],
                                 ecfg, **kw)
    jout, jg = jax_loss_and_grads(jloss, jb.params)
    tbatch = to_torch(b)
    tdraws = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
    tdraws['neg_pos'] = tdraws['neg_pos'].long()

    def port(model):
        if kind == 'wav2vec2':
            return tssl.wav2vec2_loss(model, tbatch['feats'],
                                      tbatch['feats_lengths'], tb.cfg[1], 3,
                                      **tdraws)
        return tssl.w2vbert_loss(model, tbatch['feats'],
                                 tbatch['feats_lengths'], tb.cfg[1],
                                 tb.cfg[2], 3, **tdraws)
    tout, tg = port_loss_and_grads(tb.model, port)
    assert set(tout) == set(jout)
    assert_metrics_close(tout, jout)
    grads_close(jg, tg)
    new_j, new_t = adam_step_both(conf, jb.params, jg, tb.model, tg)
    for k, v in new_t.items():
        np.testing.assert_allclose(v, np.asarray(new_j[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_ssl_draws_and_quantizer_pieces():
    """The port's own draws: negatives from the masked frames of the same
    utterance, never the anchor's own ordinal; gumbel quantizer and
    contrastive loss against JAX's on the same inputs; the bundles' losses
    finite from the generator's draws, the gumbel temperature at its
    maximum without `steps`."""
    rng = np.random.RandomState(2)
    span = rng.rand(3, 30) < 0.4
    span[2] = False
    span[2, :2] = True
    neg = tssl.sample_negative_indices(
        torch.from_numpy(span), 6, torch.Generator().manual_seed(0)).numpy()
    for b_ in range(3):
        masked = set(np.nonzero(span[b_])[0])
        for t in np.nonzero(span[b_])[0]:
            assert set(neg[b_, t]) <= masked
            if len(masked) > 1:
                assert t not in set(neg[b_, t])
    cfg = jssl.Wav2vec2Config(encoder_output_size=8, num_codebooks=2,
                              codebook_size=5, embedding_dim=8)
    params = jssl.init_wav2vec2(jax.random.PRNGKey(1), cfg)
    x = rng.randn(2, 9, 8).astype(np.float32)
    valid = np.ones((2, 9), bool)
    valid[1, 7:] = False
    g = rng.gumbel(size=(2, 9, 2, 5)).astype(np.float32)
    want = jssl.gumbel_quantize(params, jnp.asarray(x), jnp.asarray(valid),
                                None, 0.7, cfg, gumbels=jnp.asarray(g))
    holder = torch.nn.Module()
    holder.vq_proj = Linear(8, 10)
    holder.vq_codebook = torch.nn.Parameter(torch.from_numpy(np.asarray(
        params['vq_codebook'])))
    with torch.no_grad():
        holder.vq_proj.weight.copy_(torch.from_numpy(np.asarray(
            params['vq_proj']['weight'])))
        holder.vq_proj.bias.copy_(torch.from_numpy(np.asarray(
            params['vq_proj']['bias'])))
    got = tssl.gumbel_quantize(holder, torch.from_numpy(x),
                               torch.from_numpy(valid), 0.7,
                               tssl.Wav2vec2Config(**vars(cfg)),
                               gumbels=torch.from_numpy(g))
    for a, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    negp = rng.randint(0, 9, (2, 9, 4))
    negp[0, 0] = 0          # a negative equal to its positive
    sm = rng.rand(2, 9) < 0.5
    np.testing.assert_allclose(
        float(tssl.contrastive_loss(got[0].detach(), torch.from_numpy(x),
                                    torch.from_numpy(negp),
                                    torch.from_numpy(sm), 0.1)),
        float(jssl.contrastive_loss(want[0], jnp.asarray(x),
                                    jnp.asarray(negp), jnp.asarray(sm),
                                    0.1)), rtol=1e-5)
    assert tssl.gumbel_temperature(tssl.Wav2vec2Config(), 0) == 2.0
    for kind in ('bestrq', 'wav2vec2', 'w2vbert'):
        conf = (_bestrq_conf() if kind == 'bestrq'
                else ssl_conf(kind, wav2vec2_conf=W2V))
        tb = both_bundles(conf)[1]
        out = tb.loss_fn(tb.model, to_torch(batch(T=90, U=3)),
                         torch.Generator().manual_seed(1))
        assert np.isfinite(float(out['loss']))


def test_ssl_bundles_build_like_jax():
    """init_model builds the three families from a config alone, with the
    JAX tree's leaves."""
    from reverb_tpu.convert.torch_ckpt import flatten_params
    from reverb_tpu_torch import init_model as tinit
    for conf in (_bestrq_conf(), ssl_conf('wav2vec2', wav2vec2_conf=W2V),
                 ssl_conf('w2vbert', wav2vec2_conf=W2V)):
        want = flatten_params(jinit(conf, jax.random.PRNGKey(0)).params)
        got = tinit(conf, torch.Generator().manual_seed(0), 'cpu')
        flat = convert.flat_from_state_dict(got.model.state_dict())
        assert set(flat) == set(want)
        for k, v in want.items():
            assert flat[k].shape == np.asarray(v).shape, k
