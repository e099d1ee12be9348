"""The port's encoder and decoder options against the JAX package's, f32 on
the CPU with the same weights: the transformer encoder, the 'linear' input
layer, the abs_pos / abs_pos_whisper / no_pos encodings, plain 'selfattn'
inside the conformer block and normalize_before False (full context on a
padded batch, and chunk by chunk through the streaming caches); the
decoder's use_output_layer, normalize_before and src_attention options
(teacher-forced and one incremental step); a transformer asr_model's
training loss and gradients; the options neither package builds.  Sizes:
2 blocks, d = 32, 4 heads, V = 30."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import decoder as jdec
from reverb_tpu.models import encoder as jenc
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.models import encoder as tenc
from torch_families import assert_grads_close, both_bundles, losses_and_grads

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

V = 30
ENCODERS = {
    'transformer_abs': ('transformer', {'pos_enc_layer_type': 'abs_pos',
                                        'selfattention_layer_type':
                                            'selfattn'}),
    'transformer_linear_nopos': ('transformer', {
        'input_layer': 'linear', 'pos_enc_layer_type': 'no_pos'}),
    'conformer_selfattn_whisper_postnorm': ('conformer', {
        'selfattention_layer_type': 'selfattn',
        'pos_enc_layer_type': 'abs_pos_whisper',
        'normalize_before': False}),
    'conformer_linear_relpos': ('conformer', {'input_layer': 'linear'}),
}


def conf(name, dec=None, causal=False):
    enc_type, opts = ENCODERS[name]
    enc = {'output_size': 32, 'attention_heads': 4, 'linear_units': 48,
           'num_blocks': 2, 'dropout_rate': 0.0,
           'positional_dropout_rate': 0.0, 'cnn_module_kernel': 5,
           'causal': causal, 'activation_type': 'swish', **opts}
    return {'input_dim': 20, 'output_dim': V, 'encoder': enc_type,
            'encoder_conf': enc, 'decoder': 'bitransformer',
            'decoder_conf': dict({'attention_heads': 4, 'linear_units': 48,
                                  'num_blocks': 1, 'r_num_blocks': 1,
                                  'dropout_rate': 0.0,
                                  'positional_dropout_rate': 0.0},
                                 **(dec or {})),
            'model_conf': {'ctc_weight': 0.3, 'reverse_weight': 0.3}}


def models(c, seed=0):
    jcfg = jam.ModelConfig.from_config(c)
    p = jam.init_params(jax.random.PRNGKey(seed), jcfg)
    # an after_norm that is not the identity on normalized rows
    rng = np.random.RandomState(seed + 7)
    p['encoder']['after_norm'] = {
        k: jnp.asarray(rng.randn(32).astype(np.float32) * 0.5
                       + (k == 'weight')) for k in ('weight', 'bias')}
    tcfg = tam.ModelConfig.from_config(c)
    model = tam.build_model(tcfg, 'cpu', convert.state_dict_from_jax(
        flatten_params(p)))
    return p, jcfg, model


def feats(T=40, short=13, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, T, 20).astype(np.float32),
            np.array([T, T - short], np.int32))


@pytest.mark.parametrize('name', sorted(ENCODERS))
def test_encoder_options_match_jax(name):
    p, jcfg, model = models(conf(name))
    x, lens = feats()
    want, wmask = jam.forward_encoder(p, jcfg, jnp.asarray(x),
                                      jnp.asarray(lens))
    with torch.no_grad():
        got, gmask = model.forward_encoder(torch.from_numpy(x),
                                           torch.from_numpy(lens))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    enc = model.encoder
    if name.startswith('transformer'):
        assert isinstance(enc.encoders[0], tenc.TransformerEncoderLayer)
    if 'linear' in name:
        assert isinstance(enc.embed, tenc.LinearInput)
        assert got.shape[1] == x.shape[1]
    if 'postnorm' in name:
        # after_norm is left out (its parameters stay)
        enc.cfg = dataclasses.replace(enc.cfg, normalize_before=True)
        try:
            with torch.no_grad():
                normed = model.forward_encoder(torch.from_numpy(x),
                                               torch.from_numpy(lens))[0]
        finally:
            enc.cfg = dataclasses.replace(enc.cfg, normalize_before=False)
        assert float((normed - got).abs().max()) > 1e-2


@pytest.mark.parametrize('name,causal', [('transformer_abs', False),
                                         ('transformer_linear_nopos', False),
                                         ('conformer_selfattn_whisper_'
                                          'postnorm', True)])
def test_forward_chunk_by_chunk_matches_jax(name, causal):
    """The streaming path (caches carried chunk by chunk; plain MHA with a
    KV cache; JAX's abs_pos reads the table from row 0 in every chunk)."""
    p, jcfg, model = models(conf(name, causal=causal))
    x, _ = feats(T=67)
    x = x[:1]
    chunk, left = 4, 2
    want, _ = jenc.encoder_forward_chunk_by_chunk(
        p['encoder'], jnp.asarray(x), jcfg.encoder, chunk, left)
    with torch.no_grad():
        got, _ = model.encoder.forward_chunk_by_chunk(
            torch.from_numpy(x), chunk, left)
    assert got.shape[1] == np.asarray(want).shape[1] > 2 * chunk
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


DEC_OPTIONS = [{'use_output_layer': False}, {'normalize_before': False},
               {'src_attention': False}]


@pytest.mark.parametrize('opts', DEC_OPTIONS,
                         ids=[next(iter(o)) for o in DEC_OPTIONS])
def test_decoder_options_match_jax(opts):
    """Teacher-forced (both directions) and one incremental step of the
    left decoder, against decoder_forward and decoder_forward_one_step."""
    c = conf('transformer_abs', dec=opts)
    p, jcfg, model = models(c, seed=1)
    rng = np.random.RandomState(2)
    mem = rng.randn(2, 11, 32).astype(np.float32)
    mmask = (np.arange(11)[None] < np.array([11, 7])[:, None])[:, None]
    ys = rng.randint(1, V - 1, (2, 6)).astype(np.int64)
    ys[:, 0] = V - 1
    ylens = np.array([6, 4])
    r_ys = ys[:, ::-1].copy()
    wl, wr = jdec.decoder_forward(
        p['decoder'], jnp.asarray(mem), jnp.asarray(mmask), jnp.asarray(ys),
        jnp.asarray(ylens), jnp.asarray(r_ys), 0.3, jcfg.decoder)
    with torch.no_grad():
        gl, gr = model.decoder(torch.from_numpy(mem),
                               torch.from_numpy(mmask), torch.from_numpy(ys),
                               torch.from_numpy(ylens),
                               torch.from_numpy(r_ys), 0.3)
    width = 32 if 'use_output_layer' in opts else V
    assert gl.shape == (2, 6, width)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=0,
                               atol=1e-4)
    # one incremental step at position 3 of the left decoder
    step = 3
    cache = jnp.zeros((1, 2, 6, 32))
    buf = jnp.asarray(ys)
    for s in range(step + 1):
        wlogp, cache = jdec.decoder_forward_one_step(
            p['decoder'], jnp.asarray(mem), jnp.asarray(mmask), buf, s,
            cache, jcfg.decoder)
    left = model.decoder.left_decoder
    with torch.no_grad():
        kv = left.cross_kv(torch.from_numpy(mem))
        tcache = left.init_cache(2, 6, torch.float32, 'cpu')
        for s in range(step + 1):
            glogp, tcache = left.forward_step(
                torch.from_numpy(ys[:, s]), torch.full((2,), s), tcache, kv,
                torch.from_numpy(mmask), 1)
    np.testing.assert_allclose(glogp.numpy(), np.asarray(wlogp), rtol=0,
                               atol=1e-4)


def test_transformer_asr_model_loss_and_grads_match_jax():
    """A transformer-encoder asr_model (abs_pos, selfattn) trains as JAX's:
    the loss terms and every gradient, dropout 0."""
    c = conf('transformer_abs')
    c['input_dim'] = 80
    jb, tb = both_bundles(c)
    rng = np.random.RandomState(3)
    target = rng.randint(1, V - 2, (2, 4)).astype(np.int32)
    target[1, 3] = -1
    b = {'feats': rng.randn(2, 60, 80).astype(np.float32),
         'feats_lengths': np.array([60, 47], np.int32), 'target': target,
         'target_lengths': np.array([4, 3], np.int32)}
    jout, tout, jg, tg = losses_and_grads(jb, tb, b)
    for k in ('loss', 'loss_att', 'loss_ctc'):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert_grads_close(jg, tg)
    assert 'encoder.encoders.0.norm1.weight' in tg


@pytest.mark.parametrize('opts,error', [
    ({'input_layer': 'conv2d6'}, NotImplementedError),
    ({'input_layer': 'conv2d8'}, NotImplementedError),
    ({'pos_enc_layer_type': 'bogus'}, ValueError),
    ({'selfattention_layer_type': 'bogus'}, ValueError),
])
def test_encoder_options_neither_package_builds_raise(opts, error):
    with pytest.raises(error):
        tenc.EncoderConfig(**opts).check_supported()
    with pytest.raises(NotImplementedError, match="only 'embed'"):
        tam.build_model(tam.ModelConfig.from_config(conf(
            'transformer_abs', dec={'input_layer': 'conv1d'})), 'cpu',
            generator=torch.Generator().manual_seed(0))
