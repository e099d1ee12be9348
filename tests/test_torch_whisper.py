"""The port's Whisper family against the JAX package's, f32 on the CPU at
width 128 (every LayerNorm through the K5/K6 functions), 2 + 2 layers, a
small vocabulary, on carried weights: the encoder and the decoder; greedy
decoding (tokens equal to JAX's static-buffer loop and to the naive
grow-the-buffer loop, with the top-2 margin of every decoded step above
the logit error); both converters on synthetic HuggingFace and WeNet
state dicts; the registry bundle's loss on both target routes, its
gradient and one Adam step; `add_whisper_tokens`; and the gated
`load_hf_whisper` (no download: a missing transformers is simulated)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import whisper as jw
from reverb_tpu.utils import common as jcommon
from reverb_tpu_torch.models import whisper as tw
from reverb_tpu_torch.utils import common as tcommon
from torch_families import (adam_step_both, assert_metrics_close,
                            both_bundles, grads_close, jax_loss_and_grads,
                            port_loss_and_grads, to_jax, to_torch)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

V = 60
WCONF = {'n_mels': 16, 'n_audio_state': 128, 'n_audio_head': 2,
         'n_audio_layer': 2, 'n_vocab': V, 'n_audio_ctx': 40,
         'n_text_ctx': 24, 'n_text_state': 128, 'n_text_head': 2,
         'n_text_layer': 2}
CONF = {'model': 'whisper', 'whisper_conf': WCONF,
        'optim_conf': {'lr': 1e-3, 'eps': 1e-3},
        'scheduler_conf': {'warmup_steps': 1}}


def _mel(B=2, T=30, seed=0):
    return np.random.RandomState(seed).randn(B, T, 16).astype(np.float32)


@pytest.fixture(scope='module')
def pair():
    return both_bundles(CONF, seed=3)


def test_encode_and_decode_match_jax(pair):
    jb, tb = pair
    mel = _mel()
    want = jw.whisper_encode(jb.params['encoder'], jnp.asarray(mel), jb.cfg)
    with torch.no_grad():
        got = tw.whisper_encode(tb.model, torch.from_numpy(mel))
    assert got.shape == want.shape == (2, 15, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    toks = np.random.RandomState(1).randint(0, V, (2, 7)).astype(np.int32)
    want_l = jw.whisper_decode(jb.params['decoder'], jnp.asarray(toks), want,
                               jb.cfg)
    with torch.no_grad():
        got_l = tw.whisper_decode(tb.model, torch.from_numpy(toks),
                                  torch.from_numpy(np.asarray(want)))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-4)


def test_greedy_tokens_equal_jax(pair):
    jb, tb = pair
    mel = _mel(seed=2)
    sot, eot = [1, 2, 3, 4], 0
    want = jw.whisper_greedy_decode(jb.params, jnp.asarray(mel), jb.cfg, sot,
                                    eot, max_len=8)
    got = tw.whisper_greedy_decode(tb.model, torch.from_numpy(mel), sot, eot,
                                   max_len=8)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the naive loop, and the margin of every step over the runner-up
    feats = jw.whisper_encode(jb.params['encoder'], jnp.asarray(mel), jb.cfg)
    toks = np.tile(np.asarray(sot, np.int32)[None], (2, 1))
    finished = np.zeros((2,), bool)
    for _ in range(8):
        logits = np.asarray(jw.whisper_decode(jb.params['decoder'],
                                              jnp.asarray(toks), feats,
                                              jb.cfg))[:, -1]
        top2 = np.sort(logits, -1)[:, -2:]
        assert (top2[~finished, 1] - top2[~finished, 0] > 1e-3).all()
        nxt = np.where(finished, eot, logits.argmax(-1)).astype(np.int32)
        toks = np.concatenate([toks, nxt[:, None]], 1)
        finished |= nxt == eot
        if finished.all():
            break
    ref = toks[:, len(sot):]
    np.testing.assert_array_equal(got[:, :ref.shape[1]], ref)
    assert (got[:, ref.shape[1]:] == eot).all()


def _hf_state(d=128, n_mels=16, vocab=V, rows=40):
    g = torch.Generator().manual_seed(0)
    state = {}

    def lin(prefix, bias=True, shape=(d, d)):
        state[f'{prefix}.weight'] = torch.randn(*shape, generator=g) * 0.05
        if bias:
            state[f'{prefix}.bias'] = torch.randn(shape[0], generator=g) * .05

    def ln(prefix):
        state[f'{prefix}.weight'] = 1 + 0.1 * torch.randn(d, generator=g)
        state[f'{prefix}.bias'] = 0.1 * torch.randn(d, generator=g)

    lin('model.encoder.conv1', shape=(d, n_mels, 3))
    lin('model.encoder.conv2', shape=(d, d, 3))
    state['model.encoder.embed_positions.weight'] = torch.randn(
        rows, d, generator=g)
    for side, n in (('encoder', 2), ('decoder', 1)):
        for i in range(n):
            p = f'model.{side}.layers.{i}'
            attns = ('self_attn',) + (('encoder_attn',) if side == 'decoder'
                                      else ())
            for a in attns:
                for name in ('q_proj', 'v_proj', 'out_proj'):
                    lin(f'{p}.{a}.{name}')
                lin(f'{p}.{a}.k_proj', bias=False)
                ln(f'{p}.{a}_layer_norm')
            lin(f'{p}.fc1', shape=(4 * d, d))
            lin(f'{p}.fc2', shape=(d, 4 * d))
            ln(f'{p}.final_layer_norm')
        ln(f'model.{side}.layer_norm')
    state['model.decoder.embed_tokens.weight'] = torch.randn(
        vocab, d, generator=g)
    state['model.decoder.embed_positions.weight'] = torch.randn(
        24, d, generator=g) * 0.01
    return {k: v.numpy() for k, v in state.items()}


def _wenet_state(untied: bool, d=128, vocab=V):
    g = torch.Generator().manual_seed(1)
    state = {}

    def lin(prefix, bias=True, shape=(d, d)):
        state[f'{prefix}.weight'] = torch.randn(*shape, generator=g) * 0.05
        if bias:
            state[f'{prefix}.bias'] = torch.randn(shape[0], generator=g) * .05

    lin('encoder.embed.conv.0', shape=(d, 16, 3))
    lin('encoder.embed.conv.2', shape=(d, d, 3))
    state['encoder.embed.pos_enc.pe'] = torch.randn(1, 40, d, generator=g)
    for i in range(2):
        p = f'encoder.encoders.{i}'
        for n in ('linear_q', 'linear_v', 'linear_out'):
            lin(f'{p}.self_attn.{n}')
        lin(f'{p}.self_attn.linear_k', bias=False)
        lin(f'{p}.feed_forward.w_1', shape=(4 * d, d))
        lin(f'{p}.feed_forward.w_2', shape=(d, 4 * d))
        lin(f'{p}.norm1', shape=(d,))
        lin(f'{p}.norm2', shape=(d,))
    lin('encoder.after_norm', shape=(d,))
    p = 'decoder.decoders.0'
    for a in ('self_attn', 'src_attn'):
        for n in ('linear_q', 'linear_v', 'linear_out'):
            lin(f'{p}.{a}.{n}')
        lin(f'{p}.{a}.linear_k', bias=False)
    lin(f'{p}.feed_forward.w_1', shape=(4 * d, d))
    lin(f'{p}.feed_forward.w_2', shape=(d, 4 * d))
    for n in ('norm1', 'norm2', 'norm3'):
        lin(f'{p}.{n}', shape=(d,))
    lin('decoder.after_norm', shape=(d,))
    state['decoder.embed.0.weight'] = torch.randn(vocab, d, generator=g)
    state['decoder.embed.1.pe'] = torch.randn(1, 24, d, generator=g) * 0.01
    state['decoder.output_layer.weight'] = (
        torch.randn(vocab, d, generator=g) if untied
        else state['decoder.embed.0.weight'].clone())
    if untied:
        state['decoder.output_layer.bias'] = torch.randn(vocab, generator=g)
    return {k: v.numpy() for k, v in state.items()}


@pytest.mark.parametrize('kind', ['hf', 'wenet_tied', 'wenet_untied'])
def test_converters_match_jax(kind):
    """Each converter gives JAX's tree leaf for leaf; the model built from
    it encodes and decodes as JAX's does on it."""
    if kind == 'hf':
        state = _hf_state()
        want = jw.convert_hf_whisper(state)
        got = tw.convert_hf_whisper(state)
        n_dec = 1
    else:
        state = _wenet_state(kind == 'wenet_untied')
        want = jw.convert_wenet_whisper(state)
        got = tw.convert_wenet_whisper(state)
        n_dec = 1
        assert ('output_layer' in want['decoder']) == (kind == 'wenet_untied')
    flat = flatten_params(want)
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    cfg = tw.WhisperConfig(**dict(WCONF, n_text_layer=n_dec))
    jcfg = jw.WhisperConfig(**dict(WCONF, n_text_layer=n_dec))
    model = tw.build_whisper(cfg, got, 'cpu')
    mel = _mel(seed=5)
    enc = jw.whisper_encode(want['encoder'], jnp.asarray(mel), jcfg)
    toks = np.random.RandomState(6).randint(0, V, (2, 5)).astype(np.int32)
    logits = jw.whisper_decode(want['decoder'], jnp.asarray(toks), enc, jcfg)
    with torch.no_grad():
        genc = model.encoder(torch.from_numpy(mel))
        glog = model.decoder(torch.from_numpy(toks), genc)
    np.testing.assert_allclose(genc.numpy(), np.asarray(enc), atol=1e-4)
    np.testing.assert_allclose(glog.numpy(), np.asarray(logits), atol=1e-4)


@pytest.mark.parametrize('route', ['target', 'ys_in'])
def test_bundle_loss_gradient_and_step_match_jax(pair, route):
    jb, tb = pair
    rng = np.random.RandomState(7)
    b = {'feats': _mel(seed=8), 'feats_lengths': np.array([30, 30],
                                                           np.int32)}
    if route == 'target':
        tgt = rng.randint(1, V, (2, 6)).astype(np.int32)
        tgt[1, 4:] = -1
        b.update(target=tgt, target_lengths=np.array([6, 4], np.int32))
    else:
        sp = {'sot': 50, 'eot': 49, 'transcribe': 58, 'translate': 57,
              'no_speech': 56, 'no_timestamps': 59}
        ys = rng.randint(1, 40, (2, 5)).astype(np.int32)
        ys[0, 3:] = -1
        ys_in, ys_out = tcommon.add_whisper_tokens(
            sp, ys, -1, ['transcribe', 'vad'], ['en', 'en'])
        b.update(ys_in=ys_in, ys_out=ys_out)
    jout, jg = jax_loss_and_grads(lambda p: jb.loss_fn(p, to_jax(b), None),
                                  jb.params)
    tout, tg = port_loss_and_grads(
        tb.model, lambda m: tb.loss_fn(m, to_torch(b), None))
    assert_metrics_close(tout, jout)
    grads_close(jg, tg)
    state = {k: v.clone() for k, v in tb.model.state_dict().items()}
    new_j, new_t = adam_step_both(CONF, jb.params, jg, tb.model, tg)
    for k, v in new_t.items():
        np.testing.assert_allclose(v, np.asarray(new_j[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    tb.model.load_state_dict(state)          # the fixture's weights back


def test_add_whisper_tokens_matches_jax():
    sp = {'sot': 50, 'eot': 49, 'transcribe': 58, 'translate': 57,
          'no_speech': 56, 'no_timestamps': 59}
    ys = np.array([[3, 4, 5, -1], [6, -1, -1, -1], [7, 8, 9, 10]])
    args = (sp, ys, -1, ['transcribe', 'translate', 'vad'],
            ['en', 'de', 'su'])
    for got, want in zip(tcommon.add_whisper_tokens(*args),
                         jcommon.add_whisper_tokens(*args)):
        np.testing.assert_array_equal(got, want)
    assert tcommon.WHISPER_LANGS == jcommon.WHISPER_LANGS
    for bad in (dict(no_timestamp=False), {}):
        kw = dict(bad)
        tasks = ['transcribe'] if bad else ['sing']
        with pytest.raises(NotImplementedError):
            tcommon.add_whisper_tokens(sp, ys[:1], -1, tasks, ['en'], **kw)
        with pytest.raises(NotImplementedError):
            jcommon.add_whisper_tokens(sp, ys[:1], -1, tasks, ['en'], **kw)


def test_load_hf_whisper_needs_transformers(monkeypatch):
    """Without transformers the loader raises a clear ImportError (a
    missing package simulated; nothing is downloaded)."""
    monkeypatch.setitem(sys.modules, 'transformers', None)
    with pytest.raises(ImportError, match='transformers'):
        tw.load_hf_whisper()
