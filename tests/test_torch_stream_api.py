"""The streaming entry points of the PyTorch port against the JAX package on
the same tiny model directory (f32, CPU): StreamingASR, MultiStreamASR
(staggered join, reset_slot, trimmed buffers), `decode` with the chunk
arguments and the CLI's chunk flags.

The model is the tiny test model widened to 128 (every LayerNorm through
the K5 functions) with its CTC head shaped like a trained one, as
tests/test_torch_slice.py does (flat random logits decode nothing).  The
two packages' fbanks differ by up to 1.6e-3 (an f64 against an f32 rFFT),
so each comparison runs twice: on features computed once and given to
both, and end to end from the audio.  Tokens, times and nbest must be
equal, scores within 1e-4.
"""

import numpy as np
import pytest
import torch
import yaml

from helpers import build_tiny_model_dir

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

MODES = ['ctc_prefix_beam_search', 'attention_rescoring']
STREAM_MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
                'attention_rescoring']


def _audio(seconds, seed):
    """Speech-like float samples in [-1, 1): harmonic bursts and noise."""
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    env = np.repeat(rng.rand(n // 1600 + 1), 1600)[:n]
    f0 = np.repeat(rng.uniform(90, 250, n // 3200 + 1), 3200)[:n]
    x = (np.sin(2 * np.pi * f0 * t) + 0.3 * rng.randn(n)) * env * 0.2
    return x.astype(np.float32)


def _write_wav(path, samples):
    import wave
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((samples * 32767).astype(np.int16).tobytes())
    return path


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    """The tiny model at width 128, its CTC head sharpened on the test
    audio, and a copy of it whose config sets use_dynamic_chunk."""
    import jax
    import jax.numpy as jnp
    from reverb_tpu.cli.reverb import ReverbASR
    from reverb_tpu.convert.torch_ckpt import save_npz
    from reverb_tpu.decode.api import encode_and_ctc
    from reverb_tpu.models import ctc as ctc_mod
    from reverb_tpu.models.asr_model import ModelConfig, init_params

    d = build_tiny_model_dir(tmp_path_factory.mktemp('stream_api'))
    conf = yaml.safe_load((d / 'config.yaml').read_text())
    conf['encoder_conf'].update(output_size=128, attention_heads=2,
                                linear_units=128)
    conf['decoder_conf'].update(linear_units=128)
    (d / 'config.yaml').write_text(yaml.safe_dump(conf))
    params = init_params(jax.random.PRNGKey(0),
                         ModelConfig.from_config(conf))
    save_npz(str(d / 'model.npz'), params)
    wav = _write_wav(d / 'a.wav', _audio(4.0, 0))
    ref = ReverbASR(str(d / 'config.yaml'), str(d / 'model.npz'))
    feats = np.asarray(ref.compute_feats(str(wav)))
    w = np.asarray(params['ctc']['ctc_lo']['weight']) * 8
    probe = dict(ref.params)
    probe['ctc'] = {'ctc_lo': {'weight': jnp.asarray(w),
                               'bias': jnp.zeros(w.shape[0])}}
    enc, lens, _ = encode_and_ctc(probe, ref.model_config,
                                  jnp.asarray(feats[None]),
                                  jnp.asarray([feats.shape[0]]),
                                  jnp.asarray([1.0, 0.0]))
    logits = np.asarray(ctc_mod.ctc_logits(probe['ctc'], enc))[0][
        :int(lens[0])]
    bias = -logits.mean(0)
    logits = logits + bias
    bias[0] += float(np.quantile(logits[:, 1:].max(-1) - logits[:, 0], 0.6))
    params['ctc']['ctc_lo'] = {'weight': w, 'bias': bias.astype(np.float32)}
    save_npz(str(d / 'model.npz'), params)
    dyn = d.parent / 'dynamic'
    dyn.mkdir()
    for f in d.iterdir():
        if f.is_file():
            (dyn / f.name).write_bytes(f.read_bytes())
    conf['encoder_conf']['use_dynamic_chunk'] = True
    (dyn / 'config.yaml').write_text(yaml.safe_dump(conf))
    return d, dyn


@pytest.fixture(scope='module')
def models(model_dir):
    from reverb_tpu.cli.reverb import load_model as jload
    from reverb_tpu_torch.cli.reverb import load_model as tload
    d, _ = model_dir
    return jload(str(d)), tload(str(d), device='cpu')


def _same(got, want, what):
    assert got.tokens == want.tokens, what
    assert got.times == want.times, what
    assert got.nbest == want.nbest, what
    assert got.nbest_times == want.nbest_times, what
    for a, b in ((got.score, want.score),
                 (got.nbest_scores, want.nbest_scores)):
        if b is None:
            assert a is None, what
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=what)


def _feed_features(js, ts, feats):
    """Give both streams the same fbank frames (bypassing their fbanks)."""
    js._feat_buf = np.concatenate([js._feat_buf, feats])
    js._advance()
    ts._feat = torch.cat([ts._feat, torch.from_numpy(feats)])
    ts._n_feats += feats.shape[0]
    ts._advance()


@pytest.mark.parametrize('route', ['features', 'audio'])
def test_streaming_asr_matches_jax(models, route):
    """Hop by hop (chunk 4, 4 left chunks, beam 4): the encoder chunks within
    1e-4, greedy, the carried prefix beam and attention_rescoring equal;
    at the end also a from-scratch beam of another width; the port holds
    only the samples and frames a later window reads."""
    from reverb_tpu.cli.model import StreamingASR as JaxStream
    from reverb_tpu_torch.cli.model import StreamingASR as TorchStream
    from reverb_tpu_torch.frontend.fbank import compute_fbank
    jm, tm = models
    js = JaxStream(jm, decoding_chunk_size=4, num_left_chunks=4, beam_size=4)
    ts = TorchStream(tm, decoding_chunk_size=4, num_left_chunks=4,
                     beam_size=4)
    audio = _audio(3.2, 1)
    assert ts.decode().tokens == [] == js.decode().tokens
    feats = compute_fbank(torch.from_numpy(audio * 32768), tm.fbank).numpy()
    step, pieces, hops = 53, 0, 0
    while True:
        if route == 'features':
            lo = pieces * step
            if lo >= feats.shape[0]:
                break
            _feed_features(js, ts, feats[lo:lo + step])
        else:
            lo = pieces * 3200
            if lo >= len(audio):
                break
            js.accept_waveform(audio[lo:lo + 3200])
            ts.accept_waveform(audio[lo:lo + 3200])
            assert len(ts._pcm) < 400 and ts._feat.shape[0] < ts.window
        pieces += 1
        assert len(ts._enc_chunks) == len(js._enc_chunks)
        if len(ts._enc_chunks) == hops:
            continue
        hops = len(ts._enc_chunks)
        np.testing.assert_allclose(torch.cat(ts._enc_chunks).numpy(),
                                   np.concatenate(js._enc_chunks), atol=1e-4)
        for m in STREAM_MODES:
            _same(ts.decode(m), js.decode(m), (route, hops, m))
    assert hops >= 8 and ts.decode('ctc_prefix_beam_search').tokens
    for m in MODES:
        _same(ts.decode(m, beam_size=3), js.decode(m, beam_size=3),
              (route, 'beam 3', m))
    assert isinstance(ts.text(), str)
    ts.reset()
    assert ts.decode().tokens == [] and ts._offset == 0


@pytest.mark.parametrize('route', ['features', 'audio'])
def test_multi_stream_pool_matches_jax(models, route):
    """Three slots (chunk 4, 4 left chunks, beam 4): slot 2 joins three
    rounds late, slot 0 is reset midway and takes a new stream.  After every
    round each slot's greedy and prefix results equal the JAX pool's, and at
    the end attention_rescoring too.  The port's slots hold only what a
    later window reads; the JAX pool's keep every sample."""
    from reverb_tpu.cli.stream_pool import MultiStreamASR as JaxPool
    from reverb_tpu_torch.cli.stream_pool import MultiStreamASR as TorchPool
    from reverb_tpu_torch.frontend.fbank import compute_fbank
    jm, tm = models
    B, rounds, late, reset_at = 3, 10, 3, 5
    jp = JaxPool(jm, B, 4, 4, beam_size=4, keep_encoder_out=True)
    tp = TorchPool(tm, B, 4, 4, beam_size=4, keep_encoder_out=True)
    audio = [_audio(rounds * 0.2, 10 + b) for b in range(B)]
    audio.append(_audio(rounds * 0.2, 20))       # slot 0's second stream
    feats = [compute_fbank(torch.from_numpy(a * 32768), tm.fbank).numpy()
             for a in audio]
    for r in range(rounds):
        if r == reset_at:
            jp.reset_slot(0)
            tp.reset_slot(0)
        for b in range(B):
            i = r - (late if b == 2 else 0) - (reset_at if b == 0 and
                                                r >= reset_at else 0)
            src = 3 if b == 0 and r >= reset_at else b
            if i < 0:
                continue
            if route == 'features':
                f = feats[src][i * 20:(i + 1) * 20]
                jp._feat[b] = np.concatenate([jp._feat[b], f])
                tp._feat[b] = torch.cat([tp._feat[b], torch.from_numpy(f)])
                tp._n_feats[b] += f.shape[0]
            else:
                piece = audio[src][i * 3200:(i + 1) * 3200]
                jp.accept_waveform(b, piece)
                tp.accept_waveform(b, piece)
        while True:
            jr, tr = jp.step(), tp.step()
            assert (jr == tr).all(), r
            if not tr.any():
                break
        for b in range(B):
            for m in ('ctc_greedy_search', 'ctc_prefix_beam_search'):
                _same(tp.decode(b, m), jp.decode(b, m), (route, r, b, m))
            samples, frames = tp.buffered(b)
            assert samples < 400 + 3200 and frames <= tp.window
    for b in range(B):
        assert tp.decode(b).tokens
        _same(tp.decode(b, 'attention_rescoring'),
              jp.decode(b, 'attention_rescoring'), (route, b, 'rescoring'))
    if route == 'audio':
        # the reference fault the port repairs: its buffers grow for good
        assert len(jp._pcm[1]) == len(audio[1])
        assert tp.buffered(1)[0] < 400


def _decode_both(model_dir, dynamic, **kw):
    """decode() of the JAX package and of the port on one 2051-frame chunk
    of the test audio."""
    import jax.numpy as jnp
    from reverb_tpu.cli.reverb import ReverbASR as JaxASR
    from reverb_tpu.decode.api import decode as jdecode
    from reverb_tpu_torch.cli.reverb import ReverbASR as TorchASR
    from reverb_tpu_torch.decode.api import decode as tdecode
    d = model_dir[1] if dynamic else model_dir[0]
    cfg, ckpt = str(d / 'config.yaml'), str(d / 'model.npz')
    jm, tm = JaxASR(cfg, ckpt), TorchASR(cfg, ckpt, device='cpu')
    assert tm.model.cfg.encoder.use_dynamic_chunk == dynamic
    feats = tm.compute_feats(str(d / 'a.wav'))[None]
    lens = torch.tensor([feats.shape[1]])
    cat = np.array([1.0, 0.0], np.float32)
    modes = ['ctc_greedy_search'] + MODES
    want = jdecode(jm.params, jm.model_config, modes,
                   jnp.asarray(feats.numpy()), jnp.asarray(lens.numpy()),
                   ctc_weight=0.1, cat_embs=cat, **kw)
    got = tdecode(tm.model, modes, feats, lens, ctc_weight=0.1,
                  cat_embs=torch.from_numpy(cat), **kw)
    return got, want, tm, feats, lens, cat


@pytest.mark.parametrize('dynamic,kw', [
    (True, {'decoding_chunk_size': 4}),
    (True, {'decoding_chunk_size': 16, 'num_decoding_left_chunks': 1}),
    (True, {}),
    (False, {'decoding_chunk_size': 16, 'num_decoding_left_chunks': 4})])
def test_decode_with_chunk_arguments_matches_jax(model_dir, dynamic, kw):
    """decode() hands decoding_chunk_size to the encoder as the JAX package
    does (a chunk mask on a use_dynamic_chunk model, nothing otherwise) and,
    like it, does not use num_decoding_left_chunks."""
    from reverb_tpu_torch.decode.api import decode as tdecode
    got, want, tm, feats, lens, cat = _decode_both(model_dir, dynamic, **kw)
    for m in want:
        for g, w in zip(got[m], want[m]):
            _same(g, w, (dynamic, kw, m))
    assert got['ctc_prefix_beam_search'][0].tokens
    if not dynamic or kw.get('decoding_chunk_size', -1) < 0:
        # no chunk mask: the same output as decoding without the arguments
        plain = tdecode(tm.model, list(got), feats, lens, ctc_weight=0.1,
                        cat_embs=torch.from_numpy(cat))
        for m in got:
            assert [r.tokens for r in plain[m]] == \
                [r.tokens for r in got[m]]


@pytest.mark.parametrize('dynamic', [False, True])
def test_recognize_wav_chunk_flags_match_jax(model_dir, tmp_path, dynamic):
    """The console entry with --decoding_chunk_size 4
    --num_decoding_left_chunks 2 --simulate_streaming writes the JAX CLI's
    CTM bytes; on the model without use_dynamic_chunk the same bytes as
    without the flags."""
    from reverb_tpu.cli import recognize_wav as jax_cli
    from reverb_tpu_torch.cli import recognize_wav as torch_cli
    d = model_dir[1] if dynamic else model_dir[0]
    base = ['--audio_file', str(d / 'a.wav'), '--model', str(d), '--modes',
            *MODES]
    flags = ['--decoding_chunk_size', '4', '--num_decoding_left_chunks', '2',
             '--simulate_streaming']
    jax_cli.main(base + flags + ['--result_dir', str(tmp_path / 'jax')])
    torch_cli.main(base + flags + ['--result_dir', str(tmp_path / 'torch'),
                                   '--device', 'cpu'])
    torch_cli.main(base + ['--result_dir', str(tmp_path / 'plain'),
                           '--device', 'cpu'])
    for mode in MODES:
        a = (tmp_path / 'jax' / mode / 'a.ctm').read_bytes()
        b = (tmp_path / 'torch' / mode / 'a.ctm').read_bytes()
        assert a == b and a
        if not dynamic:
            assert (tmp_path / 'plain' / mode / 'a.ctm').read_bytes() == b


def test_transcribe_modes_accepts_simulate_streaming(models, model_dir):
    """simulate_streaming is accepted and, as in the JAX package, changes
    nothing."""
    _, tm = models
    wav = str(model_dir[0] / 'a.wav')
    assert tm.transcribe_modes(wav, MODES, format='txt',
                               simulate_streaming=True) == \
        tm.transcribe_modes(wav, MODES, format='txt')


@pytest.mark.parametrize('fmt', ['ctm', 'txt'])
def test_transcribe_modes_chunk_arguments_match_jax(model_dir, fmt):
    """transcribe_modes with every streaming argument on the
    use_dynamic_chunk copy: the JAX package's bytes, CTM and TXT."""
    from reverb_tpu.cli.reverb import load_model as jload
    from reverb_tpu_torch.cli.reverb import load_model as tload
    d = model_dir[1]
    kw = {'decoding_chunk_size': 4, 'num_decoding_left_chunks': 2,
          'simulate_streaming': True}
    wav = str(d / 'a.wav')
    want = jload(str(d)).transcribe_modes(wav, MODES, format=fmt, **kw)
    got = tload(str(d), device='cpu').transcribe_modes(wav, MODES,
                                                       format=fmt, **kw)
    assert got == want and all(want)
