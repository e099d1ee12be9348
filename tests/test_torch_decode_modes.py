"""Every decode mode of the PyTorch port against the JAX package, f32 on
the CPU, with the same weights (convert.state_dict_from_jax) and the same
inputs.

Module by module (the decoder's incremental step, greedy, the attention
and onmt beams, the device and host joint searches, the dense prefix-beam
entry, the non-blank filter, HLG, ffmpeg input), then end to end through
`transcribe_modes` and the `reverb` console entry on the tiny model of
tests/test_torch_slice.py, whose CTC head is reshaped like a trained one
(else both sides decode nothing).  Tokens, times and CTM/TXT bytes must be
exactly equal; scores within 1e-4 (f32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import asr_model as jam
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import asr_model as tam

from test_hlg import LEX, _logp
from test_model_forward import TINY
from test_torch_model import _config, _models
from test_torch_slice import tiny_dir  # noqa: F401 (fixture)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

TOL = 1e-4
CAT = np.array([1.0, 0.0], np.float32)
CLI_MODES = ['attention', 'ctc_greedy_search', 'ctc_prefix_beam_search',
             'attention_rescoring', 'joint_decoding',
             'onmt_attention_decoding']


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def _assert_results(got, want, scores=True, confidences=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.tokens) == list(w.tokens)
        assert g.times == w.times or (g.times is None and w.times is None) \
            or list(g.times) == list(w.times)
        assert g.nbest == w.nbest
        assert g.nbest_times == w.nbest_times
        if scores:
            _close(g.score, w.score)
            if w.nbest_scores is not None:
                _close(g.nbest_scores, w.nbest_scores)
        if confidences:
            _close(g.confidence, w.confidence)
            _close(g.tokens_confidence, w.tokens_confidence)


def _tiny_pair():
    """(JAX params, JAX cfg, port model) of tests/test_model_forward.TINY
    (V = 50) with identical weights."""
    jcfg = jam.ModelConfig.from_config(TINY)
    params = jam.init_params(jax.random.PRNGKey(0), jcfg)
    model = tam.build_model(tam.ModelConfig.from_config(TINY), 'cpu',
                            convert.state_dict_from_jax(
                                flatten_params(params)))
    return params, jcfg, model


@pytest.fixture(scope='module')
def tiny_pair():
    return _tiny_pair()


@pytest.fixture(scope='module')
def modes_dir(tiny_dir, tmp_path_factory):
    """tests/test_torch_slice.py's model directory with two changes to the
    random weights.  The decoders' output layers ×4 and the eos logit
    raised by 3, so that the attention beam ends its hypotheses and the
    length penalty changes its pick (else the random decoder runs to
    max_steps on two alternating tokens).  The CTC blank bias raised by
    0.05: that fixture sets it to a quantile of the frames' (best
    non-blank − blank) margins, which leaves the wav's repeated frames
    within 1.2e-4 of a tie, where the two packages' fbank (f64 against
    f32, 1.7e-3 apart) decides greedy's argmax."""
    import shutil
    from reverb_tpu.convert.torch_ckpt import load_npz, save_npz
    d = tmp_path_factory.mktemp('torch_modes') / 'model'
    shutil.copytree(tiny_dir, d)
    params, _ = load_npz(str(d / 'model.npz'))
    for side in ('left_decoder', 'right_decoder'):
        ol = params['decoder'][side]['output_layer']
        bias = np.asarray(ol['bias']) * 4
        bias[-1] += 3.0                       # sos/eos is the last id
        ol['weight'] = np.asarray(ol['weight']) * 4
        ol['bias'] = bias.astype(np.float32)
    params['ctc']['ctc_lo']['bias'][0] += 0.05
    save_npz(str(d / 'model.npz'), params)
    return d


@pytest.fixture(scope='module')
def mode_models(modes_dir):
    from reverb_tpu.cli.reverb import ReverbASR as JaxASR
    from reverb_tpu_torch.cli.reverb import ReverbASR as TorchASR
    cfg, ckpt = str(modes_dir / 'config.yaml'), str(modes_dir / 'model.npz')
    return JaxASR(cfg, ckpt), TorchASR(cfg, ckpt, device='cpu')


@pytest.fixture(scope='module')
def chunk(mode_models, modes_dir):
    """One chunk of the wav through the JAX encoder: (encoder_out (1,T,D),
    encoder_lens (1,), ctc log-probs (1,T,V)) as numpy."""
    from reverb_tpu.decode.api import encode_and_ctc
    ref, _ = mode_models
    feats = np.asarray(ref.compute_feats(str(modes_dir / 'a.wav')))[None]
    enc, lens, probs = encode_and_ctc(
        ref.params, ref.model_config, jnp.asarray(feats),
        jnp.asarray([feats.shape[1]]), jnp.asarray(CAT))
    return np.asarray(enc), np.asarray(lens), np.asarray(probs)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------ the decoder step ------------------------------

@pytest.mark.parametrize('lsl_decoder', [False, True])
def test_decoder_step_matches_jax_and_full_forward(lsl_decoder):
    """The incremental step at every position of a (B·N, L) token buffer
    against the JAX step on its activation cache and against the port's
    teacher-forced forward."""
    from reverb_tpu.models.decoder import decoder_forward_one_step
    params, jcfg, model = _models(_config(lsl_decoder=lsl_decoder))
    rng = np.random.RandomState(3)
    B, N, T, L = 2, 3, 13, 7
    D = jcfg.encoder.output_size
    enc = rng.randn(B, T, D).astype(np.float32)
    enc_lens = np.array([T, 9])
    buf = rng.randint(0, jcfg.vocab_size, (B * N, L)).astype(np.int32)
    buf[:, 0] = jcfg.sos
    cat = np.tile(np.array([[0.7, 0.3]], np.float32), (B * N, 1))
    mask_j = (np.arange(T)[None] < np.repeat(enc_lens, N)[:, None])[:, None]
    dec = model.decoder.left_decoder
    mask_t = _t((np.arange(T)[None] < enc_lens[:, None])[:, None])
    full = torch.log_softmax(dec(
        _t(buf).long(), torch.full((B * N,), L), dec.cross_kv(_t(enc)),
        mask_t, N, _t(cat)).float(), -1)
    cache_j = jnp.zeros((jcfg.decoder.num_blocks, B * N, L, D))
    cache_t = dec.init_cache(B * N, L, torch.float32, 'cpu')
    kv = dec.cross_kv(_t(enc))
    for i in range(L):
        want, cache_j, w_attn = decoder_forward_one_step(
            params['decoder'], jnp.asarray(np.repeat(enc, N, 0)),
            jnp.asarray(mask_j), jnp.asarray(buf), i, cache_j, jcfg.decoder,
            cat_embs=jnp.asarray(cat), return_src_attn=True)
        with torch.inference_mode():
            got, cache_t, g_attn = dec.forward_step(
                _t(buf[:, i]), torch.full((B * N,), i), cache_t, kv, mask_t,
                N, _t(cat), return_src_attn=True)
        _close(got.numpy(), np.asarray(want))
        _close(got.numpy(), full[:, i].detach().numpy())
        _close(g_attn.numpy(), np.asarray(w_attn))


# ------------------------------ greedy ------------------------------

@pytest.mark.parametrize('dense', [True, False])
def test_greedy_matches_jax(chunk, dense):
    from reverb_tpu.decode import greedy as jg
    from reverb_tpu_torch.decode import greedy as tg
    _, lens, probs = chunk
    if dense:
        want = jg.ctc_greedy_search(jnp.asarray(probs), jnp.asarray(lens))
        got = tg.ctc_greedy_search(_t(probs), _t(lens))
    else:
        top1 = np.argmax(probs, -1)
        want = jg.ctc_greedy_from_top1(jnp.asarray(top1), jnp.asarray(lens))
        got = tg.ctc_greedy_from_top1(_t(top1), _t(lens))
    assert got[0].tokens
    _assert_results(got, want, scores=False)


# ------------------------------ attention and onmt beams ------------------------------

@pytest.mark.parametrize('length_penalty', [0.0, 0.5])
def test_attention_beam_matches_jax(mode_models, chunk, length_penalty):
    from reverb_tpu.decode.attention_beam import attention_beam_search as ja
    from reverb_tpu_torch.decode.attention_beam import \
        attention_beam_search as ta
    ref, port = mode_models
    enc, lens, _ = chunk
    want = ja(ref.params, ref.model_config, jnp.asarray(enc),
              jnp.asarray(lens), 4, length_penalty, cat_embs=jnp.asarray(CAT))
    got = ta(port.model, _t(enc), _t(lens), 4, length_penalty,
             cat_embs=_t(CAT))
    assert want[0].tokens
    _assert_results(got, want)


@pytest.mark.parametrize('beta,coverage', [(0.0, 'none'), (0.3, 'wu'),
                                           (0.3, 'summary')])
def test_onmt_beam_matches_jax(mode_models, chunk, beta, coverage):
    from reverb_tpu.decode.onmt_beam import onmt_attention_decoding as jo
    from reverb_tpu_torch.decode.onmt_beam import \
        onmt_attention_decoding as to
    ref, port = mode_models
    enc, lens, _ = chunk
    kw = dict(alpha=1.0, beta=beta, length_penalty='wu' if beta else 'avg',
              coverage_penalty=coverage)
    want = jo(ref.params, ref.model_config, jnp.asarray(enc),
              jnp.asarray(lens), 4, cat_embs=jnp.asarray(CAT), **kw)
    got = to(port.model, _t(enc), _t(lens), 4, cat_embs=_t(CAT), **kw)
    assert want[0].tokens
    _assert_results(got, want)


def test_gnmt_penalties_match_jax():
    from reverb_tpu.decode import onmt_beam as jo
    from reverb_tpu_torch.decode import onmt_beam as to
    lens = np.array([0, 1, 5, 17])
    cov = np.random.RandomState(0).rand(4, 9).astype(np.float32) * 2
    for kind in ('avg', 'wu', 'none'):
        _close(to.gnmt_length_penalty(_t(lens), 0.7, kind).numpy(),
               np.asarray(jo.gnmt_length_penalty(lens, 0.7, kind)))
    for kind in ('wu', 'summary', 'none'):
        _close(to.gnmt_coverage_penalty(_t(cov), 0.4, kind).numpy(),
               np.asarray(jo.gnmt_coverage_penalty(jnp.asarray(cov), 0.4,
                                                   kind)))


# ------------------------------ joint decoding ------------------------------

@pytest.mark.parametrize('seed,ctc_w,bonus,thr', [
    (0, 0.5, 0.5, 1.0),
    (1, 0.3, 0.0, 1.0),
    (2, 0.5, 0.5, 0.9),     # blank-threshold frame skipping
    (3, 1.0, 0.2, 1.0),     # CTC-only scoring
])
def test_joint_device_matches_jax(tiny_pair, seed, ctc_w, bonus, thr):
    """The batched device search against the JAX device scan on the inputs
    of tests/test_joint_device.py."""
    from reverb_tpu.decode.joint_device import joint_decoding_device as jd
    from reverb_tpu_torch.decode.joint_device import \
        joint_decoding_device as td
    from test_joint_device import _mk_inputs
    params, jcfg, model = tiny_pair
    enc, lens, ctc = _mk_inputs(seed, 2, 14, 50, 32)
    kw = dict(ctc_weight=ctc_w, beam_size=3, pre_beam_ratio=1.5,
              length_bonus=bonus, blank_threshold=thr)
    want = jd(params, jcfg, enc, lens, ctc, **kw)
    got = td(model, _t(enc), _t(lens), _t(ctc), **kw)
    assert any(w.tokens for w in want)
    _assert_results(got, want)
    for g, w in zip(got, want):
        _close(g.tokens_confidence, w.tokens_confidence)


def test_joint_host_loop_with_lexicon_matches_jax(tiny_pair, tmp_path):
    """A lexicon sends the search to the host loop: the lexicon files read
    alike, and the constrained search decodes alike."""
    from reverb_tpu.decode import joint as jj
    from reverb_tpu_torch.decode import joint as tj
    from test_joint_device import _mk_inputs
    params, jcfg, model = tiny_pair
    pieces = {i: ('▁' if i % 3 == 1 else '') + 'abcde'[i % 5]
              for i in range(1, 49)}
    (tmp_path / 'tokens.txt').write_text(
        ''.join(f'{p} {i}\n' for i, p in pieces.items()), encoding='utf8')
    (tmp_path / 'lexicon.txt').write_text(
        'ba ▁b a\nbac ▁b a c\nd ▁d\nea ▁e a\n', encoding='utf8')
    paths = (str(tmp_path / 'lexicon.txt'), str(tmp_path / 'tokens.txt'))
    lex = tj.load_lexicon(*paths)
    assert lex == jj.load_lexicon(*paths) and lex[0] and lex[2]
    enc, lens, ctc = _mk_inputs(5, 2, 14, 50, 32)
    kw = dict(ctc_weight=0.5, beam_size=3, length_bonus=0.5,
              words=lex[0], word_prefixes=lex[1], tok_to_str=lex[2])
    want = jj.joint_decoding(params, jcfg, enc, lens, ctc, **kw)
    got = tj.joint_decoding(model, _t(enc), _t(lens), _t(ctc), **kw)
    _assert_results(got, want)
    for g, w in zip(got, want):
        _close(g.tokens_confidence, w.tokens_confidence)


def test_model_config_reads_lexicon_paths():
    conf = dict(TINY, model_conf=dict(TINY['model_conf'],
                                      lexicon_path='lex.txt',
                                      token_path='tok.txt'))
    got = tam.ModelConfig.from_config(conf)
    want = jam.ModelConfig.from_config(conf)
    assert (got.lexicon_path, got.token_path) == \
        (want.lexicon_path, want.token_path) == ('lex.txt', 'tok.txt')


# ------------------------------ prefix beam, dense entry ------------------------------

@pytest.mark.parametrize('threshold', [0.0, 0.95])
def test_dense_prefix_beam_matches_jax(chunk, threshold):
    from reverb_tpu.decode import prefix_beam as jpb
    from reverb_tpu_torch.decode import prefix_beam as tpb
    _, lens, probs = chunk
    want, _ = jpb.ctc_prefix_beam_search_raw(
        jnp.asarray(probs), jnp.asarray(lens), 6,
        blank_skip_threshold=threshold)
    got, raw = tpb.ctc_prefix_beam_search_raw(
        _t(probs), _t(lens), 6, blank_skip_threshold=threshold)
    assert len(want[0].nbest) > 1 and want[0].tokens
    _assert_results(got, want)
    assert raw[0].shape[:2] == (1, 6)


# ------------------------------ the non-blank filter ------------------------------

def test_filter_blank_embedding_matches_jax():
    rng = np.random.RandomState(4)
    B, T, D, V = 3, 11, 8, 6
    probs = rng.randn(B, T, V).astype(np.float32)
    probs[:, :, 0] += 0.8
    enc = rng.randn(B, T, D).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([11, 7, 0])[:, None])[:, None]
    jcfg = jam.ModelConfig.from_config(TINY)
    tcfg = tam.ModelConfig.from_config(TINY)
    w_out, w_mask = jam.filter_blank_embedding(
        jcfg, jnp.asarray(probs), jnp.asarray(enc), jnp.asarray(mask))
    g_out, g_mask = tam.filter_blank_embedding(tcfg, _t(probs), _t(enc),
                                               _t(mask))
    assert np.array_equal(g_mask.numpy(), np.asarray(w_mask))
    assert np.array_equal(g_out.numpy(), np.asarray(w_out))
    assert 0 < int(g_mask.sum()) < int(mask.sum())


# ------------------------------ HLG ------------------------------

def test_hlg_graphs_match_jax():
    from reverb_tpu.decode import hlg as jh
    from reverb_tpu_torch.decode import hlg as th
    for kw in ({}, {'word_scores': {'ab': 2.0}}):
        g, w = th.lexicon_graph(LEX, **kw), jh.lexicon_graph(LEX, **kw)
        assert (g.arcs, g.final, g.start) == (w.arcs, w.final, w.start)
    text = '0 1 2 0 0.5\n1 0 3 1 0.0\n0 1.5\n'
    g, w = th.Fst.from_text(text), jh.Fst.from_text(text)
    assert (g.arcs, g.final, g.start) == (w.arcs, w.final, w.start)


@pytest.mark.parametrize('spikes,T', [([(2, 1), (6, 3)], 10),
                                      ([(3, 2)], 8),
                                      ([(1, 2), (5, 1), (8, 2)], 12)])
def test_hlg_onebest_matches_jax(spikes, T):
    from reverb_tpu.decode import hlg as jh
    from reverb_tpu_torch.decode import hlg as th
    lp = _logp(spikes, T)[None]
    want = jh.hlg_onebest(lp, np.array([T]), jh.lexicon_graph(LEX))
    got = th.hlg_onebest(_t(lp), _t([T]), th.lexicon_graph(LEX))
    assert want[0].tokens
    _assert_results(got, want)


def test_hlg_rescore_matches_jax(tiny_pair):
    """The case of tests/test_hlg.py: the decoder decides between two
    acoustically tied words."""
    from reverb_tpu.decode import hlg as jh
    from reverb_tpu_torch.decode import hlg as th
    params, jcfg, model = tiny_pair
    V, T = jcfg.vocab_size, 10
    lp = np.full((T, V), -10.0, np.float32)
    lp[:, 0] = -0.05
    lp[2, :] = -10.0
    lp[2, 1] = -0.02
    lp[6, :] = -10.0
    lp[6, 2] = lp[6, 3] = -0.7
    lp = (lp - np.log(np.exp(lp).sum(-1, keepdims=True)))[None]
    enc = np.random.RandomState(0).randn(1, T, 32).astype(np.float32)
    lex = {'ab': [1, 2], 'ac': [1, 3]}
    kw = dict(lm_scale=0.5, decoder_scale=0.5, r_decoder_scale=0.3)
    want = jh.hlg_rescore(params, jcfg, lp, np.array([T]), enc,
                          np.array([T]), jh.lexicon_graph(lex),
                          cat_embs=jnp.asarray(CAT), **kw)
    got = th.hlg_rescore(model, _t(lp), _t([T]), _t(enc), _t([T]),
                         th.lexicon_graph(lex), cat_embs=_t(CAT), **kw)
    assert len(want[0].nbest) >= 2
    _assert_results(got, want)


def test_score_hyps_with_decoder_matches_jax(tiny_pair):
    from reverb_tpu.decode.rescoring import score_hyps_with_decoder as js
    from reverb_tpu_torch.decode.rescoring import \
        score_hyps_with_decoder as ts
    params, jcfg, model = tiny_pair
    enc = np.random.RandomState(1).randn(1, 9, 32).astype(np.float32)
    paths = [[3, 4, 5], [7], [], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                                  14, 15, 16, 17]]
    for p in (paths, [[]], []):
        want = js(params, jcfg, p, enc, np.array([7]),
                  cat_embs=jnp.asarray(CAT))
        got = ts(model, p, _t(enc), _t([7]), cat_embs=_t(CAT))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w)


# ------------------------------ non-WAV input ------------------------------

class _Ran:
    def __init__(self, returncode, stdout=b'', stderr=b''):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def test_ffmpeg_input_matches_jax(monkeypatch, tmp_path):
    """A non-WAV file goes through ffmpeg (stubbed: this machine has none)
    with the reference's command line plus `-ar` at the target rate (the
    reference omits it and takes any file's samples as 16 kHz); for a
    16 kHz file both give the same samples."""
    import shutil
    import subprocess
    from reverb_tpu.frontend import audio as ja
    from reverb_tpu_torch.frontend import audio as ta
    path = str(tmp_path / 'talk.mp3')
    samples = (np.sin(np.arange(1600) / 7.0) * 0.3).astype('<f4')
    calls = []

    def run(cmd, capture_output, check):
        calls.append(list(cmd))
        return _Ran(0, samples.tobytes())
    monkeypatch.setattr(shutil, 'which', lambda name: '/usr/bin/' + name)
    monkeypatch.setattr(subprocess, 'run', run)
    got = ta.load_for_asr(path)
    want = ja.load_for_asr(path)
    assert np.array_equal(got, want) and got.shape == (1600,)
    reference = ['/usr/bin/ffmpeg', '-v', 'error', '-i', path, '-f', 'f32le',
                 '-acodec', 'pcm_f32le', '-ac', '1', 'pipe:1']
    assert calls[1] == reference
    assert calls[0] == reference[:9] + ['-ar', '16000'] + reference[9:]
    # a failing ffmpeg: its stderr is the error
    monkeypatch.setattr(subprocess, 'run',
                        lambda *a, **k: _Ran(1, stderr=b'bad file'))
    with pytest.raises(ta.AudioDecodeError, match='bad file'):
        ta.load_for_asr(path)
    # no ffmpeg at all: the reference's message
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(ta.AudioDecodeError) as got_err:
        ta.load_for_asr(path)
    with pytest.raises(ja.AudioDecodeError) as want_err:
        ja.load_for_asr(path)
    assert str(got_err.value) == str(want_err.value)


# ------------------------------ decode, end to end ------------------------------

@pytest.fixture(scope='module')
def feats(mode_models, modes_dir):
    ref, _ = mode_models
    x = np.asarray(ref.compute_feats(str(modes_dir / 'a.wav')))[None]
    return x, np.array([x.shape[1]], np.int32)


def _decode_both(mode_models, feats, methods, ref_cfg=None, port_cfg=None,
                 **kw):
    from reverb_tpu.decode import api as japi
    from reverb_tpu_torch.decode import api as tapi
    ref, port = mode_models
    x, lens = feats
    saved = port.model.cfg
    if port_cfg is not None:
        port.model.cfg = port_cfg
    try:
        got = tapi.decode(port.model, methods, _t(x), _t(lens),
                          cat_embs=_t(CAT), **kw)
    finally:
        port.model.cfg = saved
    want = japi.decode(ref.params, ref_cfg or ref.model_config, methods,
                       jnp.asarray(x), jnp.asarray(lens),
                       cat_embs=jnp.asarray(CAT), **kw)
    return got, want


def test_decode_runs_every_mode_like_jax(mode_models, feats):
    """All eight modes of ALL_MODES in one call (the dense route: the
    prefix beam over the full table), hlg with a lexicon graph."""
    from reverb_tpu.decode.api import ALL_MODES as J_MODES
    from reverb_tpu.decode.hlg import lexicon_graph as jgraph
    from reverb_tpu_torch.decode.api import ALL_MODES
    from reverb_tpu_torch.decode.hlg import lexicon_graph as tgraph
    assert ALL_MODES == J_MODES
    lex = {'w1': [2], 'w2': [3, 5], 'w3': [4], 'w4': [6, 7], 'w5': [8]}
    kw = dict(beam_size=4, ctc_weight=0.5, reverse_weight=0.3,
              length_penalty=0.5, hlg_lm_scale=0.5, hlg_decoder_scale=0.5,
              hlg_r_decoder_scale=0.3)
    from reverb_tpu.decode import api as japi
    from reverb_tpu_torch.decode import api as tapi
    ref, port = mode_models
    x, lens = feats
    got = tapi.decode(port.model, list(ALL_MODES), _t(x), _t(lens),
                      cat_embs=_t(CAT), hlg_graph=tgraph(lex), **kw)
    want = japi.decode(ref.params, ref.model_config, list(ALL_MODES),
                       jnp.asarray(x), jnp.asarray(lens),
                       cat_embs=jnp.asarray(CAT), hlg_graph=jgraph(lex),
                       **kw)
    assert set(got) == set(want) == set(ALL_MODES)
    for mode in ALL_MODES:
        assert want[mode][0].nbest or want[mode][0].tokens, mode
        _assert_results(got[mode], want[mode],
                        confidences=mode == 'attention_rescoring')


@pytest.mark.parametrize('threshold', [0.0, 0.95])
def test_non_blank_embedding_rescoring_matches_jax(mode_models, feats,
                                                   threshold):
    """apply_non_blank_embedding: the rescorer sees only the non-blank
    frames (the generic route with the dense table)."""
    ref, port = mode_models
    methods = ['ctc_prefix_beam_search', 'attention_rescoring']
    got, want = _decode_both(
        mode_models, feats, methods,
        dataclasses.replace(ref.model_config, apply_non_blank_embedding=True),
        dataclasses.replace(port.model.cfg, apply_non_blank_embedding=True),
        beam_size=6, ctc_weight=0.4, reverse_weight=0.3,
        blank_skip_threshold=threshold)
    for mode in methods:
        assert want[mode][0].tokens
        _assert_results(got[mode], want[mode],
                        confidences=mode == 'attention_rescoring')


def test_decode_rejects_streaming_and_unknown_modes(mode_models, feats):
    """The chunk arguments are accepted (as in the JAX package they change
    nothing on a model without use_dynamic_chunk; the streaming cases are
    tests/test_torch_stream_api.py's); unknown modes and hlg without a
    graph are rejected."""
    from reverb_tpu_torch.decode import api as tapi
    _, port = mode_models
    x, lens = feats
    want = tapi.decode(port.model, ['attention'], _t(x), _t(lens),
                       cat_embs=_t(CAT))['attention']
    for kw in ({'decoding_chunk_size': 16}, {'num_decoding_left_chunks': 2}):
        got = tapi.decode(port.model, ['attention'], _t(x), _t(lens),
                          cat_embs=_t(CAT), **kw)['attention']
        assert [r.tokens for r in got] == [r.tokens for r in want]
    with pytest.raises(ValueError):
        tapi.decode(port.model, ['no_such_mode'], _t(x), _t(lens))
    with pytest.raises(ValueError, match='hlg_graph'):
        tapi.decode(port.model, ['hlg_onebest'], _t(x), _t(lens),
                    cat_embs=_t(CAT))


@pytest.mark.parametrize('fmt,length_penalty', [('ctm', 0.0), ('txt', 0.0),
                                                ('ctm', 0.5)])
def test_six_cli_modes_byte_identical(mode_models, modes_dir, fmt,
                                      length_penalty):
    ref, port = mode_models
    wav = str(modes_dir / 'a.wav')
    # ctc_weight 0.5: at the CLI's 0.1 the joint search keeps the empty
    # prefix with this random decoder
    want = ref.transcribe_modes(wav, CLI_MODES, format=fmt, ctc_weight=0.5,
                                length_penalty=length_penalty)
    got = port.transcribe_modes(wav, CLI_MODES, format=fmt, ctc_weight=0.5,
                                length_penalty=length_penalty)
    assert got == want
    assert all(len(out.split()) > 0 for out in want)


def test_recognize_wav_cli_modes_and_length_penalty(modes_dir, tmp_path):
    from reverb_tpu.cli import recognize_wav as jax_cli
    from reverb_tpu_torch.cli import recognize_wav as torch_cli
    modes = ['attention', 'joint_decoding']
    args = ['--audio_file', str(modes_dir / 'a.wav'), '--model',
            str(modes_dir), '--modes', *modes, '--length_penalty', '0.5',
            '--ctc_weight', '0.5']
    jax_cli.main(args + ['--result_dir', str(tmp_path / 'jax')])
    torch_cli.main(args + ['--result_dir', str(tmp_path / 'torch'),
                           '--device', 'cpu'])
    for mode in modes:
        a = (tmp_path / 'jax' / mode / 'a.ctm').read_bytes()
        b = (tmp_path / 'torch' / mode / 'a.ctm').read_bytes()
        assert a == b and a


@pytest.mark.parametrize('flags', [['--decoding_chunk_size', '16'],
                                   ['--num_decoding_left_chunks', '2'],
                                   ['--simulate_streaming']])
def test_recognize_wav_streaming_flags_raise(modes_dir, tmp_path, flags):
    """Each streaming flag is accepted and, on a model without
    use_dynamic_chunk, writes the CTM of the call without it, as the JAX
    CLI does (tests/test_torch_stream_api.py compares the flags with the
    JAX CLI)."""
    from reverb_tpu_torch.cli import recognize_wav as torch_cli
    args = ['--audio_file', str(modes_dir / 'a.wav'), '--model',
            str(modes_dir), '--modes', 'attention', '--device', 'cpu']
    torch_cli.main(args + ['--result_dir', str(tmp_path / 'plain')])
    torch_cli.main(args + ['--result_dir', str(tmp_path / 'flag'), *flags])
    a = (tmp_path / 'plain' / 'attention' / 'a.ctm').read_bytes()
    assert (tmp_path / 'flag' / 'attention' / 'a.ctm').read_bytes() == a


# ------------------------------ full dims (slow) ------------------------------

def _ctm(align, hyps, chunk: int) -> str:
    """The CTM of one chunk's hypotheses through one package's alignment
    (the ReverbASR.get_output steps, with a stub tokenizer)."""
    def id_to_token(t):
        return ('▁' if t % 3 == 0 else '') + f'p{t}'
    rows, shift = [], 0
    for hyp in hyps:
        times = hyp.times if hyp.times is not None else \
            list(range(len(hyp.tokens)))
        path = align.ctc_align(hyp.tokens, times, hyp.tokens_confidence,
                               id_to_token, 40, shift)
        rows.extend(align.hyps_to_ctm(
            'a.wav', align.adjust_model_time_offset(path, 230)))
        shift += chunk * 10
    return '\n'.join(rows)


def _ctm_identity(conf, chunk: int, seed: int = 0):
    """ctc_greedy_search and attention on one chunk of speech-like
    features through both packages, seeded weights, the CTC head shaped
    like a trained one (weight ×8, logits centred, about 75% of the frames
    blank-top): byte-identical CTM.  Returns the CTMs."""
    from reverb_tpu.decode import align as jalign
    from reverb_tpu.decode import api as japi
    from reverb_tpu.models import ctc as jctc
    from reverb_tpu_torch.decode import align as talign
    from reverb_tpu_torch.decode import api as tapi
    jcfg = jam.ModelConfig.from_config(conf)
    params = jam.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randn(1, chunk, 80) * 0.3, axis=1)
    walk -= walk.mean(axis=1, keepdims=True)
    feats = (8.0 + np.clip(walk, -6, 6) + rng.randn(1, chunk, 80) * 0.5
             ).astype(np.float32)
    lens = np.array([chunk], np.int32)
    w = np.asarray(params['ctc']['ctc_lo']['weight']) * 8
    params['ctc']['ctc_lo'] = {'weight': jnp.asarray(w),
                               'bias': jnp.zeros(w.shape[0])}
    enc, _ = jam.forward_encoder(params, jcfg, jnp.asarray(feats),
                                 jnp.asarray(lens), jnp.asarray(CAT))
    logits = np.asarray(jctc.ctc_logits(params['ctc'], enc))[0]
    bias = -logits.mean(0)
    logits = logits + bias
    # the blank bias midway between the two frame margins around the 75th
    # percentile: no frame is left tied between blank and its best token
    margin = np.sort(logits[:, 1:].max(-1) - logits[:, 0])
    k = int(0.75 * len(margin))
    bias[0] += float(margin[k - 1] + margin[k]) / 2
    params['ctc']['ctc_lo']['bias'] = jnp.asarray(bias.astype(np.float32))
    model = tam.build_model(tam.ModelConfig.from_config(conf), 'cpu',
                            convert.state_dict_from_jax(
                                flatten_params(params)))
    modes = ['ctc_greedy_search', 'attention']
    got = tapi.decode(model, modes, _t(feats), _t(lens), cat_embs=_t(CAT))
    want = japi.decode(params, jcfg, modes, jnp.asarray(feats),
                       jnp.asarray(lens), cat_embs=jnp.asarray(CAT))
    out = {}
    for mode in modes:
        out[mode] = _ctm(jalign, want[mode], chunk)
        assert _ctm(talign, got[mode], chunk) == out[mode], mode
    assert out['ctc_greedy_search']
    return out


@pytest.mark.slow
def test_full_dims_greedy_and_attention_ctm_byte_identity():
    """reverb_large dims (18-layer d=1024 LSL conformer, 6+3-layer
    bitransformer, V=10000), seeded weights, one 2051-frame chunk."""
    from reverb_tpu.models import presets
    _ctm_identity(presets.reverb_large(), 2051)
