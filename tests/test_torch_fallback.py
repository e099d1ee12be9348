"""A hypothesis longer than `max_hyp_len`: the port's `decode` takes the
uncapped tail (beam with L = T or the keep cap, rescoring fed by the beam's
device buffers, rescored nbest filled in) exactly where the JAX package's
`decode` falls from its fused program back to its generic path.

Same tiny model and wav as tests/test_torch_slice.py (the CTC head reshaped
like a trained one, so hypotheses of different lengths come out).  Tokens,
times, nbest and nbest_times must be exactly equal; scores, confidences and
nbest_scores within 1e-4 (both sides sum f32 log-probs, in another order).

The beam at K = 6 on this input sits on a near-tie: the packages' encoder
outputs differ by f32 noise (about 2e-6, CTC log-probs 1.4e-5), and on some
CPUs that noise reorders two hypotheses of the nbest (JAX's own beam, fed
the port's log-probs, returns the port's nbest).  So the comparison is
split in two, each exact: the decode tails fed ONE encoder output (JAX's),
and end to end, where the encoders must agree to 1e-4 and the port's
decode must equal JAX's decode fed the port's encoder output.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_slice import both_models, tiny_dir  # noqa: F401 (fixtures)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

MODES = ['ctc_prefix_beam_search', 'attention_rescoring']
TOL = 1e-4   # f32 sums of log-probs in another order


@pytest.fixture(scope='module')
def chunk(both_models, tiny_dir):
    """The wav's features as one (1, T, 80) chunk, and the hypothesis
    lengths of its uncapped nbest, dense and with blank-skip 0.95."""
    from reverb_tpu_torch.decode import api as tapi
    ref, port = both_models
    feats = np.array(ref.compute_feats(str(tiny_dir / 'a.wav')))
    x, lens = feats[None], np.array([feats.shape[0]], np.int32)
    plens = {}
    for threshold in (0.0, 0.95):
        out = tapi.decode(port.model, ['ctc_prefix_beam_search'],
                          torch.from_numpy(x), torch.from_numpy(lens),
                          beam_size=6, cat_embs=torch.tensor([1.0, 0.0]),
                          blank_skip_threshold=threshold)
        n = sorted(len(h) for h in out['ctc_prefix_beam_search'][0].nbest)
        assert n[0] < n[-1], n               # the nbest differs in length
        plens[threshold] = n
    return x, lens, plens


def _decode_both(both_models, x, lens, methods, monkeypatch, feed, **kw):
    """(port's decode, JAX's decode) of one chunk.  feed='jax': both tails
    take JAX's encoder output and CTC top-k; feed='port': both take the
    port's (the port's decode is then its own, end to end)."""
    import jax.numpy as jnp
    from reverb_tpu.decode import api as japi
    from reverb_tpu_torch.decode import api as tapi
    ref, port = both_models
    real_j, real_t = japi.encode_and_ctc_topk, tapi.encode_and_ctc_topk

    def jax_encode(model, feats, feats_lens, cat, k, blank_penalty=0.0,
                   decoding_chunk_size=-1):
        out = real_j(ref.params, ref.model_config,
                     jnp.asarray(feats.cpu().numpy()),
                     jnp.asarray(feats_lens.cpu().numpy()),
                     jnp.asarray(cat.cpu().numpy()), k, blank_penalty,
                     decoding_chunk_size)
        return tuple(torch.from_numpy(np.array(o)) for o in out)

    def port_encode(params, cfg, feats, feats_lens, cat, k,
                    blank_penalty=0.0, decoding_chunk_size=-1):
        with torch.inference_mode():
            out = real_t(port.model, torch.from_numpy(np.array(feats)),
                         torch.from_numpy(np.array(feats_lens)),
                         torch.from_numpy(np.array(cat)), k, blank_penalty,
                         decoding_chunk_size)
        return tuple(jnp.asarray(o.numpy()) for o in out)

    with monkeypatch.context() as mp:
        if feed == 'jax':
            mp.setattr(tapi, 'encode_and_ctc_topk', jax_encode)
        else:
            mp.setattr(japi, 'encode_and_ctc_topk', port_encode)
        want = japi.decode(ref.params, ref.model_config, methods,
                           jnp.asarray(x), jnp.asarray(lens),
                           cat_embs=jnp.asarray([1.0, 0.0]), **kw)
        got = tapi.decode(port.model, methods, torch.from_numpy(x),
                          torch.from_numpy(lens),
                          cat_embs=torch.tensor([1.0, 0.0]), **kw)
    return got, want


def _assert_encoders_agree(both_models, x, lens, k):
    """The port's encoder output, CTC top-k log-probs and blank log-probs
    within 1e-4 of JAX's on the same features."""
    import jax.numpy as jnp
    from reverb_tpu.decode import api as japi
    from reverb_tpu_torch.decode import api as tapi
    ref, port = both_models
    want = japi.encode_and_ctc_topk(ref.params, ref.model_config,
                                    jnp.asarray(x), jnp.asarray(lens),
                                    jnp.asarray([1.0, 0.0]), k)
    with torch.inference_mode():
        got = tapi.encode_and_ctc_topk(port.model, torch.from_numpy(x),
                                       torch.from_numpy(lens),
                                       torch.tensor([1.0, 0.0]), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i in (0, 2, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=0, atol=TOL)


def _assert_same(got, want, methods):
    assert set(got) == set(want) == set(methods)
    for mode in methods:
        assert len(got[mode]) == len(want[mode])
        for g, w in zip(got[mode], want[mode]):
            assert g.tokens == w.tokens and g.tokens, mode
            assert g.times == w.times, mode
            assert g.nbest == w.nbest and g.nbest, mode
            assert g.nbest_times == w.nbest_times, mode
            np.testing.assert_allclose(g.score, w.score, rtol=0, atol=TOL)
            np.testing.assert_allclose(g.nbest_scores, w.nbest_scores,
                                       rtol=0, atol=TOL)
            if mode == 'attention_rescoring':
                np.testing.assert_allclose(g.confidence, w.confidence,
                                           rtol=0, atol=TOL)
                np.testing.assert_allclose(g.tokens_confidence,
                                           w.tokens_confidence, rtol=0,
                                           atol=TOL)


# (cap: 1 or 'mid' = between the shortest and the longest hypothesis,
#  methods, reverse_weight, blank-skip threshold)
CASES = [(1, MODES, 0.0, 0.0),
         (1, MODES, 0.3, 0.95),
         ('mid', MODES, 0.3, 0.0),
         ('mid', MODES, 0.0, 0.95),
         (1, MODES[1:], 0.3, 0.0),
         ('mid', MODES[1:], 0.0, 0.95)]


@pytest.mark.parametrize('cap,methods,reverse_weight,threshold', CASES)
def test_long_hypothesis_decodes_like_jax(both_models, chunk, monkeypatch,
                                          cap, methods, reverse_weight,
                                          threshold):
    x, lens, plens = chunk
    plens = plens[threshold]
    max_hyp_len = 1 if cap == 1 else (plens[0] + plens[-1]) // 2
    assert plens[0] <= max_hyp_len < plens[-1] or cap == 1
    kw = dict(beam_size=6, ctc_weight=0.4, reverse_weight=reverse_weight,
              blank_skip_threshold=threshold, max_hyp_len=max_hyp_len)
    # the tails on one encoder output
    got, want = _decode_both(both_models, x, lens, methods, monkeypatch,
                             'jax', **kw)
    _assert_same(got, want, methods)
    # end to end: the encoders agree, and the port's decode is JAX's
    # decode of the port's encoder output
    _assert_encoders_agree(both_models, x, lens, 6)
    got, want = _decode_both(both_models, x, lens, methods, monkeypatch,
                             'port', **kw)
    _assert_same(got, want, methods)
    longest = max(len(h) for r in got[methods[-1]] for h in r.nbest)
    assert longest > max_hyp_len         # the overflow really happened


def test_cap_that_holds_every_hypothesis_keeps_the_fused_tail(both_models,
                                                              chunk,
                                                              monkeypatch):
    """No overflow: the uncapped tail is not taken."""
    from reverb_tpu_torch.decode import api as tapi
    x, lens, plens = chunk

    def boom(*a, **k):
        raise AssertionError('the uncapped tail ran')
    monkeypatch.setattr(tapi, '_decode_uncapped', boom)
    _, port = both_models
    out = tapi.decode(port.model, MODES, torch.from_numpy(x),
                      torch.from_numpy(lens), beam_size=6,
                      cat_embs=torch.tensor([1.0, 0.0]),
                      max_hyp_len=plens[0.0][-1])
    assert out['attention_rescoring'][0].tokens


def test_no_long_hypothesis_error_remains():
    import inspect
    from reverb_tpu_torch.decode import api as tapi
    src = inspect.getsource(tapi.decode)
    assert 'NotImplementedError' not in src   # every mode and argument
    assert 'longer than max_hyp_len' not in inspect.getsource(tapi)


def test_bucket_matches_jax():
    from reverb_tpu.decode import rescoring as jrs
    from reverb_tpu_torch.decode import rescoring as trs
    for n in (0, 1, 15, 16, 17, 64, 100, 511):
        assert trs._bucket(n) == jrs._bucket(n)


@pytest.mark.parametrize('fmt', ['ctm', 'txt'])
def test_long_hypothesis_output_byte_identical(both_models, tiny_dir,
                                               monkeypatch, fmt):
    """Through `ReverbASR.transcribe_modes` of both packages with a decode
    whose max_hyp_len is 1: the CTM and TXT are the same bytes."""
    from reverb_tpu.cli import reverb as jcli
    from reverb_tpu_torch.cli import reverb as tcli
    ref, port = both_models
    for cli in (jcli, tcli):
        monkeypatch.setattr(cli, 'decode_modes_fn', functools.partial(
            cli.decode_modes_fn, max_hyp_len=1))
    wav = str(tiny_dir / 'a.wav')
    want = ref.transcribe_modes(wav, MODES, format=fmt)
    got = port.transcribe_modes(wav, MODES, format=fmt)
    assert got == want
    assert all(len(out.split()) > 0 for out in want)
