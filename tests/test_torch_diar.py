"""Diarization in the PyTorch port against the JAX package, f32 on the CPU,
with the same weights (diar/convert.py's bridge) and the same inputs.

Module by module: powerset (exact), the native sinc filters, segmentation
and embedding nets (≤ 1e-5; at 128 channels the TDNN's LayerNorms take
the K5 functions, plain on the CPU), PyanNet at full width and ResNet34
(≤ 1e-4, the bar of tests/test_diar_pyannet.py), checkpoint loading; the
host steps (windows, binarization, AHC, stitching, RTTM, word assignment,
DER, WDER: equal); then the Diarizer end to end, tiling invariance and
the CLI, whose RTTM text must equal the JAX package's.

The two packages' fbanks differ by up to 1.6e-3 (an f64 against an f32
rFFT), so the end-to-end case asserts its margin: every AHC step stays
further from the clustering threshold than ten times the measured gap
between the two packages' embeddings.
"""

import io
import wave as wavmod

import jax
import numpy as np
import pytest
import torch

from reverb_tpu.diar import models as jm
from reverb_tpu.diar import pipeline as jpl
from reverb_tpu.diar import pyannet as jp
from reverb_tpu_torch.diar import convert as tc
from reverb_tpu_torch.diar import models as tm
from reverb_tpu_torch.diar import pipeline as tpl
from reverb_tpu_torch.diar import pyannet as tp

from tests.pyannet_oracle import PyanNet as OraclePyanNet
from tests.pyannet_oracle import ResNet34 as OracleResNet34

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

SR = 16000
SEG_SMALL = dict(sinc_filters=16, lstm_hidden=16, lstm_layers=1,
                 linear_dim=16)                 # tests/test_diar.py SEG_CFG
EMB_SMALL = dict(feat_dim=80, channels=32, embed_dim=16, layers=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seg_pair(seed, **kw):
    """(JAX params, JAX cfg, port net) of the native segmentation net; the
    LSTM biases drawn too (JAX's init leaves them zero)."""
    jcfg = jm.SegmentationConfig(**kw)
    p = _np_tree(jm.init_segmentation(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    for layer in p['lstm']:
        for d in ('fwd', 'bwd'):
            layer[d]['b'] = (rng.randn(*layer[d]['b'].shape) * 0.1
                             ).astype(np.float32)
    net = tm.build_segmentation(tm.SegmentationConfig(**kw), 'cpu',
                                tc.state_dict_from_jax(p, 'segmentation'))
    return p, jcfg, net


def _emb_pair(seed, **kw):
    jcfg = jm.EmbeddingConfig(**kw)
    p = _np_tree(jm.init_embedding_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    for c in p['convs']:       # LayerNorm affine off its identity init
        c['norm']['weight'] = (1 + 0.2 * rng.randn(*c['norm']['weight'].shape)
                               ).astype(np.float32)
        c['norm']['bias'] = (0.1 * rng.randn(*c['norm']['bias'].shape)
                             ).astype(np.float32)
    net = tm.build_embedding(tm.EmbeddingConfig(**kw), 'cpu',
                             tc.state_dict_from_jax(p, 'embedding'))
    return p, jcfg, net


def _run(net, *args):
    with torch.inference_mode():
        out = net(*(torch.from_numpy(np.asarray(a)) if a is not None else None
                    for a in args))
    return out.numpy()


# ------------------------------ nets ------------------------------

@pytest.mark.parametrize('soft', [False, True])
def test_powerset_matches_jax(soft):
    rng = np.random.RandomState(0)
    probs = rng.rand(4, 50, 7).astype(np.float32)
    probs[0, :5] = probs[0, 5:10]               # repeated rows
    probs[1, 3, 2] = probs[1, 3, 4] = 2.0       # an exact tie
    want = np.asarray(jm.powerset_to_multilabel(probs, 3, 2, soft=soft))
    got = tm.powerset_to_multilabel(torch.from_numpy(probs), 3, 2,
                                    soft=soft).numpy()
    if soft:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert tm.powerset_classes(3, 2) == jm.powerset_classes(3, 2)


def test_sinc_filters_match_jax():
    p = _np_tree(jm.init_sincnet(None, 80, 251, SR))
    rng = np.random.RandomState(1)
    low = p['low_hz'] + rng.randn(80, 1).astype(np.float32) * 20
    band = p['band_hz'] * rng.uniform(0.5, 1.5, (80, 1)).astype(np.float32)
    want = np.asarray(jm.sinc_filters(low, band, 251, SR))
    got = tm.sinc_filters(torch.from_numpy(low), torch.from_numpy(band),
                          251, SR).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('kw', [SEG_SMALL, {}], ids=['small', 'full'])
def test_segmentation_matches_jax(kw):
    p, jcfg, net = _seg_pair(0, **kw)
    wave = (np.random.RandomState(2).randn(2, 2 * SR) * 0.1).astype(
        np.float32)
    want = np.asarray(jm.segmentation_forward(p, wave, jcfg))
    got = _run(net, wave)
    assert got.shape == want.shape and got.shape[2] == 7
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('channels', [32, 128])
def test_embedding_matches_jax(channels):
    """128 channels: every TDNN LayerNorm is a shape K5 takes (its plain
    version here); 32: the plain LayerNorm."""
    kw = dict(EMB_SMALL, channels=channels, layers=4)
    p, jcfg, net = _emb_pair(1, **kw)
    from reverb_tpu_torch.ops import layer_norm as ln
    x = torch.zeros(2, 64, channels)
    assert ln.eligible(x) == (channels == 128)
    rng = np.random.RandomState(3)
    feats = rng.randn(4, 70, 80).astype(np.float32)
    lens = np.array([70, 41, 5, 1])
    for ls in (lens, None):
        want = np.asarray(jm.embedding_forward(p, feats, ls, jcfg))
        got = _run(net, feats, ls)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pyannet_matches_jax_and_the_oracle():
    torch.manual_seed(0)
    ref = OraclePyanNet().eval()
    state = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    jparams = jp.convert_pyannet(state)
    net = tp.build_pyannet(tc.state_dict_from_jax(_np_tree(jparams),
                                                  'pyannet'), 'cpu')
    wave = (np.random.RandomState(4).randn(2, 2 * SR) * 0.1).astype(
        np.float32)
    want = np.asarray(jp.pyannet_forward(jparams, wave, jp.PyanNetConfig()))
    got = _run(net, wave)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the released layout loads as it is
    direct = tp.build_pyannet({k: v.clone() for k, v in
                               ref.state_dict().items()}, 'cpu')
    np.testing.assert_allclose(_run(direct, wave), want, rtol=0, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(got, ref(torch.from_numpy(wave)).numpy(),
                                   rtol=0, atol=1e-4)


def test_resnet34_matches_jax():
    torch.manual_seed(2)
    ref = OracleResNet34(feat_dim=80, m_channels=32, embed_dim=256).eval()
    with torch.no_grad():       # running statistics off their init
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    state = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    jparams = jp.convert_wespeaker_resnet34(state)
    net = tp.build_resnet34(tc.state_dict_from_jax(_np_tree(jparams),
                                                   'resnet34'), 'cpu')
    assert set(net.state_dict()) == set(ref.state_dict())
    feats = np.random.RandomState(5).randn(2, 150, 80).astype(np.float32)
    lens = np.array([150, 77])
    for ls in (None, lens):
        want = np.asarray(jp.resnet34_forward(jparams, feats, ls))
        got = _run(net, feats, ls)
        assert got.shape == want.shape == (2, 256)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_lightning_checkpoint_loads_like_the_jax_converter(tmp_path):
    torch.manual_seed(3)
    ref = OraclePyanNet()
    ckpt = tmp_path / 'seg.ckpt'
    torch.save({'state_dict': {f'model.{k}': v
                               for k, v in ref.state_dict().items()},
                'epoch': 3}, ckpt)
    net = tp.load_pyannet_checkpoint(str(ckpt), 'cpu')
    via_jax = tc.state_dict_from_jax(
        _np_tree(jp.load_pyannet_checkpoint(str(ckpt))), 'pyannet')
    got = net.state_dict()
    assert set(got) == set(via_jax) == set(ref.state_dict())
    for k, v in via_jax.items():
        if k.startswith('lstm.bias'):   # JAX keeps only their sum
            continue
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    for k in [k for k in got if k.startswith('lstm.bias_ih')]:
        hh = k.replace('bias_ih', 'bias_hh')
        torch.testing.assert_close(got[k] + got[hh], via_jax[k] + via_jax[hh],
                                   rtol=0, atol=0)


def test_weight_bridge_round_trips_the_npz(tmp_path):
    from reverb_tpu.convert.torch_ckpt import flatten_params, save_npz
    from reverb_tpu_torch.convert import load_npz
    p, _, seg = _seg_pair(4, **SEG_SMALL)
    e, _, emb = _emb_pair(5, **EMB_SMALL)
    for tree, net in ((p, seg), (e, emb)):
        want = flatten_params(tree)
        got = tc.npz_arrays(net.state_dict())
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    save_npz(str(tmp_path / 'segmentation.npz'), p, step=np.int32(7))
    flat, meta = load_npz(str(tmp_path / 'segmentation.npz'))
    assert int(meta['step']) == 7
    sd = tc.state_dict_from_jax(flat, 'segmentation')
    for k, v in seg.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match='not one of'):
        tc.state_dict_from_jax(flat, 'ecapa')


def test_forwards_pin_full_f32_convolutions():
    """TF32 off in cuDNN and cuBLAS inside every diarization forward, the
    caller's settings restored after."""
    seen = []

    def hook(mod, args, out):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
    torch.manual_seed(0)
    nets = [(_seg_pair(0, **SEG_SMALL)[2], (torch.zeros(1, SR),)),
            (_emb_pair(0, **EMB_SMALL)[2], (torch.zeros(1, 64, 80), None)),
            (tp.build_pyannet(OraclePyanNet(lstm_layers=1).state_dict(),
                              'cpu'), (torch.zeros(1, SR),)),
            (tp.build_resnet34(OracleResNet34().state_dict(), 'cpu'),
             (torch.zeros(1, 64, 80), None))]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        for net, args in nets:
            hooks = [m.register_forward_hook(hook) for m in net.modules()
                     if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d,
                                       torch.nn.LSTM, torch.nn.Linear))
                     or type(m).__name__ in ('Linear', 'LSTM')]
            with torch.inference_mode():
                net(*args)
            for h in hooks:
                h.remove()
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert len(seen) > 40 and set(seen) == {(False, False)}


def test_fbank_batch_rows_equal_the_1d_fbank_and_jax():
    from reverb_tpu.frontend import fbank as jfb
    from reverb_tpu_torch.frontend import fbank as tfb
    rng = np.random.RandomState(6)
    waves = (rng.randn(3, 16400) * 3000).astype(np.float32)
    cfg = tfb.FbankConfig()
    got = tfb.compute_fbank_batch(torch.from_numpy(waves), cfg, 101)
    assert got.shape == (3, 101, 80)
    for i in range(3):
        assert torch.equal(got[i], tfb.compute_fbank(
            torch.from_numpy(waves[i]), cfg, 101))
        want = np.asarray(jfb.compute_fbank(waves[i], jfb.FbankConfig(),
                                            n_frames=101))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=2e-3)


def test_load_audio_and_to_mono_match_jax(tmp_path):
    from reverb_tpu.frontend import audio as jau
    from reverb_tpu_torch.frontend import audio as tau
    pcm = (np.random.RandomState(7).randn(8000, 2) * 3000).astype('<i2')
    path = tmp_path / 'st.wav'
    with wavmod.open(str(path), 'wb') as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(pcm.tobytes())
    for start, end in ((None, None), (0.1, 0.5), (0.2, None)):
        (x, sr), (y, sr2) = (tau.load_audio(str(path), start, end),
                             jau.load_audio(str(path), start, end))
        assert sr == sr2 == 8000
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(tau.to_mono(x), jau.to_mono(y))
    np.testing.assert_array_equal(tau.to_mono(x[:, 0]), x[:, 0])


# ------------------------------ host steps ------------------------------

@pytest.mark.parametrize('n', [100, 160000, 160001, 16000 * 45,
                               16000 * 45 + 12345])
def test_sliding_windows_match_jax(n):
    cfg = tpl.DiarizationConfig()
    assert tpl.sliding_windows(n, SR, cfg) == jpl.sliding_windows(
        n, SR, jpl.DiarizationConfig())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_binarize_matches_jax(seed):
    rng = np.random.RandomState(seed)
    jcfg = jpl.DiarizationConfig(onset=0.5, offset=0.4,
                                 min_duration_on=0.05 * seed,
                                 min_duration_off=0.05)
    tcfg = tpl.DiarizationConfig(**jcfg.__dict__)
    act = np.repeat(rng.rand(60), rng.randint(1, 9, 60))
    assert tpl.binarize(act, 0.0169, tcfg) == jpl.binarize(act, 0.0169, jcfg)
    bin_act = (act > 0.5).astype(np.uint8)
    got = tpl.binarize_binary(bin_act, 0.0169, tcfg)
    assert got == jpl.binarize_binary(bin_act, 0.0169, jcfg)
    assert got == tpl.binarize(bin_act, 0.0169, tcfg)


@pytest.mark.parametrize('n,thr', [(12, 0.5), (25, 0.7), (40, 0.3),
                                   (9, 0.05)])
def test_ahc_matches_jax(n, thr):
    rng = np.random.RandomState(n)
    centers = rng.randn(4, 8)
    embs = centers[rng.randint(4, size=n)] + rng.randn(n, 8) * 0.3
    embs = (embs / np.linalg.norm(embs, axis=1, keepdims=True)).astype(
        np.float32)
    for max_c in (8, 2):
        np.testing.assert_array_equal(
            tpl.agglomerative_cluster(embs, thr, max_c),
            jpl.agglomerative_cluster(embs, thr, max_c))


def test_ahc_tied_case_matches_jax():
    """tests/test_diar.py:177's exactly tied similarities: the same merge
    order, hence the same labels."""
    embs = np.repeat(np.eye(3), 4, axis=0)
    v = np.array([[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0]], np.float64)
    for e in (embs, v):
        np.testing.assert_array_equal(tpl.agglomerative_cluster(e, 0.5),
                                      jpl.agglomerative_cluster(e, 0.5))
    assert len(tpl.agglomerative_cluster(np.zeros((0, 4)), 0.5)) == 0


def _segments(rng, n, n_spk, mod):
    segs, t = [], 0.0
    for _ in range(n):
        t += rng.uniform(-0.5, 1.0)
        d = rng.uniform(0.05, 3.0)
        segs.append(mod.Segment(round(max(t, 0), 3), round(max(t, 0) + d, 3),
                                f'SPEAKER_{rng.randint(n_spk):02d}'))
    return segs


@pytest.mark.parametrize('seed', [0, 1])
def test_merge_and_rttm_round_trip_match_jax(tmp_path, seed):
    rng = np.random.RandomState(seed)
    segs = _segments(rng, 40, 4, tpl)
    jsegs = [jpl.Segment(s.start, s.end, s.speaker) for s in segs]
    got, want = tpl.merge_segments(segs), jpl.merge_segments(jsegs)
    assert [(s.start, s.end, s.speaker) for s in got] == \
        [(s.start, s.end, s.speaker) for s in want]
    fa, fb = io.StringIO(), io.StringIO()
    tpl.write_rttm(fa, got, 'uri')
    jpl.write_rttm(fb, want, 'uri')
    assert fa.getvalue() == fb.getvalue()
    path = tmp_path / 'a.rttm'
    path.write_text(fa.getvalue() + 'garbage line\n')
    a, b = tpl.load_rttm(path), jpl.load_rttm(path)
    assert {k: [(s.start, s.end, s.speaker) for s in v]
            for k, v in a.items()} == \
        {k: [(s.start, s.end, s.speaker) for s in v] for k, v in b.items()}


@pytest.mark.parametrize('seed', [0, 1])
def test_assign_words_matches_jax(tmp_path, seed):
    from reverb_tpu.diar import assign as ja
    from reverb_tpu_torch.diar import assign as ta
    rng = np.random.RandomState(seed)
    segs = _segments(rng, 20, 3, tpl)
    rttm = tmp_path / 'f.rttm'
    with open(rttm, 'w') as f:
        tpl.write_rttm(f, segs, 'f')
    words = ''.join(f'f 1 {t:.2f} {rng.uniform(0.05, 0.6):.2f} w{i} 0.9\n'
                    for i, t in enumerate(np.sort(rng.uniform(0, 40, 60))))
    ctm = tmp_path / 'f.ctm'
    ctm.write_text(words)
    ta.assign_words_to_speakers(rttm, ctm, tmp_path / 't.stm')
    ja.assign_words_to_speakers(rttm, ctm, tmp_path / 'j.stm')
    assert (tmp_path / 't.stm').read_text() == \
        (tmp_path / 'j.stm').read_text()
    empty = tmp_path / 'e.rttm'
    empty.write_text('')
    ta.main([str(empty), str(ctm), str(tmp_path / 't2.stm')])
    ja.main([str(empty), str(ctm), str(tmp_path / 'j2.stm')])
    assert (tmp_path / 't2.stm').read_text() == \
        (tmp_path / 'j2.stm').read_text()


@pytest.mark.parametrize('seed,n_ref,n_hyp', [(0, 3, 4), (1, 5, 2),
                                              (2, 4, 4), (3, 1, 0)])
def test_der_matches_jax(seed, n_ref, n_hyp):
    from reverb_tpu.eval import der as jd
    from reverb_tpu_torch.eval import der as td
    rng = np.random.RandomState(seed)
    ref = [(s.start, s.end, s.speaker) for s in _segments(rng, 30, n_ref,
                                                            tpl)]
    hyp = ([(a + rng.uniform(-.3, .3), b + rng.uniform(-.3, .3),
             f'H{rng.randint(n_hyp)}') for a, b, _ in ref] if n_hyp else [])
    hyp = [(max(a, 0.0), max(b, a + 0.01), s) for a, b, s in hyp]
    for collar in (0.0, 0.25):
        assert td.der(ref, hyp, collar) == jd.der(ref, hyp, collar)
    assert td.der([], hyp) == jd.der([], hyp)


def test_der_speaker_mapping_is_exact_past_ten_speakers():
    """Where the JAX package's search is exact the totals agree (above);
    past ten speakers on both sides it goes greedy, the port stays exact:
    never a worse mapping."""
    from reverb_tpu.eval import der as jd
    from reverb_tpu_torch.eval import der as td
    rng = np.random.RandomState(9)
    cost = rng.randint(0, 20, (12, 11)).astype(np.float64)
    value = lambda pairs: sum(cost[i, j] for i, j in pairs)  # noqa: E731
    assert value(td._assignment(cost)) >= value(jd._assignment(cost))
    small = cost[:5, :4]
    assert value(td._assignment(small)) == value(jd._assignment(small))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_wder_and_wer_match_jax(tmp_path, seed):
    from reverb_tpu.eval import wder as jw
    from reverb_tpu.eval import wer as jwer
    from reverb_tpu_torch.eval import wder as tw
    from reverb_tpu_torch.eval import wer as twer
    rng = np.random.RandomState(seed)
    vocab = ['a', 'b', 'c', 'd', 'e']
    ref = [(vocab[rng.randint(5)], f'R{rng.randint(3)}') for _ in range(40)]
    hyp = [(w if rng.rand() < 0.8 else vocab[rng.randint(5)],
            f'H{rng.randint(3 + seed)}') for w, _ in ref
           if rng.rand() < 0.9]
    assert tw.wder(ref, hyp) == jw.wder(ref, hyp)
    r, h = [w for w, _ in ref], [w for w, _ in hyp]
    assert twer.align_words(r, h) == jwer.align_words(r, h)
    assert twer.score_pair(' '.join(r), ' '.join(h)) == \
        jwer.score_pair(' '.join(r), ' '.join(h))
    for name, words in (('ref', ref), ('hyp', hyp)):
        (tmp_path / f'{name}.stm').write_text(''.join(
            f'f 1 {s} {i * 0.5:.2f} {i * 0.5 + 0.4:.2f} {w}\n'
            for i, (w, s) in enumerate(words)))
    ref_p, hyp_p = str(tmp_path / 'ref.stm'), str(tmp_path / 'hyp.stm')
    assert tw.read_stm_words(ref_p) == jw.read_stm_words(ref_p)
    assert tw.wder(tw.read_stm_words(ref_p), tw.read_stm_words(hyp_p)) == \
        jw.wder(jw.read_stm_words(ref_p), jw.read_stm_words(hyp_p))


def test_wder_main_prints_like_jax(tmp_path, capsys):
    from reverb_tpu.eval import wder as jw
    from reverb_tpu_torch.eval import wder as tw
    (tmp_path / 'r.stm').write_text('f 1 A 0.0 1.0 x y z\nf 1 B 1.0 2.0 u\n')
    (tmp_path / 'h.stm').write_text('f 1 S1 0.0 1.0 x y\nf 1 S1 1.0 2.0 u\n')
    args = [str(tmp_path / 'r.stm'), str(tmp_path / 'h.stm')]
    tw.main(args)
    got = capsys.readouterr().out
    jw.main(args)
    assert got == capsys.readouterr().out and got.startswith('WDER 0.3333')


# ------------------------------ the pipeline ------------------------------

def _wave45():
    """tests/test_diar.py:test_pipeline_tiling_invariance's 45 s wave: noise
    with a 440 Hz tone from 5 to 15 s."""
    rng = np.random.RandomState(0)
    wave = (rng.randn(SR * 45) * 0.05).astype(np.float32)
    wave[SR * 5:SR * 15] += np.sin(
        2 * np.pi * 440 * np.arange(SR * 10) / SR).astype(np.float32) * 0.3
    return wave


def _ahc_merge_sims(embs):
    """The best similarity at each step of AHC run to one cluster."""
    sims, S = [], (embs @ embs.T).astype(np.float64)
    np.fill_diagonal(S, -np.inf)
    sizes = np.ones(len(embs))
    for _ in range(len(embs) - 1):
        i, j = np.unravel_index(int(np.argmax(S)), S.shape)
        sims.append(S[i, j])
        i, j = min(i, j), max(i, j)
        row = (sizes[i] * S[i] + sizes[j] * S[j]) / (sizes[i] + sizes[j])
        S[i], S[:, i] = row, row
        S[i, i] = S[j] = S[:, j] = -np.inf
        sizes[i] += sizes[j]
    return np.array(sims)


def _ahc_margin(embs, threshold):
    """How far AHC's steps on embs stay from the merge threshold: min
    |best similarity − (1 − threshold)| over every step of the run to one
    cluster (the merges made and the one that stops it)."""
    return float(np.min(np.abs(_ahc_merge_sims(embs) - (1 - threshold))))


def _e2e_setup(diar_kw):
    """The small native nets of tests/test_diar.py on its 45 s wave, the
    random weights moved two ways so that the pipeline has something to
    decide: the classifier's bias centred on the file's frames (random
    weights put every frame in one class), and the projection's bias minus
    the mean projected statistics of the file's segments (a random TDNN
    maps every segment to cosine ≈ 1).  The clustering threshold sits in
    the middle of the widest gap between AHC's merge similarities."""
    p, jseg_cfg, _ = _seg_pair(0, **SEG_SMALL)
    e, jemb_cfg, _ = _emb_pair(1, **EMB_SMALL)
    wave = _wave45()
    wins = np.stack([wave[s:e_] for s, e_ in jpl.sliding_windows(
        len(wave), SR, jpl.DiarizationConfig())])
    lp = np.asarray(jm.segmentation_forward(p, wins, jseg_cfg))
    p['classifier']['bias'] = (p['classifier']['bias'] - (
        lp - lp.mean(-1, keepdims=True)).reshape(-1, 7).mean(0)).astype(
            np.float32)
    seg = tm.build_segmentation(tm.SegmentationConfig(**SEG_SMALL), 'cpu',
                                tc.state_dict_from_jax(p, 'segmentation'))
    emb = tm.build_embedding(tm.EmbeddingConfig(**EMB_SMALL), 'cpu',
                             tc.state_dict_from_jax(e, 'embedding'))
    stats = []
    h = emb.proj.register_forward_hook(
        lambda m, args, out: stats.append(args[0]))
    d = tpl.Diarizer(seg, emb, tpl.DiarizationConfig(**diar_kw),
                     device='cpu')
    d(wave, SR)
    h.remove()
    n_seg = len(d.last_embeddings)
    mean = torch.cat(stats)[:n_seg].mean(0).numpy()
    e['proj']['bias'] = (-(e['proj']['weight'] @ mean)).astype(np.float32)
    emb.load_state_dict(tc.state_dict_from_jax(e, 'embedding'))
    d(wave, SR)
    sims = _ahc_merge_sims(d.last_embeddings)
    k = int(np.argmax(sims[:-1] - sims[1:]))
    threshold = float(1 - (sims[k] + sims[k + 1]) / 2)
    return dict(p=p, e=e, seg=seg, emb=emb, wave=wave, wins=wins,
                cfg=dict(diar_kw, clustering_threshold=threshold),
                threshold=threshold, jseg_cfg=jseg_cfg, jemb_cfg=jemb_cfg)


@pytest.fixture(scope='module')
def e2e():
    return _e2e_setup(E2E)


E2E = dict(min_duration_on=0.1)


def _rttm(mod, segs):
    f = io.StringIO()
    mod.write_rttm(f, segs, 'x')
    return f.getvalue()


def test_diarizer_matches_jax_end_to_end(e2e, monkeypatch):
    cfg = e2e['cfg']
    td = tpl.Diarizer(e2e['seg'], e2e['emb'], tpl.DiarizationConfig(**cfg),
                      device='cpu')
    got = td(e2e['wave'], SR)
    seen = []
    ahc = jpl.agglomerative_cluster
    monkeypatch.setattr(jpl, 'agglomerative_cluster',
                        lambda x, *a: seen.append(np.asarray(x)) or ahc(x, *a))
    jd = jpl.Diarizer(e2e['p'], e2e['e'], e2e['jseg_cfg'], e2e['jemb_cfg'],
                      jpl.DiarizationConfig(**cfg))
    want = jd(e2e['wave'], SR)
    # what there was to decide: segments and speakers
    assert len(td.last_embeddings) >= 50 and len({s.speaker for s in got}) >= 2
    assert set(td.last_phases) == set(jd.last_phases)
    # the segmentation reads the same samples in both packages: its hard
    # activity is held frame by frame (the log-probs within 1e-5)
    lp_t = _run(e2e['seg'], e2e['wins'])
    lp_j = np.asarray(jm.segmentation_forward(e2e['p'], e2e['wins'],
                                              e2e['jseg_cfg']))
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tm.powerset_to_multilabel(torch.from_numpy(np.exp(lp_t))).numpy(),
        np.asarray(jm.powerset_to_multilabel(np.exp(lp_j))))
    # the embeddings read each package's own fbank: every AHC step stays
    # further from the threshold than ten times their gap
    emb_gap = float(np.abs(td.last_embeddings - seen[0]).max())
    assert 0 < emb_gap < 1e-2
    assert _ahc_margin(td.last_embeddings, e2e['threshold']) > 10 * emb_gap
    assert _rttm(tpl, got) == _rttm(jpl, want)


def test_diarizer_tiling_invariance(e2e):
    """Tiny tiles (2 windows, 2 crops) against the default ones: the same
    segments, embeddings within 1e-5 (tests/test_diar.py's JAX check)."""
    cfg = tpl.DiarizationConfig(**e2e['cfg'])
    outs = []
    for seg_tile, emb_tile in [(2, 2), (512, 128)]:
        d = tpl.Diarizer(e2e['seg'], e2e['emb'], cfg, device='cpu')
        d.SEG_TILE, d.EMB_TILE = seg_tile, emb_tile
        outs.append((_rttm(tpl, d(e2e['wave'], SR)), d.last_embeddings))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=0, atol=1e-5)


def test_diarizer_silence_and_a_short_file():
    seg = _seg_pair(0, **SEG_SMALL)[2]
    emb = _emb_pair(1, **EMB_SMALL)[2]
    with torch.no_grad():
        seg.classifier.bias[0] = 1e3          # every frame silent
    d = tpl.Diarizer(seg, emb, device='cpu')
    assert d(np.zeros(3 * SR, np.float32)) == []
    assert set(d.last_phases) == {'segmentation_ms', 'binarize_ms'}
    d.warm_buckets(buckets=(64, 128))


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from reverb_tpu_torch.bin.infer_diarization import main
    seg = _seg_pair(0, **SEG_SMALL)[2]
    emb = _emb_pair(1, **EMB_SMALL)[2]
    with pytest.raises(RuntimeError, match='cuda'):
        tpl.Diarizer(seg, emb)
    with pytest.raises(RuntimeError, match='cuda'):
        main([str(tmp_path / 'a.wav'), '--out-dir', str(tmp_path)])


def _write_wav(path, seconds, seed):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.RandomState(seed)
    sig = 0.2 * np.sin(2 * np.pi * 220 * t) * (t < seconds / 2) \
        + 0.2 * np.sin(2 * np.pi * 330 * t) * (t >= seconds / 2) \
        + 0.02 * rng.randn(t.size)
    with wavmod.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype('<i2').tobytes())


def test_cli_model_dir_matches_jax(tmp_path, monkeypatch):
    """--model-dir with the JAX package's segmentation.npz/embedding.npz at
    the default (full) widths.  reverb_tpu's load_npz leaves `lstm` and
    `convs` as dicts of '0', '1', … (its _LIST_KEYS lacks them), so its CLI
    fails on such a directory; the JAX run here listifies them first."""
    from reverb_tpu.bin import infer_diarization as jcli
    from reverb_tpu.convert import torch_ckpt
    from reverb_tpu.convert.torch_ckpt import save_npz
    from reverb_tpu_torch.bin.infer_diarization import main
    p = _np_tree(jm.init_segmentation(jax.random.PRNGKey(0)))
    e = _np_tree(jm.init_embedding_model(jax.random.PRNGKey(1)))
    mdir = tmp_path / 'model'
    mdir.mkdir()
    save_npz(str(mdir / 'segmentation.npz'), p)
    save_npz(str(mdir / 'embedding.npz'), e)
    _write_wav(tmp_path / 'a.wav', 12, 0)
    main([str(tmp_path / 'a.wav'), '--out-dir', str(tmp_path / 't'),
          '--model-dir', str(mdir), '--device', 'cpu'])
    load = torch_ckpt.load_npz

    def listified(path):
        tree, meta = load(path)
        for k in ('lstm', 'convs'):
            if k in tree:
                tree[k] = [tree[k][str(i)] for i in range(len(tree[k]))]
        return tree, meta
    monkeypatch.setattr(torch_ckpt, 'load_npz', listified)
    jcli.main([str(tmp_path / 'a.wav'), '--out-dir', str(tmp_path / 'j'),
               '--model-dir', str(mdir)])
    got = (tmp_path / 't' / 'a.rttm').read_text()
    assert got and got == (tmp_path / 'j' / 'a.rttm').read_text()


def test_cli_pyannote_checkpoints_match_jax(tmp_path):
    from reverb_tpu.bin import infer_diarization as jcli
    from reverb_tpu_torch.bin.infer_diarization import main
    torch.manual_seed(3)
    seg = OraclePyanNet()
    with torch.no_grad():       # every frame speech, the argmax well apart
        seg.classifier.bias.copy_(torch.tensor([-9., 3, 0, 0, 0, 0, 0]))
    ckpt = tmp_path / 'seg.ckpt'
    torch.save({'state_dict': {f'model.{k}': v
                               for k, v in seg.state_dict().items()}}, ckpt)
    emb_pt = tmp_path / 'emb.pt'
    torch.save(OracleResNet34().state_dict(), emb_pt)
    _write_wav(tmp_path / 'b.wav', 3, 1)
    flags = ['--segmentation-ckpt', str(ckpt), '--embedding-ckpt',
             str(emb_pt)]
    main([str(tmp_path / 'b.wav'), '--out-dir', str(tmp_path / 't'),
          '--device', 'cpu'] + flags)
    jcli.main([str(tmp_path / 'b.wav'), '--out-dir', str(tmp_path / 'j')]
              + flags)
    got = (tmp_path / 't' / 'b.rttm').read_text()
    assert got.startswith('SPEAKER b 1 ')
    assert got == (tmp_path / 'j' / 'b.rttm').read_text()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
def test_card_diarizer_matches_the_cpu(cuda, e2e):
    """The same Diarizer on the card (K5 in the TDNN at 128 channels would
    launch; these 32-channel nets take the plain LayerNorm) and on the
    CPU: the same RTTM, embeddings within 1e-4."""
    cfg = tpl.DiarizationConfig(**e2e['cfg'])
    cpu = tpl.Diarizer(e2e['seg'], e2e['emb'], cfg, device='cpu')
    want = _rttm(tpl, cpu(e2e['wave'], SR))
    seg = tm.build_segmentation(tm.SegmentationConfig(**SEG_SMALL), cuda,
                                e2e['seg'].state_dict())
    emb = tm.build_embedding(tm.EmbeddingConfig(**EMB_SMALL), cuda,
                             e2e['emb'].state_dict())
    card = tpl.Diarizer(seg, emb, cfg, device=cuda)
    assert _rttm(tpl, card(e2e['wave'], SR)) == want
    np.testing.assert_allclose(card.last_embeddings, cpu.last_embeddings,
                               rtol=0, atol=1e-4)
