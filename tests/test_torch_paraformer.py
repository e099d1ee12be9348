"""The port's Paraformer family against the JAX package's, f32 on the CPU
with the same weights and inputs: the tokenizer; the CIF head (`cif_fire`
with its exact fire count, a fire landing exactly on the threshold and an
overflowing buffer; `cif_fires`, the tp peaks, the tail); both searches
(tokens, confidences, times and beam indices exactly, with ties);
timestamps and beautify; `transcribe --paraformer -t` end to end from a
`.npz` and from a `.pt`; both training bundles' losses and gradients
(sampler off, dropout 0), the glancing sampler's structure, and two steps
of `bin.train` on a tiny corpus for each encoder.  Sizes: 2 + 2 blocks,
d = 32, V = 40."""

import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from reverb_tpu.convert.torch_ckpt import flatten_params, save_npz
from reverb_tpu.decode import paraformer_search as jsearch
from reverb_tpu.models import paraformer as jpara
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu.text import paraformer_tokenizer as jtok
from reverb_tpu.text import tokenizer as jtokenizer
from reverb_tpu_torch import convert
from reverb_tpu_torch.decode import paraformer_search as tsearch
from reverb_tpu_torch.models import paraformer as tpara
from reverb_tpu_torch.models import registry as treg
from reverb_tpu_torch.text import paraformer_tokenizer as ttok
from reverb_tpu_torch.text import tokenizer as ttokenizer
from test_torch_sanm import sanm_conf
from torch_families import (DEC, ENC, assert_grads_close, losses_and_grads,
                            to_jax, to_torch)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

V = 40


# ------------------------------ tokenizer ------------------------------

UNITS = ['<blank>', '<s>', '</s>', '<unk>', '你', '好', '世', '界', 'he@@',
         'llo', 'world', 'a@@', 'b', "'", '1']
SEG = {'hello': 'he@@ llo', 'world': 'world', 'ab': 'a@@ b'}
LINES = ['你好 hello world 世界', 'hello foo ab', '世界你好', 'world hello',
         '  ab 你 好 world  ']


def _units(path, units):
    path.write_text(''.join(f'{u} {i}\n' for i, u in enumerate(units)))
    return path


def test_paraformer_tokenizer_matches_jax(tmp_path):
    units = _units(tmp_path / 'units.txt', UNITS)
    seg = tmp_path / 'seg_dict'
    seg.write_text(''.join(f'{k}\t{v}\n' for k, v in SEG.items()))
    conf = {'tokenizer': 'paraformer',
            'tokenizer_conf': {'symbol_table_path': str(units),
                               'seg_dict_path': str(seg)}}
    got = ttokenizer.init_tokenizer(conf)
    want = jtokenizer.init_tokenizer(conf)
    assert isinstance(got, ttok.ParaformerTokenizer)
    assert got.seg_dict == want.seg_dict == SEG
    for line in LINES:
        tokens, ids = got.tokenize(line)
        assert (tokens, ids) == want.tokenize(line)
        assert got.detokenize(ids) == want.detokenize(ids)
    for toks in (['he@@', 'llo', '你', 'b', '<unk>', 'a@@'],
                 ['你', '好', 'world', 'he@@'], ['<sos>', 'b', "'"]):
        assert ttok.beautify_result(toks) == jtok.beautify_result(toks)
    with pytest.raises(ValueError, match='seg_dict'):
        ttok.ParaformerTokenizer(str(units)).text2tokens('hello')


# ------------------------------ CIF ------------------------------

def _cif_inputs(seed=0, B=3, T=23, D=8):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, T, D).astype(np.float32)
    a = rng.uniform(0.0, 0.6, (B, T)).astype(np.float32)
    a[1, 15:] = 0.0                              # a padded row
    # row 2: sums of exact binary fractions, a fire exactly at 1.0
    a[2, :6] = [0.25, 0.5, 0.25, 0.75, 0.125, 0.125]
    return h, a


@pytest.mark.parametrize('max_tokens', [12, 3])
def test_cif_fire_matches_jax(max_tokens):
    """`n_fired` exactly, the fired embeddings to 1e-5; row 2 reaches the
    threshold exactly at frame 2 (0.25 + 0.5 + 0.25) and at frame 5, and
    with 3 slots the later fires overwrite the last slot, as JAX's
    clipped write."""
    h, a = _cif_inputs()
    want, wn = jpara.cif_fire(jnp.asarray(h), jnp.asarray(a), max_tokens,
                              1.0)
    got, gn = tpara.cif_fire(torch.from_numpy(h), torch.from_numpy(a),
                             max_tokens, 1.0)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert gn.dtype == torch.int32 and int(gn.max()) > 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    fires = tpara.cif_fires(torch.from_numpy(a[2:]), 1.0)[0].numpy()
    assert fires[2] == 1.0 and fires[5] == 1.0


def test_cif_fires_peaks_and_tail_match_jax():
    h, a = _cif_inputs(1)
    mask = np.ones((3, 23), bool)
    mask[1, 15:] = False
    np.testing.assert_array_equal(
        tpara.cif_fires(torch.from_numpy(a), 1.0).numpy(),
        np.asarray(jpara.cif_fires(jnp.asarray(a), 1.0)))
    # the row sums' order differs (f32 noise); the fires are the same
    nums = np.array([5, 3, 4], np.int32)
    got = tpara.cif_peaks_from_tp(torch.from_numpy(a),
                                  torch.from_numpy(nums)).numpy()
    want = np.asarray(jpara.cif_peaks_from_tp(jnp.asarray(a),
                                              jnp.asarray(nums)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got > 1 - 1e-4, want > 1 - 1e-4)
    assert ((want > 1 - 1e-4).sum(1) >= nums - 1).all()
    wh, wa, wn = jpara.cif_tail_process(jnp.asarray(h), jnp.asarray(a),
                                        jnp.asarray(mask), 0.45)
    gh, ga, gn = tpara.cif_tail_process(torch.from_numpy(h),
                                        torch.from_numpy(a),
                                        torch.from_numpy(mask), 0.45)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert ga[1, 15] == np.float32(0.45) and ga[0, 23] == np.float32(0.45)


@pytest.mark.parametrize('cif_conf', [
    {},                                              # depthwise, residual
    {'cnn_groups': 1, 'residual': False, 'l_order': 2, 'r_order': 0},
])
def test_cif_head_and_greedy_decode_match_jax(cif_conf):
    """cif_alphas (its conv reads the first padded frame at r_order 1),
    and paraformer_greedy_decode's tokens and fire counts."""
    cif = jpara.CifConfig(idim=16, **cif_conf)
    pcfg = jpara.ParaformerConfig(vocab_size=V, encoder_output_size=16,
                                  cif=cif)
    p = jpara.init_paraformer_head(jax.random.PRNGKey(2), pcfg)
    p['predictor']['cif_output']['bias'] = jnp.asarray([1.0])
    pred = tpara.Predictor(tpara.CifConfig(**dataclasses.asdict(cif)))
    head = convert.state_dict_from_jax(flatten_params(p))
    pred.load_state_dict({k[len('predictor.'):]: v for k, v in head.items()
                          if k.startswith('predictor.')}, strict=True)
    out = tpara.Linear(16, V)
    out.load_state_dict({'weight': head['output_layer.weight'],
                         'bias': head['output_layer.bias']})
    rng = np.random.RandomState(4)
    enc = rng.randn(2, 31, 16).astype(np.float32)
    mask = (np.arange(31)[None] < np.array([31, 20])[:, None])[:, None]
    want = jpara.cif_alphas(p['predictor'], jnp.asarray(enc),
                            jnp.asarray(mask), cif)
    got = tpara.cif_alphas(pred, torch.from_numpy(enc),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    wt, wn = jpara.paraformer_greedy_decode(p, jnp.asarray(enc),
                                            jnp.asarray(mask), pcfg, 24)
    with torch.no_grad():
        gt, gn = tpara.paraformer_greedy_decode(
            pred, out, torch.from_numpy(enc), torch.from_numpy(mask), 24)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert int(gn.min()) > 3
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


# ------------------------------ searches ------------------------------

def _log_probs(seed=0, B=3, U=9, Vs=7):
    rng = np.random.RandomState(seed)
    lp = np.log(rng.dirichlet(np.ones(Vs), (B, U))).astype(np.float32)
    lp[0, 2, 4] = lp[0, 2, 1] = lp[0, 2].max() + 0.5     # an argmax tie
    lp[1, :, :] = lp[1, 0]                               # every step ties
    lp[2, 3, 5] = lp[2, 3, 2]                            # a beam tie
    return lp, np.array([9, 5, 7], np.int32)


def test_greedy_search_matches_jax():
    """Tokens (the tie to the lower index), confidences and the tp-peak
    times; the times' one-peak-per-token assertion."""
    lp, lens = _log_probs()
    rng = np.random.RandomState(3)
    peaks = rng.uniform(0, 1.2, (3, 40)).astype(np.float32)
    peaks[:, ::4] = np.float32(1 - 5e-5)        # above 1 − 1e-4
    want = jsearch.paraformer_greedy_search(jnp.asarray(lp),
                                            jnp.asarray(lens),
                                            jnp.asarray(peaks))
    got = tsearch.paraformer_greedy_search(torch.from_numpy(lp),
                                           torch.from_numpy(lens),
                                           torch.from_numpy(peaks))
    assert got[0].tokens[2] == 1
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.times == w.times
        assert g.confidence == w.confidence
        assert g.tokens_confidence == w.tokens_confidence
    peaks[0] = 0.0
    with pytest.raises(AssertionError):
        tsearch.paraformer_greedy_search(torch.from_numpy(lp),
                                         torch.from_numpy(lens),
                                         torch.from_numpy(peaks))


@pytest.mark.parametrize('beam,eos', [(3, -1), (4, 6)])
def test_beam_search_matches_jax(beam, eos):
    """Beam indices of every hypothesis exactly (no history reordering,
    eos on finished rows, the final modulo V; ties to the lower index)
    and the final scores, on the same position-wise log-probs (row 1
    repeats one step, so its candidates tie over and over); then the
    whole search from decoder log-probs without that row, whose sums of
    sums would turn the packages' one-ulp log-softmax differences into
    other tie orders."""
    lp, lens = _log_probs(1)
    masks_pad = np.arange(9)[None, :] >= lens[:, None]
    log_post = np.asarray(jax.nn.log_softmax(jnp.asarray(lp), -1))
    wi, ws = jsearch._batch_beam_search_device(
        jnp.asarray(log_post), jnp.asarray(masks_pad), beam, eos)
    gi, gs = tsearch._batch_beam_search(
        torch.from_numpy(log_post.copy()), torch.from_numpy(masks_pad),
        beam, eos)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    lp = lp[[0, 2]]
    lens = lens[[0, 2]]
    want = jsearch.paraformer_beam_search(jnp.asarray(lp),
                                          jnp.asarray(lens), beam, eos)
    got = tsearch.paraformer_beam_search(torch.from_numpy(lp),
                                         torch.from_numpy(lens), beam, eos)
    assert [g.tokens for g in got] == [w.tokens for w in want]


def test_timestamps_and_beautify_match_jax():
    rng = np.random.RandomState(0)
    for fn in (tsearch.gen_timestamps_from_peak,
               jsearch.gen_timestamps_from_peak):
        with pytest.raises(IndexError):      # one fire and a short tail
            fn([26], 29, 0.02)
    for n in range(2, 8):
        peaks = sorted(rng.choice(60, n, replace=False).tolist())
        for frames in (peaks[-1] + 3, peaks[-1] + 40):
            assert tsearch.gen_timestamps_from_peak(peaks, frames, 0.02) == \
                jsearch.gen_timestamps_from_peak(peaks, frames, 0.02)
    pool = ['你', '好', 'he@@', 'llo', 'world', '@@', '1', "'", '<s>',
            '<unk>', '</s>', 'ab c', '']
    for _ in range(200):
        toks = [pool[i] for i in rng.randint(0, len(pool),
                                             rng.randint(0, 7))]
        assert tsearch.paraformer_beautify_result(toks) == \
            jsearch.paraformer_beautify_result(toks), toks


# ------------------------------ the CLI ------------------------------

CLI_UNITS = (['<blank>', '<s>', '</s>', '<unk>'] + list('你好世界天气') +
             [f'w{i}@@' for i in range(10)] + [f'w{i}' for i in range(20)])


def _sharp(p, cif):
    """A random SANM Paraformer that fires about 0.25 a frame and decodes
    varied tokens: the CIF output bias lowered, the output layer scaled."""
    p['predictor']['cif_output']['bias'] = jnp.asarray([-1.1])
    p['predictor']['cif_output']['weight'] = \
        p['predictor']['cif_output']['weight'] * 0.1
    p['decoder']['output_layer']['weight'] = \
        p['decoder']['output_layer']['weight'] * 4.0
    p['predictor'].update(jpara.init_predictor_tp(jax.random.PRNGKey(7),
                                                  cif))
    return p


@pytest.fixture(scope='module')
def cli_dirs(tmp_path_factory):
    """Two model directories of one random SANM Paraformer (input_dim 80,
    d = 32): the JAX tree as `model.npz`, and the port's state dict as
    `final.pt`; and a 3 s WAV."""
    from test_torch_train_bin import _write_wav
    base = tmp_path_factory.mktemp('paraformer_cli')
    conf = sanm_conf()
    conf.update(input_dim=80, output_dim=len(CLI_UNITS))
    conf['encoder_conf']['sanm_shfit'] = 0
    conf['cif_conf']['tail_threshold'] = 0.45
    scfg, cif = treg.sanm_configs(conf)
    jcif = jpara.CifConfig(**dataclasses.asdict(cif))
    p = _sharp(jinit(conf, jax.random.PRNGKey(1)).params, jcif)
    dirs = {}
    for kind in ('npz', 'pt'):
        d = base / kind
        d.mkdir()
        (d / 'config.yaml').write_text(yaml.safe_dump(conf))
        _units(d / 'units.txt', CLI_UNITS)
        if kind == 'npz':
            save_npz(str(d / 'model.npz'), p)
        else:
            sd = convert.state_dict_from_jax(flatten_params(p))
            torch.save(sd, d / 'final.pt')
        dirs[kind] = d
    wav = _write_wav(base / 'a.wav', 48000, 5)
    return dirs, wav


@pytest.mark.parametrize('kind', ['npz', 'pt'])
def test_transcribe_paraformer_matches_jax(cli_dirs, kind, monkeypatch):
    """`transcribe --paraformer -t`: the port's result dict is JAX's (text,
    tokens and times exactly, confidences within 1e-5).  Both packages
    read the port's fbank, so the comparison starts at the model.  Under
    the profiler a transcribe shows its four phases' spans in order."""
    from reverb_tpu.cli import paraformer_model as jpm
    from reverb_tpu.cli import transcribe as jtr
    from reverb_tpu_torch.cli import paraformer_model as tpm
    from reverb_tpu_torch.cli import transcribe as ttr
    from reverb_tpu_torch.frontend.fbank import compute_fbank
    dirs, wav = cli_dirs

    def port_fbank(wave, cfg, n_frames):
        return jnp.asarray(compute_fbank(torch.from_numpy(np.asarray(wave)),
                                         cfg, n_frames=n_frames).numpy())
    monkeypatch.setattr(jpm, 'compute_fbank_compiled', port_fbank)
    argv = [str(wav), '-m', str(dirs[kind]), '--paraformer', '-t']
    with contextlib.redirect_stdout(io.StringIO()) as out:
        want = jtr.main(argv)
        got = ttr.main(argv + ['--device', 'cpu'])
    assert json.loads(out.getvalue().splitlines()[-1]) == json.loads(
        json.dumps(got, ensure_ascii=False))
    assert len(want['tokens']) >= 5 and want['text']
    assert got['text'] == want['text']
    assert math.isclose(got['confidence'], want['confidence'], rel_tol=0,
                        abs_tol=1e-5)
    assert len(got['tokens']) == len(want['tokens'])
    for g, w in zip(got['tokens'], want['tokens']):
        assert (g['token'], g['start'], g['end']) == \
            (w['token'], w['start'], w['end'])
        assert math.isclose(g['confidence'], w['confidence'], rel_tol=0,
                            abs_tol=1e-5)
    model = tpm.load_model(str(dirs[kind]), device='cpu')
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.transcribe(str(wav))
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith('span:'))
    assert [n for _, n in spans] == [
        'span:paraformer.encoder', 'span:paraformer.cif',
        'span:paraformer.decoder', 'span:paraformer.search']
    with pytest.raises(NotImplementedError, match='Align'):
        model.align(str(wav), 'w1')


def test_paraformer_load_model_needs_a_directory():
    from reverb_tpu_torch.cli import paraformer_model as tpm
    with pytest.raises(ValueError, match='downloads'):
        tpm.load_model(None, device='cpu')


# ------------------------------ training ------------------------------

def _batch(B=2, T=180, U=5, seed=0):
    rng = np.random.RandomState(seed)
    target = rng.randint(1, V - 2, (B, U)).astype(np.int32)
    target[1, U - 2:] = -1
    return {'feats': rng.randn(B, T, 80).astype(np.float32),
            'feats_lengths': np.array([T, T - 49], np.int32),
            'target': target,
            'target_lengths': np.array([U, U - 2], np.int32)}


def conformer_conf():
    return {'model': 'paraformer', 'input_dim': 80, 'output_dim': V,
            'encoder': 'conformer', 'encoder_conf': ENC,
            'decoder': 'bitransformer', 'decoder_conf': DEC,
            'paraformer_conf': {'cif_conf': {'tail_threshold': 0.0}},
            'model_conf': {'ctc_weight': 0.3}}


def _sanm_train_conf():
    conf = sanm_conf(ctc_weight=0.3)
    conf['input_dim'] = 80
    return conf


@pytest.mark.parametrize('which', ['sanm', 'conformer'])
def test_paraformer_bundles_loss_and_grads_match_jax(which):
    """Each bundle's loss terms and every gradient against jax.grad of the
    JAX bundle's loss, on the same weights and batch (sampler off,
    dropout 0).

    Training scales α to sum to the target length U, so the U-th fire
    comes at the last frame with the integrator at 1.0 give or take an
    ulp: at threshold 1.0 whether it fires is f32 noise (JAX's jitted and
    eager losses differ there by 0.1).  The CIF threshold here is 0.999,
    which puts that fire 1e-3 clear; every other fire is as at 1.0."""
    conf = _sanm_train_conf() if which == 'sanm' else conformer_conf()
    cif = (conf['cif_conf'] if which == 'sanm'
           else conf['paraformer_conf']['cif_conf'])
    cif['threshold'] = 0.999
    jb = jinit(conf, jax.random.PRNGKey(0))
    p = jb.params
    # fire about once every 3 frames, so the scaled α meets the targets
    p['predictor']['cif_output']['bias'] = jnp.asarray([-0.7])
    tb = treg.init_model(conf, device='cpu',
                         state_dict=convert.state_dict_from_jax(
                             flatten_params(p)))
    assert tb.kind == jb.kind == 'paraformer'
    jout, tout, jg, tg = losses_and_grads(jb, tb, _batch())
    for k, v in jout.items():
        got = tout[k]
        if k == 'pred_count':
            v = np.mean(np.asarray(v))
        np.testing.assert_allclose(float(got.detach()), float(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert_grads_close(jg, tg)
    assert float(np.abs(tg['predictor.cif_output.weight']).max()) > 0


def test_glancing_sampler_structure():
    """With the sampler on, the replaced positions of each row are
    target_num = ⌊(len − correct)·ratio⌋ of its valid ones, `correct`
    counted from the frozen decoder pass; they move with the generator's
    seed, and the loss differs from the sampler-off loss."""
    conf = _sanm_train_conf()
    conf['model_conf'].update(sampler=True, sampling_ratio=0.75)
    jp = jinit(conf, jax.random.PRNGKey(0)).params
    tb = treg.init_model(conf, device='cpu',
                         state_dict=convert.state_dict_from_jax(
                             flatten_params(jp)))
    model, b = tb.model, to_torch(_batch(U=8))
    seen = []
    orig = treg.glancing_replace

    def spy(tgt_mask, target_num, generator, device):
        out = orig(tgt_mask, target_num, generator, device)
        seen.append((tgt_mask, target_num, out))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg, 'glancing_replace', spy)
        on = [float(tb.loss_fn(model, b, torch.Generator().manual_seed(s))
                    ['loss']) for s in (0, 1)]
    mask, num, rep = seen[0]
    # the frozen decoder pass, recomputed
    with torch.no_grad():
        enc, emask = model.encoder(b['feats'], b['feats_lengths'])
        al = tpara.cif_alphas(model.predictor, enc, emask)
        scale = b['target_lengths'].float() / al.sum(1).clamp(min=1e-4)
        ac, _ = tpara.cif_fire(enc, al * scale[:, None], 8, 1.0)
        pred = model.decoder(enc, emask, ac, b['target_lengths']).argmax(-1)
    labels = b['target'].clamp(min=0)
    same = ((pred == labels) & mask).sum(1)
    want = ((b['target_lengths'] - same).float() * 0.75).to(torch.int32)
    assert torch.equal(num, want) and int(want.min()) > 0
    assert torch.equal(rep.sum(1).to(torch.int32), want)
    assert not bool((rep & ~mask).any())
    assert not torch.equal(rep, seen[1][2])
    conf['model_conf']['sampler'] = False
    model.train_cfg = dataclasses.replace(model.train_cfg, sampler=False)
    off = float(tb.loss_fn(model, b, None)['loss'])
    assert abs(on[0] - off) > 1e-4


@pytest.mark.parametrize('which', ['sanm', 'conformer'])
def test_bin_train_runs_paraformer(which, tmp_path):
    """Two steps of the port's `bin.train` on a 4-utterance corpus with a
    char tokenizer: finite losses, a checkpoint that loads back strictly
    and moved parameters."""
    from reverb_tpu_torch.bin import train as ttrain
    from test_torch_train_bin import _write_list, _write_wav
    entries = []
    texts = ['ab c', 'c a b', 'b b a', 'a c']
    for i, txt in enumerate(texts):
        wav = _write_wav(tmp_path / f'u{i}.wav', 16000, 30 + i)
        entries.append({'key': f'u{i}', 'wav': str(wav), 'txt': txt})
    _write_list(tmp_path / 'train.list', entries)
    _write_list(tmp_path / 'cv.list', entries[:2])
    _units(tmp_path / 'units.txt', ['<blank>', '<unk>', 'a', 'b', 'c',
                                    '<sos/eos>'])
    conf = _sanm_train_conf() if which == 'sanm' else conformer_conf()
    conf.pop('output_dim')
    conf['model_conf']['ctc_weight'] = 0.0
    conf.update({
        'tokenizer': 'char',
        'tokenizer_conf': {'symbol_table_path': str(tmp_path / 'units.txt'),
                           'split_with_space': False},
        'optim': 'adam', 'optim_conf': {'lr': 1e-3},
        'scheduler': 'warmuplr', 'scheduler_conf': {'warmup_steps': 2},
        'dataset_conf': {
            'filter_conf': {'max_length': 2000, 'min_length': 5},
            'resample_conf': {'resample_rate': 16000},
            'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                           'frame_shift': 10, 'dither': 0.0},
            'spec_aug': False, 'shuffle': False, 'sort': False,
            'batch_conf': {'batch_type': 'static', 'batch_size': 2}}})
    cfg = tmp_path / 'train.yaml'
    cfg.write_text(yaml.safe_dump(conf))
    ex = ttrain.main(['--config', str(cfg), '--train_data',
                      str(tmp_path / 'train.list'), '--cv_data',
                      str(tmp_path / 'cv.list'), '--model_dir',
                      str(tmp_path / 'exp'), '--max_epoch', '1',
                      '--device', 'cpu', '--seed', '2'])
    assert ex.step == 2
    with np.load(tmp_path / 'exp' / 'epoch_0.npz') as z:
        flat = {k: z[k] for k in z.files if not k.startswith('__meta__')}
    assert all(np.isfinite(v).all() for v in flat.values())
    conf['output_dim'] = 6
    back = treg.init_model(conf, device='cpu',
                           state_dict=convert.state_dict_from_jax(flat))
    fresh = treg.init_model(conf, torch.Generator().manual_seed(2), 'cpu')
    moved = max(float((back.model.state_dict()[k].float()
                       - v.float()).abs().max())
                for k, v in fresh.model.state_dict().items())
    assert moved > 1e-5
