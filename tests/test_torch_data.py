"""The port's data pipeline (reverb_tpu_torch/data/, the numpy fbank, the
text language id) against the JAX package's on the same inputs.

One raw list and one shard tarball of tiny WAVs go through both packages'
`Dataset`; every batch must be equal array by array (keys, feats, target,
the lengths, pcm, cat_embs, langs, tasks) for each batch type, with a
seeded list shuffle, shuffle buffer and sort.  The augmentations draw from
`random` and `np.random`; with both reseeded before each package's run
they give equal batches too.  num_workers stays 0: threaded draws have no
fixed order.
"""

import json
import random
import tarfile

import numpy as np
import pytest

from helpers import TINY_PIECES, write_sp_model
from reverb_tpu.data import dataset as jds
from reverb_tpu.data import pipeline as jpipe
from reverb_tpu.data import processor as jproc
from reverb_tpu.data import rev_processor as jrev
from reverb_tpu.frontend import fbank as jfb
from reverb_tpu.text import langid as jlangid
from reverb_tpu.text.tokenizer import init_tokenizer as jinit_tokenizer
from reverb_tpu_torch.data import dataset as tds
from reverb_tpu_torch.data import pipeline as tpipe
from reverb_tpu_torch.data import processor as tproc
from reverb_tpu_torch.data import rev_processor as trev
from reverb_tpu_torch.frontend import fbank as tfb
from reverb_tpu_torch.text import langid as tlangid
from reverb_tpu_torch.text.tokenizer import init_tokenizer as tinit_tokenizer

TEXTS = ['a b ab c', 'ab c', 'a a b', 'c ab a b ab', 'b', 'a c c ab',
         'ab ab', 'c a']


def _speechy(n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    env = np.repeat(rng.rand(n // 800 + 1), 800)[:n]
    x = (np.sin(2 * np.pi * rng.uniform(120, 400) * t)
         + 0.3 * rng.randn(n)) * env * 6000
    return x.astype(np.int16)


def _write_wav(path, n, seed):
    import wave
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(_speechy(n, seed).tobytes())
    return path


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """8 WAVs of 0.3-1.0 s under 4 job prefixes: a raw list (with
    styles) and a shard list of two tarballs; the rev_bpe tokenizer
    config of tests/helpers.py."""
    d = tmp_path_factory.mktemp('torch_data')
    lines = []
    for i in range(8):
        wav = _write_wav(d / f'u{i}.wav', 4800 + 1400 * i, i)
        rec = {'key': f'job{i % 4}_utt{i}', 'wav': str(wav),
               'txt': TEXTS[i]}
        if i % 3 == 0:
            rec['style'] = 'v'
        lines.append(json.dumps(rec))
    (d / 'raw.list').write_text('\n'.join(lines) + '\n')
    shards = []
    for s in range(2):
        path = d / f'shard{s}.tar'
        with tarfile.open(path, 'w') as tar:
            for i in range(s * 3, s * 3 + 3):
                tar.add(d / f'u{i}.wav', arcname=f'sh_utt{i}.wav')
                txt = d / f'u{i}.txt'
                txt.write_text(TEXTS[i])
                tar.add(txt, arcname=f'sh_utt{i}.txt')
        shards.append(str(path))
    (d / 'shard.list').write_text('\n'.join(shards) + '\n')
    symbols = [p for p, _, _ in TINY_PIECES]
    (d / 'tk.units.txt').write_text(
        ''.join(f'{s} {i}\n' for i, s in enumerate(symbols)))
    write_sp_model(d / 'tk.model', TINY_PIECES, model_type=1)
    tk_conf = {'tokenizer': 'rev_bpe',
               'tokenizer_conf': {'symbol_table_path': str(d / 'tk.units.txt'),
                                  'bpe_path': str(d / 'tk.model'),
                                  'non_lang_syms_path': None,
                                  'remove_sw': True,
                                  'replace_unk_as_unknown': True}}
    return d, jinit_tokenizer(tk_conf), tinit_tokenizer(tk_conf)


def _conf(batch_conf, **extra):
    conf = {
        'filter_conf': {'max_length': 2000, 'min_length': 5},
        'resample_conf': {'resample_rate': 16000},
        'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                       'frame_shift': 10, 'dither': 0.0},
        'spec_aug': False,
        'shuffle': True, 'shuffle_conf': {'shuffle_size': 5},
        'sort': True, 'sort_conf': {'sort_size': 4},
        'pass_cat_emb': True,
        'cat_emb_conf': {'field': 'style', 'emb_len': 2,
                         'one_hot_ids': {'v': 0, 'nv': 1}},
        'batch_conf': batch_conf,
    }
    conf.update(extra)
    return conf


def _both(corpus, data_type, conf, seed=3, reseed=None):
    d, jtok, ttok = corpus
    lst = str(d / f'{data_type}.list')
    out = []
    for mod, tok in ((jds, jtok), (tds, ttok)):
        if reseed is not None:
            random.seed(reseed)
            np.random.seed(reseed)
        out.append(list(mod.Dataset(data_type, lst, tok, conf,
                                    partition=False, seed=seed)))
    return out


def _assert_batches_equal(want, got):
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


BATCH_CONFS = {
    'static': {'batch_type': 'static', 'batch_size': 3},
    'bucket': {'batch_type': 'bucket', 'bucket_boundaries': [40, 70],
               'bucket_batch_sizes': [3, 2, 2]},
    'dynamic': {'batch_type': 'dynamic', 'max_frames_in_batch': 200},
    'distribute': {'batch_type': 'distribute', 'max_frames_in_batch': 260,
                   'distrib_one_utt_per_job': True,
                   'distrib_max_word_count_per_batch': 7},
}


@pytest.mark.parametrize('data_type', ['raw', 'shard'])
@pytest.mark.parametrize('batch_type', sorted(BATCH_CONFS))
def test_batches_equal_jax(corpus, data_type, batch_type):
    want, got = _both(corpus, data_type, _conf(BATCH_CONFS[batch_type]))
    _assert_batches_equal(want, got)
    n = 8 if data_type == 'raw' else 6
    assert sum(len(b['keys']) for b in got) == n
    # the comparison is not vacuous: tokens, features and both styles
    assert (got[0]['target'] >= 0).any() and got[0]['feats'].std() > 0.5


@pytest.mark.parametrize('aug', [
    {'spec_aug': True, 'spec_aug_conf': {'num_t_mask': 2, 'num_f_mask': 2,
                                         'max_t': 10, 'max_f': 5},
     'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                    'frame_shift': 10, 'dither': 0.1}},
    {'speed_perturb': True, 'spec_sub': True, 'spec_trim': True,
     'spec_sub_conf': {'max_t': 8, 'num_t_sub': 2},
     'spec_trim_conf': {'max_t': 6}},
    {'apply_telephony': True, 'apply_telephony_conf': {'prob': 0.6},
     'apply_rir': True,
     'apply_rir_conf': {'prob': 0.7, 'rir_list': [
         np.exp(-np.arange(400) / 60.0).astype(np.float32)
         * np.cos(np.arange(400) * 0.3).astype(np.float32)]}},
], ids=['spec_aug_dither', 'speed_sub_trim', 'telephony_rir'])
def test_augmented_batches_equal_jax(corpus, aug):
    conf = _conf(BATCH_CONFS['static'], **aug)
    want, got = _both(corpus, 'raw', conf, reseed=11)
    _assert_batches_equal(want, got)
    plain, _ = _both(corpus, 'raw', _conf(BATCH_CONFS['static']))
    # the augmentation changed something
    assert any(not np.array_equal(a['feats'], b['feats'])
               or not np.array_equal(a['pcm'], b['pcm'])
               for a, b in zip(got, plain))


def test_cycle_partition_and_prefetch_equal_jax(corpus):
    """Rank partitioning of the list, cycle 2, and prefetch."""
    d, jtok, ttok = corpus
    conf = _conf(BATCH_CONFS['static'], cycle=2)
    lst = str(d / 'raw.list')
    for rank in (0, 1):
        want = list(jds.Dataset('raw', lst, jtok, conf, rank=rank,
                                world_size=2, seed=5).prefetch(2))
        got = list(tds.Dataset('raw', lst, ttok, conf, rank=rank,
                               world_size=2, seed=5).prefetch(2))
        _assert_batches_equal(want, got)
        assert sum(len(b['keys']) for b in got) == 8


@pytest.mark.parametrize('num_mel_bins,high_freq', [(80, 0.0), (23, -400.0)])
def test_fbank_and_mfcc_numpy_bit_equal(num_mel_bins, high_freq):
    wave = _speechy(16000 + 123, 7).astype(np.float32)
    jc = jfb.FbankConfig(num_mel_bins=num_mel_bins, high_freq=high_freq)
    tc = tfb.FbankConfig(num_mel_bins=num_mel_bins, high_freq=high_freq)
    np.testing.assert_array_equal(tfb.fbank_numpy(wave, tc),
                                  jfb.fbank_numpy(wave, jc))
    np.testing.assert_array_equal(tfb.mfcc_numpy(wave, tc, num_ceps=13),
                                  jfb.mfcc_numpy(wave, jc, num_ceps=13))
    np.testing.assert_array_equal(tfb.dct_matrix(13, num_mel_bins),
                                  jfb.dct_matrix(13, num_mel_bins))
    assert tfb.fbank_numpy(wave[:100], tc).shape == (0, num_mel_bins)


def test_processor_features_equal_jax():
    """compute_mfcc and the whisper-style log-mel of both processors."""
    wav = (_speechy(12000, 2).astype(np.float32) / 32768)[None]
    for name, kw in (('compute_mfcc', {'num_mel_bins': 40, 'num_ceps': 20}),
                     ('compute_log_mel_spectrogram', {'num_mel_bins': 80})):
        want = getattr(jproc, name)({'wav': wav.copy(),
                                     'sample_rate': 16000}, **kw)['feat']
        got = getattr(tproc, name)({'wav': wav.copy(),
                                    'sample_rate': 16000}, **kw)['feat']
        np.testing.assert_array_equal(got, want, err_msg=name)


SENTENCES = [
    'the quick brown fox jumps over the lazy dog',
    'el perro corre por la calle y no se detiene',
    'le chien est dans la maison et il ne sort pas',
    'der Hund ist in dem Haus und er ist nicht zu sehen',
    'il cane è nella casa e non esce',
    'o cachorro está em casa e não sai',
    '今天天气很好我们去公园散步', '今日はいい天気ですから公園へ行きましょう',
    'сегодня хорошая погода', 'مرحبا بالعالم', '', 'xyz qq',
]


@pytest.mark.parametrize('limited', [None, ['en'], ['zh', 'en'], ['ja']])
def test_langid_agrees_with_jax(limited):
    for s in SENTENCES:
        assert tlangid.classify(s, limited) == jlangid.classify(s, limited), s
        assert tproc.detect_language({'txt': s}, limited) == \
            jproc.detect_language({'txt': s}, limited)


def test_rev_transforms_equal_jax():
    """Special tokens, the speaker switch, the filler filter and the
    one-hot cat-embs (multi-hot draws reseeded)."""
    conf = {'reject_on': ['<bad>'], 'remove': ['<sw>'],
            'relabel': [['<um>', 'um']], 'remove_trailing_dash': True}
    jh, th = jrev.SpecialTokensHandler(conf), trev.SpecialTokensHandler(conf)
    for txt in ('hello <sw> wor- <um> ld', 'x <bad> y', '<sw>', 'a b'):
        assert th.transform({'txt': txt}) == jh.transform({'txt': txt})

    def samples():
        return [{'key': f'spk{i // 2}-utt{i}',
                 'wav': np.full((1, 16000 + 4000 * i), i, np.float32),
                 'txt': f'w{i}', 'sample_rate': 16000} for i in range(6)]
    want = list(jrev.generate_speaker_switch_utterances(iter(samples()), {}))
    got = list(trev.generate_speaker_switch_utterances(iter(samples()), {}))
    assert [g['txt'] for g in got] == [w['txt'] for w in want]
    assert '<sw>' in ' '.join(g['txt'] for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['wav'], w['wav'])
    for txt in ('yeah ' * 12, 'okay yes ' * 3 + 'the end', 'a b'):
        assert trev.filter_long_yeah_okay({'txt': txt}) == \
            jrev.filter_long_yeah_okay({'txt': txt})
    feat = np.ones((5, 3), np.float32)
    for mod, out in ((jrev, []), (trev, [])):
        random.seed(4)
        for i in range(20):
            s = {'feat': feat, 'style': ['v', 'nv'][i % 2]}
            kw = {'emb_len': 2, 'field': 'style',
                  'one_hot_ids': {'v': 0, 'nv': 1}}
            s = mod.pass_one_hot(s, multi_hot=True, **kw)
            s = mod.add_one_hot(s, **kw)
            out.append((s['cat_emb'], s['feat']))
        if mod is jrev:
            want = out
        else:
            got = out
    for (gc, gf), (wc, wf) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gf, wf)


def test_pipeline_stages_equal_jax():
    """map_parallel order and errors, map_ignore_error, flat_map, the
    seeded shuffle and the sort buffer."""
    def sq(x):
        return x * x

    def boom(x):
        if x % 7 == 3:
            raise ValueError('boom')
        return x

    for mod in (jpipe, tpipe):
        assert list(mod.from_list(range(40)).map_parallel(
            sq, workers=4, buffer_size=8)) == [x * x for x in range(40)]
        with pytest.raises(ValueError):
            list(mod.from_list(range(10)).map_parallel(boom, workers=3))
    for build in (
            lambda m: m.from_list(range(30)).map_ignore_error(
                boom, log_error=False),
            lambda m: m.from_list(range(5)).flat_map(lambda x: [x] * x),
            lambda m: m.from_list(range(50)).shuffle(7, seed=9).sort(
                6, key_func=lambda x: -x).batch(4, drop_last=True)):
        assert list(build(tpipe)) == list(build(jpipe))


def test_padding_and_unported_options_raise(corpus, tmp_path):
    """padding's arrays equal JAX's; deep biasing (context phrases mined
    from rare words, batched as cv_list) gives JAX's batches from the same
    Python random stream; with device_feats the samples carry JAX's
    zero-width feature stub (frame counts only) and the padded PCM reaches
    the batch, and spec_sub with it raises as in JAX."""
    data = [{'key': 'a', 'feat': np.ones((37, 4), np.float32),
             'label': [1, 2], 'wav': np.ones((1, 100), np.float32),
             'cat_emb': np.array([0.0, 1.0], np.float32)},
            {'key': 'b', 'feat': np.ones((45, 4), np.float32),
             'label': [3], 'wav': np.ones((1, 80), np.float32),
             'cat_emb': np.array([1.0, 0.0], np.float32), 'lang': 'fr'}]
    _assert_batches_equal(
        [jproc.padding([dict(x) for x in data], True, pad_len_multiple=32)],
        [tproc.padding([dict(x) for x in data], True, pad_len_multiple=32)])
    freqs = tmp_path / 'word_freqs.json'
    freqs.write_text(json.dumps({'a': 100, 'ab': 5, 'b': 5, 'c': 3}))
    bias = {'deep_biasing': True, 'word_freqs': str(freqs),
            'freq_threshold': 20, 'n_order': 3, 'distractor_ratio': 0.5,
            'max_epoch': 2}
    conf = _conf(BATCH_CONFS['static'], deep_bias_conf=bias)
    want, got = _both(corpus, 'raw', conf, reseed=7)
    _assert_batches_equal(want, got)
    assert all('cv_list' in b for b in got)
    d, _, ttok = corpus
    # 'ab' frequent: 'ab ab' has no rare word; the port drops it (the JAX
    # package fails on it)
    freqs.write_text(json.dumps({'a': 100, 'ab': 50, 'b': 5, 'c': 3}))
    keys = [k for b in tds.Dataset('raw', str(d / 'raw.list'), ttok, conf,
                                   partition=False) for k in b['keys']]
    assert len(keys) == 7 and 'job2_utt6' not in keys
    conf = _conf(BATCH_CONFS['static'], device_feats=True, spec_aug=True)
    want, got = _both(corpus, 'raw', conf)
    _assert_batches_equal(want, got)
    host = _both(corpus, 'raw', _conf(BATCH_CONFS['static']))[1]
    for b, h in zip(got, host):
        assert b['feats'].shape == h['feats'].shape[:2] + (0,)
        np.testing.assert_array_equal(b['feats_lengths'], h['feats_lengths'])
        assert b['pcm'].shape[0] == len(b['keys']) and \
            b['pcm'].dtype == np.float32 and np.abs(b['pcm']).max() > 0
    with pytest.raises(ValueError, match='spec_aug only'):
        tds.Dataset('raw', str(d / 'raw.list'), ttok,
                    _conf(BATCH_CONFS['static'], device_feats=True,
                          spec_sub=True))


def test_rev_stages_and_workers_equal_jax(corpus, tmp_path):
    """The optional stages in the Dataset (speaker table, speaker-switch
    concatenation, special tokens, the filler filter, add_cat_emb) and
    num_workers 4 (map_parallel keeps the order; nothing here draws
    randomness, so the batches stay equal)."""
    d, _, _ = corpus
    lines = [json.loads(x) for x in (d / 'raw.list').read_text().splitlines()]
    for i, rec in enumerate(lines):
        rec['key'] = f'spk{i // 3}-utt{i}'
        rec['speaker'] = f'spk{i // 3}'
        rec['txt'] = rec['txt'] + (' <um>' if i % 2 else ' <sw>')
    lst = tmp_path / 'raw.list'
    lst.write_text(''.join(json.dumps(x) + '\n' for x in lines))
    (tmp_path / 'spk.txt').write_text('spk0 0\nspk1 1\n')
    conf = _conf(BATCH_CONFS['static'], num_workers=4,
                 speaker_conf={'speaker_table_path': str(tmp_path /
                                                         'spk.txt')},
                 speaker_switch_conf={'min_audio_len_acceptable_secs': 0.2,
                                      'min_audio_len_secs': 1.2,
                                      'max_audio_len_secs': 2.0},
                 handle_special_token=True,
                 handle_special_token_conf={'remove': ['<sw>'],
                                            'relabel': [['<um>', 'a']]},
                 filter_yeah_okay=True, pass_cat_emb=False, add_cat_emb=True)
    d2 = (tmp_path, corpus[1], corpus[2])
    want, got = _both(d2, 'raw', conf)
    _assert_batches_equal(want, got)
    keys = [k for b in got for k in b['keys']]
    assert len(keys) < 8 and got[0]['feats'].shape[2] == 82
    assert {0, 1} <= {int(s) for b in got for s in b['speaker']} <= \
        {-1, 0, 1}


def test_zip_shards_equal_jax(corpus, tmp_path):
    import zipfile
    from reverb_tpu.data import source as jsource
    from reverb_tpu_torch.data import source as tsource
    d, _, _ = corpus
    for z in range(2):
        with zipfile.ZipFile(tmp_path / f'z{z}.zip', 'w') as zf:
            for i in range(z * 4, z * 4 + 4):
                zf.write(d / f'u{i}.wav', f'k{i}.wav')
                zf.writestr(f'k{i}.txt', TEXTS[i])
    (tmp_path / 'zip.list').write_text(
        f'{tmp_path}/z0.zip\n{tmp_path}/z1.zip\n{tmp_path}/missing.zip\n')
    keys = []
    for rank in (0, 1):
        kw = dict(shuffle=True, seed=2, rank=rank, world_size=2)
        want = list(jsource.zip_shard_source(str(tmp_path / 'zip.list'),
                                             **kw))
        got = list(tsource.zip_shard_source(str(tmp_path / 'zip.list'),
                                            **kw))
        assert got == want
        keys += [g['key'] for g in got]
    assert sorted(keys) == [f'k{i}' for i in range(8)]
