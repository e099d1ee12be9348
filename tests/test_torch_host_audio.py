"""The host audio pieces of the port against the JAX package: the
waveform distortions at a seeded `random.Random` (exact), Kaldi ark/scp
files written by either package and read by the other (exact), and the
port's own ctypes loader of native/reverb_native.cpp (built here with
g++): decode_wav, resample and fbank exactly equal to the JAX package's
native calls, and the data pipeline's stages on them."""

import random

import numpy as np
import pytest

from reverb_tpu import native as jnative
from reverb_tpu.data import kaldi_io as jkio
from reverb_tpu.data import processor as jproc
from reverb_tpu.data import wav_distortion as jwd
from reverb_tpu_torch import native as tnative
from reverb_tpu_torch.data import kaldi_io as tkio
from reverb_tpu_torch.data import processor as tproc
from reverb_tpu_torch.data import wav_distortion as twd

KINDS = ['gain_db', 'max_distortion', 'fence_distortion', 'jag_distortion',
         'poly_distortion', 'quad_distortion', 'none_distortion']


def _wave(seed, n=4000):
    rng = np.random.RandomState(seed)
    x = np.sin(np.arange(n) / 7.0) * rng.rand(n) * 0.8
    x[::50] = 0.0
    x[5:40] = rng.randn(35) * 1e-7            # poly's |x| < 1e-6 branch
    return x.astype(np.float32)[None]


@pytest.mark.parametrize('kind', KINDS)
def test_wav_distortion_equals_jax(kind):
    """Each family through distort_wav_conf, and the pipeline stage, from
    the same seeded random.Random: identical waveforms and identical
    streams after."""
    for seed in range(3):
        conf = twd.DEFAULT_CONFS.get(kind, {'mask_number': 0,
                                            'max_db': -20})
        if kind == 'fence_distortion' and seed == 2:
            conf = {'mask_number': 0, 'max_db': -20}   # the default masks
        rj, rt = random.Random(seed), random.Random(seed)
        want = jwd.distort_wav_conf(_wave(seed), kind, conf, 0.4, rj)
        got = twd.distort_wav_conf(_wave(seed), kind, conf, 0.4, rt)
        np.testing.assert_array_equal(got, want)
        assert rj.random() == rt.random()
    rj, rt = random.Random(7), random.Random(7)
    for i in range(6):
        a = jwd.distort_wav({'wav': _wave(i)}, prob=0.7, rng=rj)['wav']
        b = twd.distort_wav({'wav': _wave(i)}, prob=0.7, rng=rt)['wav']
        np.testing.assert_array_equal(b, a)
    chain = [twd.make_gain_db({'db': -3}), twd.make_quad_distortion()]
    jchain = [jwd.make_gain_db({'db': -3}), jwd.make_quad_distortion()]
    np.testing.assert_array_equal(
        twd.distort_chain(_wave(1), chain, 0.5, random.Random(1)),
        jwd.distort_chain(_wave(1), jchain, 0.5, random.Random(1)))


def test_kaldi_io_cross_reads(tmp_path):
    """Matrices and vectors written by either package (with an scp index)
    read back identically by the other; the text format too; a malformed
    binary header raises."""
    rng = np.random.RandomState(0)
    items = {'utt1': rng.randn(7, 5).astype(np.float32),
             'utt2': rng.randn(3).astype(np.float32),
             'utt3': rng.randn(1, 80).astype(np.float32)}
    for w, r in ((jkio, tkio), (tkio, jkio)):
        ark, scp = tmp_path / f'{w.__name__}.ark', tmp_path / 'x.scp'
        w.write_ark(str(ark), items, str(scp))
        for reader in (r.read_ark(str(ark)), r.read_scp(str(scp))):
            got = dict(reader)
            assert list(got) == list(items)
            for k, v in items.items():
                np.testing.assert_array_equal(got[k], v)
        assert (dict(tkio.read_ark(str(ark))).keys()
                == dict(jkio.read_ark(str(ark))).keys())
    bad = tmp_path / 'bad.ark'
    bad.write_bytes(b'k \x00BFM \x05' + b'\x00' * 12)
    with pytest.raises(ValueError, match='size marker'):
        list(tkio.read_ark(str(bad)))
    txt = tmp_path / 'text.ark'
    txt.write_bytes(b'a  [\n 1 2 3\n 4 5 6 ]\nb [ 7 8 ]\n')
    for k, v in tkio.read_ark(str(txt)):
        np.testing.assert_array_equal(v, dict(jkio.read_ark(str(txt)))[k])


def _wav_bytes(seed, n=12345, sr=16000, ch=1):
    import io
    import wave
    rng = np.random.RandomState(seed)
    pcm = (rng.randn(n * ch) * 3000).clip(-32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def test_native_runtime_equals_jax(monkeypatch):
    """The port's loader builds the library under reverb_tpu_torch/_build
    and each entry point gives the JAX package's native result exactly;
    processor.decode_wav takes it for bytes, compute_fbank under
    REVERB_TPU_NATIVE_FBANK, both as the JAX processor does."""
    lib = tnative.get_lib()
    assert lib is not None and jnative.get_lib() is not None
    assert '_build' in lib._name
    for ch in (1, 2):
        data = _wav_bytes(ch, ch=ch)
        got, sr = tnative.decode_wav(data)
        want, wsr = jnative.decode_wav(data)
        assert sr == wsr == 16000 and got.shape == (12345, ch)
        np.testing.assert_array_equal(got, want)
    x = np.random.RandomState(3).randn(8000).astype(np.float32)
    for sr_in, sr_out in ((8000, 16000), (44100, 16000), (16000, 16000)):
        np.testing.assert_array_equal(tnative.resample(x, sr_in, sr_out),
                                      jnative.resample(x, sr_in, sr_out))
    wave = x * 3000
    np.testing.assert_array_equal(tnative.fbank(wave, 16000, 80),
                                  jnative.fbank(wave, 16000, 80))
    with pytest.raises(ValueError):
        tnative.decode_wav(b'RIFF0000WAVEjunk')
    sample = {'key': 'a', 'wav': _wav_bytes(9)}
    a = tproc.decode_wav(dict(sample))
    b = jproc.decode_wav(dict(sample))
    np.testing.assert_array_equal(a['wav'], b['wav'])
    monkeypatch.setenv('REVERB_TPU_NATIVE_FBANK', '1')
    fa = tproc.compute_fbank(dict(a), num_mel_bins=80)['feat']
    fb = jproc.compute_fbank(dict(b), num_mel_bins=80)['feat']
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(
        fa, tnative.fbank(a['wav'][0] * (1 << 15), 16000, 80))
    monkeypatch.delenv('REVERB_TPU_NATIVE_FBANK')
    host = tproc.compute_fbank(dict(a), num_mel_bins=80)['feat']
    np.testing.assert_allclose(host, fa, rtol=1e-3, atol=2e-3)
