"""Data-parallel serving in the port: `ReverbASR(data_parallel=N)` (and
`recognize_wav --data_parallel N`) splits each chunk batch over N model
replicas.  Its CTM must be byte-identical to single-device serving and to
the JAX package's `ReverbASR(data_parallel=2)`, on the 5-chunk file of
tests/test_mesh_serving.py (an uneven count: the batch is padded 5 → 6
with a zero-length row, which is dropped).  The CPU tests put both
replicas on the CPU (`devices=['cpu', 'cpu']`); on the card they are
cuda:0..N-1.
"""

import pytest
import torch

from helpers import build_tiny_model_dir, write_wav

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

MODES = ['ctc_prefix_beam_search', 'attention_rescoring', 'ctc_greedy_search']
CHUNK = 67


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    return build_tiny_model_dir(tmp_path_factory.mktemp('dpmodel'))


@pytest.fixture(scope='module')
def wav(tmp_path_factory):
    # 3 s @ chunk_size 67 → 299 fbank frames → 5 chunks
    return write_wav(tmp_path_factory.mktemp('dpaudio') / 'mesh.wav',
                     seconds=3.0)


def _port(model_dir, **kwargs):
    from reverb_tpu_torch.cli.reverb import ReverbASR
    return ReverbASR(str(model_dir / 'config.yaml'),
                     str(model_dir / 'model.npz'), **kwargs)


@pytest.fixture(scope='module')
def single(model_dir, wav):
    return _port(model_dir, device='cpu').transcribe_modes(
        str(wav), MODES, format='ctm', chunk_size=CHUNK)


@pytest.mark.parametrize('batch_size', [None, 3])
def test_data_parallel_ctm_identity(model_dir, wav, single, batch_size):
    """Auto batch (5 chunks padded to 6) and batch_size 3 (each batch
    padded 3 → 4, the last 2 → 2): the CTM of single-device serving, and
    with the auto batch the JAX package's data_parallel=2 CTM."""
    asr = _port(model_dir, data_parallel=2, devices=['cpu', 'cpu'])
    assert len(asr.replicas) == 2 and asr.replicas[1] is not asr.model
    out = asr.transcribe_modes(str(wav), MODES, format='ctm',
                               chunk_size=CHUNK, batch_size=batch_size)
    ref = single if batch_size is None else _port(
        model_dir, device='cpu').transcribe_modes(
            str(wav), MODES, format='ctm', chunk_size=CHUNK,
            batch_size=batch_size)
    for mode, a, b in zip(MODES, ref, out):
        assert a == b and a, f'{mode} CTM differs under data_parallel'
    if batch_size is None:
        import jax
        from reverb_tpu.cli.reverb import ReverbASR as JaxASR
        assert len(jax.devices()) >= 2
        jasr = JaxASR(str(model_dir / 'config.yaml'),
                      str(model_dir / 'model.npz'), data_parallel=2)
        want = jasr.transcribe_modes(str(wav), MODES, format='ctm',
                                     chunk_size=CHUNK)
        assert out == want


def test_recognize_wav_data_parallel(model_dir, wav, single, tmp_path,
                                     monkeypatch):
    """The CLI flag reaches ReverbASR: two replicas on the CPU (the
    default devices are cards)."""
    from reverb_tpu_torch.cli import recognize_wav
    from reverb_tpu_torch.cli import reverb as tcli
    real = tcli._replica_devices
    monkeypatch.setattr(tcli, '_replica_devices',
                        lambda n, devices: real(n, ['cpu'] * n))
    recognize_wav.main(['--audio_file', str(wav), '--model', str(model_dir),
                        '--modes', *MODES, '--chunk_size', str(CHUNK),
                        '--data_parallel', '2', '--result_dir',
                        str(tmp_path), '--device', 'cpu'])
    for mode, want in zip(MODES, single):
        assert (tmp_path / mode / 'mesh.ctm').read_text() == want


def test_data_parallel_rejects_more_replicas_than_devices(model_dir):
    with pytest.raises(ValueError, match='data_parallel=3'):
        _port(model_dir, data_parallel=3, devices=['cpu', 'cpu'])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match='data_parallel'):
        _port(model_dir, data_parallel=n + 1)
