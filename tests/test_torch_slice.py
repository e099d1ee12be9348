"""The serving slice end to end: the JAX ReverbASR (reference) and the
PyTorch port (reverb_tpu_torch, device='cpu') transcribe the same wav with
the same tiny model, and must produce byte-identical CTM and TXT for
ctc_prefix_beam_search and attention_rescoring, dense and with blank-skip.

The tiny model's random CTC head is reshaped like a trained one before the
comparison (flat random logits take a degenerate path): weight ×8, each
token's logit centred over the wav's frames, and the blank bias raised to
the 75th percentile of (best non-blank − blank), so ~75% of frames are
blank-top and the rest spread over the vocabulary.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import build_tiny_model_dir, write_wav

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

MODES = ['ctc_prefix_beam_search', 'attention_rescoring']
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def tiny_dir(tmp_path_factory):
    from reverb_tpu.cli.reverb import ReverbASR
    from reverb_tpu.convert.torch_ckpt import load_npz, save_npz
    from reverb_tpu.decode.api import encode_and_ctc
    from reverb_tpu.models import ctc as ctc_mod

    d = build_tiny_model_dir(tmp_path_factory.mktemp('torch_slice'))
    wav = write_wav(d / 'a.wav', seconds=3.0)
    ref = ReverbASR(str(d / 'config.yaml'), str(d / 'model.npz'))
    feats = np.asarray(ref.compute_feats(str(wav)))
    T = feats.shape[0]
    params, _ = load_npz(str(d / 'model.npz'))
    w = np.asarray(params['ctc']['ctc_lo']['weight']) * 8
    probe = dict(ref.params)
    probe['ctc'] = {'ctc_lo': {'weight': jnp.asarray(w),
                               'bias': jnp.zeros(w.shape[0])}}
    enc, lens, _ = encode_and_ctc(probe, ref.model_config,
                                  jnp.asarray(feats[None]), jnp.asarray([T]),
                                  jnp.asarray([1.0, 0.0]))
    logits = np.asarray(ctc_mod.ctc_logits(probe['ctc'], enc))[0][
        :int(lens[0])]
    bias = -logits.mean(0)
    logits = logits + bias
    bias[0] += float(np.quantile(logits[:, 1:].max(-1) - logits[:, 0], 0.75))
    params['ctc']['ctc_lo'] = {'weight': w, 'bias': bias.astype(np.float32)}
    save_npz(str(d / 'model.npz'), params)
    return d


@pytest.fixture(scope='module')
def both_models(tiny_dir):
    from reverb_tpu.cli.reverb import ReverbASR as JaxASR
    from reverb_tpu_torch.cli.reverb import ReverbASR as TorchASR
    cfg, ckpt = str(tiny_dir / 'config.yaml'), str(tiny_dir / 'model.npz')
    return JaxASR(cfg, ckpt), TorchASR(cfg, ckpt, device='cpu')


@pytest.mark.parametrize('fmt', ['ctm', 'txt'])
@pytest.mark.parametrize('threshold', [0.0, 0.95])
def test_port_output_byte_identical(both_models, tiny_dir, fmt, threshold):
    ref, port = both_models
    wav = str(tiny_dir / 'a.wav')
    want = ref.transcribe_modes(wav, MODES, format=fmt,
                                blank_skip_threshold=threshold)
    got = port.transcribe_modes(wav, MODES, format=fmt,
                                blank_skip_threshold=threshold)
    assert got == want
    # the comparison is not vacuous: words come out of both modes
    assert all(len(out.split()) > 0 for out in want)


def test_ctc_mode_alone_byte_identical(both_models, tiny_dir):
    """ctc_prefix_beam_search alone takes the JAX package's generic decode
    path; the port's single path gives the same bytes."""
    ref, port = both_models
    wav = str(tiny_dir / 'a.wav')
    want = ref.transcribe(wav, 'ctc_prefix_beam_search', format='ctm')
    got = port.transcribe(wav, 'ctc_prefix_beam_search', format='ctm')
    assert got == want and want


def test_rescoring_differs_from_ctc_best(both_models, tiny_dir):
    """The tiny head makes attention rescoring re-rank the nbest, so the
    rescoring path is exercised, not just passed through."""
    _, port = both_models
    ctc, resc = port.transcribe_modes(str(tiny_dir / 'a.wav'), MODES,
                                      format='txt')
    assert ctc != resc


def test_cuda_device_requires_a_card(tiny_dir, monkeypatch):
    """device='cuda' on a machine without CUDA raises instead of running on
    the CPU."""
    from reverb_tpu_torch.cli.reverb import ReverbASR
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        ReverbASR(str(tiny_dir / 'config.yaml'), str(tiny_dir / 'model.npz'),
                  device='cuda')


def test_recognize_wav_cli(tiny_dir, tmp_path):
    """The console entry writes the same CTM files as the JAX CLI."""
    from reverb_tpu.cli import recognize_wav as jax_cli
    from reverb_tpu_torch.cli import recognize_wav as torch_cli
    args = ['--audio_file', str(tiny_dir / 'a.wav'), '--model',
            str(tiny_dir), '--modes', *MODES]
    jax_cli.main(args + ['--result_dir', str(tmp_path / 'jax')])
    torch_cli.main(args + ['--result_dir', str(tmp_path / 'torch'),
                           '--device', 'cpu'])
    for mode in MODES:
        a = (tmp_path / 'jax' / mode / 'a.ctm').read_bytes()
        b = (tmp_path / 'torch' / mode / 'a.ctm').read_bytes()
        assert a == b and a


_NO_JAX = textwrap.dedent('''
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in ('jax', 'jaxlib', 'yaml'):
                raise ImportError('blocked: ' + name)
            return None

    sys.meta_path.insert(0, Block())
    import torch
    import reverb_tpu_torch
    from reverb_tpu_torch.decode.api import decode
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model

    conf = presets.reverb_tiny()
    conf['encoder_conf']['num_blocks'] = 2
    cfg = ModelConfig.from_config(conf)
    model = build_model(cfg, 'cpu', generator=torch.Generator().manual_seed(0))
    feats = torch.randn(2, 300, 80, generator=torch.Generator().manual_seed(1))
    out = decode(model, ['ctc_prefix_beam_search', 'attention_rescoring'],
                 feats, torch.tensor([300, 200]), beam_size=4,
                 cat_embs=torch.tensor([1.0, 0.0]), ctc_weight=0.1)
    assert len(out['attention_rescoring']) == 2

    # one training step of the port, and the LayerNorm kernel module
    from reverb_tpu_torch.ops import layer_norm
    from reverb_tpu_torch.train.trainer import (TrainConfig, build_optimizer,
                                                make_train_step)
    assert layer_norm.eligible(torch.zeros(2, 128))
    model = build_model(cfg, 'cpu', generator=torch.Generator().manual_seed(0),
                        train=True)
    opt, _ = build_optimizer(TrainConfig.from_config(conf), model)
    step = make_train_step(cfg, opt, grad_clip=50.0)
    batch = {'feats': feats[:, :120], 'feats_lengths': torch.tensor([120, 90]),
             'target': torch.tensor([[3, 4, 5], [6, 7, -1]]),
             'target_lengths': torch.tensor([3, 2]),
             'cat_embs': torch.tensor([[1.0, 0.0], [0.0, 1.0]])}
    m = step(model, batch, torch.Generator().manual_seed(2))
    assert m['skipped'] == 0.0 and m['loss'] > 0
    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'yaml')]
    assert not bad, bad
    print('OK')
''')


def test_port_imports_no_jax_or_yaml():
    """The port and its decode path run with jax, jaxlib and yaml blocked:
    a GPU deployment of the port needs neither."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith('OK')


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, 'reverb_tpu_torch')
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                src = open(os.path.join(root, f)).read()
                assert 'import jax' not in src and 'from jax' not in src, f
