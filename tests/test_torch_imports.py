"""The PyTorch port imports nothing of the JAX package and no jax.

The port keeps its own copies of the host modules it needs
(decode/results.py, decode/align.py, text/, the `.pt` reader in
convert.py, diar/'s host steps, eval/); each copy is held here to the JAX package's original on the
same inputs.  The tests may import reverb_tpu; the port may not.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import build_tiny_model_dir
from reverb_tpu.convert import torch_ckpt as jckpt
from reverb_tpu.decode import align as jalign
from reverb_tpu.decode import results as jresults
from reverb_tpu.text import tokenizer as jtok
from reverb_tpu_torch import convert as tconvert
from reverb_tpu_torch.decode import align as talign
from reverb_tpu_torch.decode import results as tresults
from reverb_tpu_torch.text import tokenizer as ttok

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r'''
import importlib, importlib.util, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import reverb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(reverb_tpu_torch.__path__,
                                               'reverb_tpu_torch.')]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    'chip_smoke', sys.argv[1] + '/chip_smoke.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ('jax', 'reverb_tpu', 'transformers')
             or m.startswith(('jax.', 'reverb_tpu.', 'transformers.')))
print(json.dumps({'modules': names, 'bad': bad}))
'''


def test_port_imports_no_jax_and_no_reverb_tpu():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT / 'tests'), timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    # the walk found the package's modules, the copies among them
    for name in ('reverb_tpu_torch.cli.reverb', 'reverb_tpu_torch.convert',
                 'reverb_tpu_torch.decode.api',
                 'reverb_tpu_torch.decode.align',
                 'reverb_tpu_torch.text.rev_bpe',
                 'reverb_tpu_torch.diar.models',
                 'reverb_tpu_torch.diar.pyannet',
                 'reverb_tpu_torch.diar.convert',
                 'reverb_tpu_torch.diar.pipeline',
                 'reverb_tpu_torch.diar.assign',
                 'reverb_tpu_torch.eval.wer', 'reverb_tpu_torch.eval.der',
                 'reverb_tpu_torch.eval.wder',
                 'reverb_tpu_torch.bin.infer_diarization',
                 'reverb_tpu_torch.data.dataset',
                 'reverb_tpu_torch.data.processor',
                 'reverb_tpu_torch.data.rev_processor',
                 'reverb_tpu_torch.data.source',
                 'reverb_tpu_torch.text.langid',
                 'reverb_tpu_torch.train.executor',
                 'reverb_tpu_torch.train.watchdog',
                 'reverb_tpu_torch.utils.config',
                 'reverb_tpu_torch.utils.tracking',
                 'reverb_tpu_torch.utils.profiling',
                 'reverb_tpu_torch.models.registry',
                 'reverb_tpu_torch.models.transducer',
                 'reverb_tpu_torch.models.encoders_alt',
                 'reverb_tpu_torch.decode.transducer_search',
                 'reverb_tpu_torch.decode.transducer_device',
                 'reverb_tpu_torch.bin.train',
                 'reverb_tpu_torch.bin.recognize',
                 'reverb_tpu_torch.bin.get_loss',
                 'reverb_tpu_torch.bin.average_model',
                 'reverb_tpu_torch.bin.alignment',
                 'reverb_tpu_torch.cli.transcribe',
                 'reverb_tpu_torch.cli.app',
                 'reverb_tpu_torch.decode.context_graph',
                 'reverb_tpu_torch.decode.ctc_utils',
                 'reverb_tpu_torch.data.deep_bias',
                 'reverb_tpu_torch.models.context_adaptor',
                 'reverb_tpu_torch.eval.aggregate_scoring',
                 'reverb_tpu_torch.eval.scoring_commands',
                 'reverb_tpu_torch.frontend.device_feats',
                 'reverb_tpu_torch.native',
                 'reverb_tpu_torch.diar.train_segmentation',
                 'reverb_tpu_torch.diar.train_embedding',
                 'reverb_tpu_torch.data.wav_distortion',
                 'reverb_tpu_torch.data.kaldi_io',
                 'reverb_tpu_torch.ops.quant',
                 'reverb_tpu_torch.export.aot',
                 'reverb_tpu_torch.bin.export',
                 'reverb_tpu_torch.parallel',
                 'reverb_tpu_torch.parallel.mesh',
                 'reverb_tpu_torch.parallel.collectives',
                 'reverb_tpu_torch.parallel.sharding',
                 'reverb_tpu_torch.models.whisper',
                 'reverb_tpu_torch.text.whisper_tokenizer',
                 'reverb_tpu_torch.models.ssl',
                 'reverb_tpu_torch.models.ctl',
                 'reverb_tpu_torch.models.k2_model',
                 'reverb_tpu_torch.ops.fsa',
                 'reverb_tpu_torch.train.lora',
                 'reverb_tpu_torch.train.teacher_student'):
        assert name in out['modules']
    assert out['bad'] == []


def test_decode_result_fields_match():
    import dataclasses
    names = [(f.name, f.default) for f in
             dataclasses.fields(tresults.DecodeResult)]
    assert names == [(f.name, f.default) for f in
                     dataclasses.fields(jresults.DecodeResult)]


def _seeded_path(seed, n=40):
    """Token ids over TINY_PIECES-like strings, rising frame times (some
    gaps under and some over 100 ms), confidences."""
    rng = np.random.RandomState(seed)
    vocab = ['▁a', '▁b', 'c', 'a', '▁', '<unk>', 'b', '▁ab', '<sw>']
    tokens = [int(t) for t in rng.randint(0, len(vocab), n)]
    times = np.cumsum(rng.randint(1, 30, n)).tolist()
    conf = rng.rand(n).round(3).tolist()
    return tokens, times, conf, vocab.__getitem__


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_ctc_align_and_ctm_match_jax(seed):
    tokens, times, conf, id2tok = _seeded_path(seed)
    for c in (conf, None):
        for shift in (0.0, 40.0):
            got = talign.ctc_align(tokens, times, c, id2tok, 40.0, shift)
            want = jalign.ctc_align(tokens, times, c, id2tok, 40.0, shift)
            assert got == want and got
            for adj in (0, 230):
                g = talign.adjust_model_time_offset(got, adj)
                w = jalign.adjust_model_time_offset(want, adj)
                assert g == w
                assert talign.hyps_to_ctm('f.wav', g) == \
                    jalign.hyps_to_ctm('f.wav', w)
                assert talign.hyps_to_txt(g) == jalign.hyps_to_txt(w)


@pytest.fixture(scope='module')
def tiny_dir(tmp_path_factory):
    return build_tiny_model_dir(tmp_path_factory.mktemp('tiny_tok'))


_LINES = ['a b ab', 'ab c <sw> b', 'cab  a <unk> b', '', 'c c c a']


@pytest.mark.parametrize('kind', ['char', 'rev_bpe'])
def test_tokenizers_round_trip_like_jax(tiny_dir, kind):
    conf = {'symbol_table_path': str(tiny_dir / 'tk.units.txt'),
            'bpe_path': str(tiny_dir / 'tk.model'),
            'non_lang_syms_path': None, 'remove_sw': True,
            'replace_unk_as_unknown': True}
    configs = {'tokenizer': kind, 'tokenizer_conf': conf}
    got, want = ttok.init_tokenizer(configs), jtok.init_tokenizer(configs)
    assert type(got).__name__ == type(want).__name__
    assert got.symbol_table == want.symbol_table
    for line in _LINES:
        toks, ids = got.tokenize(line)
        assert (toks, ids) == want.tokenize(line)
        assert got.detokenize(ids) == want.detokenize(ids)
    ids = list(range(len(got.symbol_table)))
    assert got.detokenize(ids) == want.detokenize(ids)


def test_bpe_tokenizer_matches_jax(tiny_dir):
    conf = {'symbol_table_path': str(tiny_dir / 'tk.units.txt'),
            'bpe_path': str(tiny_dir / 'tk.model')}
    got = ttok.init_tokenizer({'tokenizer': 'bpe', 'tokenizer_conf': conf})
    want = jtok.init_tokenizer({'tokenizer': 'bpe', 'tokenizer_conf': conf})
    for line in _LINES:
        assert got.tokenize(line) == want.tokenize(line)


_LAZY_PROBE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from reverb_tpu_torch.text import tokenizer
t = tokenizer.init_tokenizer({'tokenizer': sys.argv[2],
                              'tokenizer_conf': {'model': 'm'}})
print(json.dumps({'type': type(t).__name__,
                  'transformers': 'transformers' in sys.modules}))
'''


class _FakeHF:
    """A stand-in for a transformers tokenizer (nothing is downloaded)."""
    made = []

    @classmethod
    def from_pretrained(cls, name, **kw):
        cls.made.append((name, kw))
        return cls()

    def tokenize(self, line):
        return line.split()

    def convert_tokens_to_ids(self, toks):
        return [len(t) for t in toks]


@pytest.mark.parametrize('kind', ['whisper', 'hugging_face', 'paraformer'])
def test_unported_tokenizers_raise(kind, tmp_path, monkeypatch):
    """No tokenizer raises any more.  Whisper's two route to the port's
    gated wrappers (text/whisper_tokenizer.py): building one imports no
    transformers (a fresh process), its first use imports it and builds
    the named tokenizer (a stand-in module here); the paraformer branch
    builds the tokenizer JAX's builds (tests/test_torch_paraformer.py
    holds its tokenization to JAX's)."""
    if kind != 'paraformer':
        import types
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        res = subprocess.run([sys.executable, '-c', _LAZY_PROBE, str(ROOT),
                              kind], capture_output=True, text=True,
                             env=env, cwd=str(ROOT / 'tests'), timeout=300)
        assert res.returncode == 0, res.stderr
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out == {'type': {'whisper': 'WhisperTokenizer',
                                'hugging_face': 'HuggingFaceTokenizer'}[kind],
                       'transformers': False}
        fake = types.ModuleType('transformers')
        fake.WhisperTokenizer = fake.AutoTokenizer = _FakeHF
        monkeypatch.setitem(sys.modules, 'transformers', fake)
        _FakeHF.made.clear()
        tok = ttok.init_tokenizer({'tokenizer': kind, 'tokenizer_conf': {
            'model': 'some/model', 'is_multilingual': True}})
        assert tok.tokenize('ab c') == (['ab', 'c'], [2, 1])
        assert _FakeHF.made == ([('openai/whisper-tiny',
                                  {'language': 'en', 'task': 'transcribe'})]
                                if kind == 'whisper'
                                else [('some/model', {})])
        return
    from reverb_tpu_torch.text.paraformer_tokenizer import \
        ParaformerTokenizer
    units = tmp_path / 'units.txt'
    units.write_text('<blank> 0\n<unk> 1\na 2\n你 3\n')
    conf = {'tokenizer': kind,
            'tokenizer_conf': {'symbol_table_path': str(units)}}
    got = ttok.init_tokenizer(conf)
    want = jtok.init_tokenizer(conf)
    assert isinstance(got, ParaformerTokenizer)
    assert got.symbol_table == want.symbol_table
    assert got.detokenize([3, 2]) == want.detokenize([3, 2])


@pytest.mark.parametrize('wrap', ['raw', 'model0', 'state_dict'])
def test_load_torch_state_dict_matches_jax(tmp_path, wrap):
    g = torch.Generator().manual_seed(0)
    sd = {
        'module.encoder.global_cmvn.mean': torch.randn(4, generator=g),
        'encoder.normalize.std': torch.rand(4, generator=g),
        'encoder.encoders.0.conv_module.norm.weight':
            torch.randn(8, generator=g).to(torch.bfloat16),
        'encoder.encoders.0.conv_module.norm.num_batches_tracked':
            torch.tensor(3),
        'decoder.embed.0.weight': torch.randn(5, 3, generator=g),
        'ctc.ids': torch.arange(6, dtype=torch.int64),
        'meta': 'not a tensor',
    }
    obj = {'raw': sd, 'model0': {'model0': sd, 'optimizer0': {}},
           'state_dict': {'state_dict': sd}}[wrap]
    path = tmp_path / 'ckpt.pt'
    torch.save(obj, path)
    got = tconvert.load_torch_state_dict(str(path))
    want = jckpt.load_torch_state_dict(str(path))
    assert sorted(got) == sorted(want)
    assert 'encoder.encoders.0.norm.weight' in got
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert tconvert._SKIP_SUFFIXES == jckpt._SKIP_SUFFIXES
