"""CTC forced alignment and the remaining CLIs of the PyTorch port against
the JAX package, on the CPU: `decode/ctc_utils` (the Viterbi, its tie
order, peaks and timestamps), `bin/alignment.py`'s TextGrids,
`cli/transcribe.py` (`--align`, `--context_path` and a plain decode), the
demo app's reply to a POST, and the two scoring tools.  The model is the
reshaped tiny model of tests/torch_tiny.py.
"""

import contextlib
import http.client
import io
import json
import threading
from http.server import HTTPServer

import numpy as np
import pytest
import torch
import yaml

from reverb_tpu.decode import ctc_utils as jcu
from reverb_tpu_torch.decode import ctc_utils as tcu

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

TEXTS = ['a b ab c', 'ab c a', 'c ab a b ab', 'b a c']


def _log_probs(T, V, seed, ties):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, V).astype(np.float32)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    if ties:        # a coarse grid: many equal scores meet in the Viterbi
        lp = np.round(lp * 2) / 2
    return lp.astype(np.float32)


@pytest.mark.parametrize('seed,T,labels,ties', [
    (0, 30, [1, 2, 3], False),
    (1, 25, [2, 2, 2, 1], False),             # repeated tokens
    (2, 40, [1, 1, 3, 3, 2, 2], True),        # repeats and ties
    (3, 12, [3, 1, 2, 1, 3, 2], True),        # 2L + 1 > T: a tight path
    (4, 2, [4], True),
])
def test_force_align_equals_jax(seed, T, labels, ties):
    """The port's Viterbi equals reverb_tpu's, frame by frame: the first of
    (stay, from one back, from two back) wins a tie, as jnp.argmax; then
    the peaks and their timestamps."""
    lp = _log_probs(T, 6, seed, ties)
    want = jcu.force_align(lp, labels, 0)
    got = tcu.force_align(torch.from_numpy(lp), labels, 0)
    assert got == want
    peaks = tcu.gen_ctc_peak_time(got, 0)
    assert peaks == jcu.gen_ctc_peak_time(want, 0)
    for kw in ({}, {'frame_rate': 0.03, 'max_token_duration': 0.5}):
        assert (tcu.gen_timestamps_from_peak(peaks, T * 0.04, **kw)
                == jcu.gen_timestamps_from_peak(peaks, T * 0.04, **kw))


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """The reshaped tiny model dir, a data list of 4 WAVs with texts, and
    a config with absolute paths for the alignment scripts."""
    from torch_tiny import reshaped_tiny_dir, speechy_wav
    d = reshaped_tiny_dir(tmp_path_factory.mktemp('torch_align'))
    lines = []
    for i, text in enumerate(TEXTS):
        wav = speechy_wav(d / f'u{i}.wav', 1.0 + 0.3 * i, seed=i)
        lines.append(json.dumps({'key': f'u{i}', 'wav': str(wav),
                                 'txt': text, 'style': 'v'}))
    (d / 'data.list').write_text('\n'.join(lines) + '\n')
    conf = yaml.safe_load((d / 'config.yaml').read_text())
    tk = conf['tokenizer_conf']
    tk['symbol_table_path'] = str(d / tk['symbol_table_path'])
    tk['bpe_path'] = str(d / tk['bpe_path'])
    conf['cmvn_conf']['cmvn_file'] = str(d / 'global_cmvn')
    conf['dataset_conf']['fbank_conf']['dither'] = 0.0
    (d / 'align.yaml').write_text(yaml.safe_dump(conf))
    (d / 'context.txt').write_text('c\nb a\nab c\n')
    return d


def test_alignment_textgrids_byte_identical(tiny, tmp_path):
    from reverb_tpu.bin import alignment as jal
    from reverb_tpu_torch.bin import alignment as tal
    args = ['--config', str(tiny / 'align.yaml'), '--checkpoint',
            str(tiny / 'model.npz'), '--input_file', str(tiny / 'data.list')]
    jal.main(args + ['--result_dir', str(tmp_path / 'jax')])
    tal.main(args + ['--result_dir', str(tmp_path / 'torch'), '--device',
                     'cpu'])
    for i in range(len(TEXTS)):
        name = f'u{i}.TextGrid'
        want = (tmp_path / 'jax' / name).read_bytes()
        assert (tmp_path / 'torch' / name).read_bytes() == want
        assert b'intervals [1]:' in want


@pytest.mark.parametrize('extra', [
    ['--align', '--label', 'a b ab c'],
    ['--context_path', 'context.txt', '--context_score', '3.0'],
    ['-t'],
    [],
])
def test_transcribe_equals_jax(tiny, extra):
    """`transcribe -m DIR` (forced alignment, context biasing, a CTM with
    token times, plain text): the port's result equals reverb_tpu's."""
    from reverb_tpu.cli import transcribe as jtr
    from reverb_tpu_torch.cli import transcribe as ttr
    extra = [str(tiny / a) if a == 'context.txt' else a for a in extra]
    argv = [str(tiny / 'a.wav'), '-m', str(tiny), *extra]
    with contextlib.redirect_stdout(io.StringIO()):
        want = jtr.main(argv)
        got = ttr.main(argv + ['--device', 'cpu'])
    assert got == want and want


def test_transcribe_refuses_what_is_not_ported(tiny):
    from reverb_tpu_torch.cli import transcribe as ttr
    # --paraformer without a model directory is the hub route
    with pytest.raises(ValueError, match='downloads'):
        ttr.main([str(tiny / 'a.wav'), '--paraformer', '--device', 'cpu'])
    with pytest.raises(ValueError, match='downloads'):
        ttr.main([str(tiny / 'a.wav'), '-l', 'english'])
    if not torch.cuda.is_available():       # --device defaults to cuda
        with pytest.raises(RuntimeError, match='cuda'):
            ttr.main([str(tiny / 'a.wav'), '-m', str(tiny)])


def _post(port, wav):
    boundary = 'testboundary'
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="audio";'
            f' filename="a.wav"\r\n\r\n').encode() + wav.read_bytes() + \
        f'\r\n--{boundary}--\r\n'.encode()
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
    try:
        conn.request('POST', '/transcribe', body=body, headers={
            'Content-Type': f'multipart/form-data; boundary={boundary}'})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_app_reply_equals_jax(tiny):
    """One POST of a WAV to each package's demo handler on 127.0.0.1: the
    same status and the same JSON body."""
    from reverb_tpu.cli import app as japp
    from reverb_tpu.cli.reverb import load_model as jload
    from reverb_tpu_torch.cli import app as tapp
    from reverb_tpu_torch.cli.reverb import load_model as tload
    replies = []
    for app, model in ((japp, jload(str(tiny))),
                       (tapp, tload(str(tiny), device='cpu'))):
        server = HTTPServer(('127.0.0.1', 0), app.make_handler(
            model, 'ctc_prefix_beam_search'))
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            replies.append(_post(server.server_address[1], tiny / 'a.wav'))
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=30)
        assert not th.is_alive()
    assert replies[0] == replies[1]
    assert replies[0][0] == 200 and json.loads(replies[0][1])['text']


def test_scoring_tools_equal_jax(tmp_path, capsys):
    """aggregate_scoring over fstalign JSON logs and scoring_commands over
    a directory of CTMs print what reverb_tpu's print."""
    from reverb_tpu.eval import aggregate_scoring as jagg
    from reverb_tpu.eval import scoring_commands as jsc
    from reverb_tpu_torch.eval import aggregate_scoring as tagg
    from reverb_tpu_torch.eval import scoring_commands as tsc
    logs = tmp_path / 'logs'
    logs.mkdir()
    for i, (ins, dels, subs, n) in enumerate([(1, 2, 3, 40), (0, 1, 5, 27),
                                               (4, 0, 0, 13)]):
        (logs / f'f{i}.json').write_text(json.dumps({'wer': {'bestWER': {
            'insertions': ins, 'deletions': dels, 'substitutions': subs,
            'numErrors': ins + dels + subs, 'numWordsInReference': n}}}))
    hyp = tmp_path / 'hyp'
    (hyp / 'sub').mkdir(parents=True)
    for name in ('x.ctm', 'sub/y.ctm'):
        (hyp / name).write_text('x 1 0.00 0.10 a 1.00\n')
    outs = []
    for agg, sc in ((jagg, jsc), (tagg, tsc)):
        agg.main([str(logs)])
        sc.main(['/bin/fstalign', str(tmp_path / 'ref'), str(hyp),
                 str(tmp_path / 'out'), '--synonyms-file', 'syn.txt'])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert 'TOTAL WER' in outs[0] and outs[0].count('fstalign wer') == 2
