"""The port's dataset path end to end against the JAX package's, f32 on
the CPU: `bin/train.py` (data pipeline, executor, snapshots, CV, epoch
checkpoints, the JSONL tracker), `bin/get_loss.py`,
`bin/average_model.py` and `bin/recognize.py`, plus the executor's
snapshot rules and the dynamic-chunk training draw.

Training: both packages start from one `.npz` the JAX package wrote (its
init_params with the CMVN stats inside) and train a tiny LSL conformer at
width 128, so every LayerNorm takes the K5/K6 functions (plain on the
CPU), for 2 epochs × 2 steps with dropout 0, spec_aug off, dither 0 and
Adam eps 1e-3 (tests/test_torch_train.py says why).  The data pipelines'
batches are equal (tests/test_torch_data.py), so the checkpoints agree
within the three-step test's tolerances.
"""

import json
import math
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from helpers import TINY_PIECES, write_sp_model
from reverb_tpu.convert.torch_ckpt import (flatten_params, load_npz,
                                           save_npz)
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import encoder as jam_encoder
from reverb_tpu.models import presets as jpresets
from reverb_tpu.utils import common as jcommon
from reverb_tpu.utils import tracking as jtracking
from reverb_tpu_torch import convert
from reverb_tpu_torch.bin import average_model as tavg
from reverb_tpu_torch.bin import get_loss as tget_loss
from reverb_tpu_torch.bin import recognize as trecognize
from reverb_tpu_torch.bin import train as ttrain
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.ops import flash_attention as fa
from reverb_tpu_torch.ops import layer_norm as ln
from reverb_tpu_torch.train import checkpoint as tckpt
from reverb_tpu_torch.train import trainer as ttr
from reverb_tpu_torch.train.executor import Executor
from reverb_tpu_torch.utils import common as tcommon
from reverb_tpu_torch.utils import tracking as ttracking

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

D = 128
TEXTS = ['a b ab c', 'ab c a', 'c ab a b ab', 'b a c', 'a c c ab', 'ab b']


@pytest.fixture(autouse=True)
def _single_device_pallas():
    """JAX's bin/train.py registers a process-global Pallas mesh
    (reverb_tpu/ops/pallas_mesh.py); it would send later JAX kernels in
    this worker through shard_map.  Each test leaves it as it found it."""
    from reverb_tpu.ops import pallas_mesh
    saved = pallas_mesh.get_pallas_mesh()
    pallas_mesh.set_pallas_mesh(None)
    yield
    pallas_mesh._REGISTERED = saved


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


def _write_list(path, entries):
    path.write_text(''.join(json.dumps(e) + '\n' for e in entries))
    return path


def _write_recipe(d):
    """Corpus (4 train + 2 CV WAVs of 1.2 s), tokenizer, CMVN stats,
    the training config and the JAX-written initial checkpoint in d."""
    entries = []
    for i in range(6):
        wav = _write_wav(d / f'u{i}.wav', 19200, 20 + i)
        entries.append({'key': f'job{i}_utt{i}', 'wav': str(wav),
                        'txt': TEXTS[i],
                        'style': 'verbatim' if i % 2 else 'nonverbatim'})
    _write_list(d / 'train.list', entries[:4])
    _write_list(d / 'cv.list', entries[4:])
    symbols = [p for p, _, _ in TINY_PIECES]
    (d / 'tk.units.txt').write_text(
        ''.join(f'{s} {i}\n' for i, s in enumerate(symbols)))
    write_sp_model(d / 'tk.model', TINY_PIECES, model_type=1)
    rng = np.random.RandomState(0)
    mean = rng.randn(80) * 2 + 8
    (d / 'global_cmvn').write_text(json.dumps({
        'mean_stat': list(mean * 100), 'frame_num': 100,
        'var_stat': list((mean ** 2 + rng.rand(80) * 4 + 1) * 100)}))

    conf = jpresets.reverb_config(output_size=D, attention_heads=2,
                                  linear_units=64, num_blocks=1, dec_blocks=1,
                                  r_blocks=1, vocab_size=len(symbols),
                                  dropout=0.0)
    conf['decoder'] = 'lsl_bitransformer'
    conf.update({
        'cmvn': 'global_cmvn',
        'cmvn_conf': {'cmvn_file': str(d / 'global_cmvn'),
                      'is_json_cmvn': True},
        'tokenizer': 'rev_bpe',
        'tokenizer_conf': {'symbol_table_path': str(d / 'tk.units.txt'),
                           'bpe_path': str(d / 'tk.model'),
                           'non_lang_syms_path': None, 'remove_sw': True,
                           'replace_unk_as_unknown': True},
        'optim_conf': {'lr': 1e-3, 'eps': 1e-3},
        'scheduler_conf': {'warmup_steps': 4},
        'snapshot_saving_conf': {'save_interval': 3,
                                 'save_optimizer_every': 1},
        'max_epoch': 2})
    conf['dataset_conf'].update({
        'filter_conf': {'max_length': 2000, 'min_length': 5},
        'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                       'frame_shift': 10, 'dither': 0.0},
        'spec_aug': False, 'shuffle': True,
        'shuffle_conf': {'shuffle_size': 3}, 'sort': True,
        'sort_conf': {'sort_size': 2},
        # one padded shape (128 frames, 32 tokens): one JAX compile
        'batch_conf': {'batch_type': 'static', 'batch_size': 2,
                       'pad_len_multiple': 32}})
    cfg_path = d / 'train_config.yaml'
    cfg_path.write_text(yaml.safe_dump(conf))

    from reverb_tpu.frontend.cmvn import load_cmvn
    jcfg = jam.ModelConfig.from_config(conf)
    params = jam.init_params(jax.random.PRNGKey(0), jcfg,
                             cmvn=load_cmvn(str(d / 'global_cmvn'), True))
    # a non-trivial CTC head, so that the decode modes emit words
    w = np.asarray(params['ctc']['ctc_lo']['weight']) * 8
    params['ctc']['ctc_lo']['weight'] = w
    save_npz(str(d / 'init.npz'), params)
    return cfg_path


def _train_argv(d, cfg_path, model_dir, *extra):
    return ['--config', str(cfg_path), '--train_data', str(d / 'train.list'),
            '--cv_data', str(d / 'cv.list'), '--model_dir', str(model_dir),
            '--checkpoint', str(d / 'init.npz'), '--max_epoch', '2',
            '--log_interval', '1', '--seed', '3', *extra]


@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """The recipe's files and the JAX package's training run (`exp_jax`),
    made once per test run and shared by the pytest-xdist workers, under
    a file lock: the JAX bin/train compiles its step anew each step
    (~9 s each here), the port's run takes 2-3 s."""
    import fcntl
    from reverb_tpu.bin import train as jtrain
    from reverb_tpu.ops import pallas_mesh
    base = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        base = base.parent               # common to the run's workers
    d = base / 'torch_train_bin_shared'
    with open(f'{d}.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / 'done').exists():
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            cfg_path = _write_recipe(d)
            saved = pallas_mesh.get_pallas_mesh()
            try:
                jtrain.main(_train_argv(d, cfg_path, d / 'exp_jax'))
            finally:
                pallas_mesh._REGISTERED = saved
            (d / 'done').write_text('')
    return d, d / 'train_config.yaml'


@pytest.fixture(scope='module')
def trained(recipe, tmp_path_factory):
    """The port's training run from the same initial checkpoint."""
    d, cfg_path = recipe
    tdir = tmp_path_factory.mktemp('exp_torch')
    launches = (fa.LAUNCHES, fa.BWD_LAUNCHES, ln.LAUNCHES, ln.BWD_LAUNCHES)
    ex = ttrain.main(_train_argv(d, cfg_path, tdir, '--device', 'cpu'))
    # on the CPU the wrappers take their plain versions: no launch
    assert launches == (fa.LAUNCHES, fa.BWD_LAUNCHES, ln.LAUNCHES,
                        ln.BWD_LAUNCHES)
    return d, d / 'exp_jax', tdir, ex


def _yaml(path):
    return yaml.safe_load(path.read_text())


def test_train_checkpoints_agree_with_jax(trained):
    d, jdir, tdir, ex = trained
    assert ex.step == 4
    for tag in ('step_3', 'epoch_0', 'epoch_1'):
        want, _ = load_npz(str(jdir / f'{tag}.npz'))
        want = flatten_params(want)
        with np.load(tdir / f'{tag}.npz') as z:
            got = {k: z[k] for k in z.files}
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f'{tag}: {k}')
    init = flatten_params(load_npz(str(d / 'init.npz'))[0])
    assert max(np.abs(v - init[k]).max() for k, v in got.items()) > 1e-4
    # the CMVN stats stay inside, untrained
    for k in ('encoder.global_cmvn.mean', 'encoder.global_cmvn.istd'):
        np.testing.assert_array_equal(got[k], init[k])


def test_train_yaml_and_cv_loss_agree_with_jax(trained):
    _, jdir, tdir, _ = trained
    assert _yaml(tdir / 'train.yaml') == _yaml(jdir / 'train.yaml')
    for tag in ('step_3', 'epoch_0', 'epoch_1'):
        want, got = _yaml(jdir / f'{tag}.yaml'), _yaml(tdir / f'{tag}.yaml')
        assert sorted(got) == sorted(want)
        assert math.isfinite(got['cv_loss'])
        np.testing.assert_allclose(got['cv_loss'], want['cv_loss'],
                                   rtol=1e-4, err_msg=tag)
        for k in ('epoch', 'step', 'frames_seen', 'tag'):
            assert got.get(k) == want.get(k), (tag, k)
        np.testing.assert_allclose(got['lr'], want['lr'], rtol=1e-6)


def test_train_metrics_jsonl_agree_with_jax(trained):
    _, jdir, tdir, _ = trained

    def records(path):
        return [json.loads(line) for line in
                (path / 'metrics.jsonl').read_text().splitlines()]
    want, got = records(jdir), records(tdir)
    assert [r['step'] for r in got] == [r['step'] for r in want] == \
        [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k not in ('ts', 'train/grad_norm'):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                           err_msg=k)
        np.testing.assert_allclose(g['train/grad_norm'],
                                   w['train/grad_norm'], rtol=1e-3)


def test_checkpoints_cross_load(trained):
    """Each package loads the other's epoch_1.npz; the port resumes the
    JAX optimizer state beside it (epoch_1.opt.npz: 4 steps)."""
    from reverb_tpu.train.checkpoint import load_checkpoint as jload
    d, jdir, tdir, _ = trained
    conf = _yaml(tdir / 'train.yaml')
    model = tam.build_model(tam.ModelConfig.from_config(conf), 'cpu',
                            generator=torch.Generator().manual_seed(0),
                            train=True, cmvn=(np.zeros(80), np.ones(80)))
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), model)
    info = tckpt.load_checkpoint(jdir / 'epoch_1.npz', model, opt)
    assert info['epoch'] == 1 and opt.count == 4   # the optax state
    assert all(float(m.abs().max()) > 0 for m in opt.nu)
    want = flatten_params(load_npz(str(jdir / 'epoch_1.npz'))[0])
    for k, v in convert.flat_from_state_dict(model.state_dict()).items():
        np.testing.assert_array_equal(v, want[k])
    params, _, jinfo = jload(tdir / 'epoch_1.npz')
    assert jinfo == _yaml(tdir / 'epoch_1.yaml')
    with np.load(tdir / 'epoch_1.npz') as z:
        for k, v in flatten_params(params).items():
            np.testing.assert_array_equal(np.asarray(v), z[k])
    # the port's own optimizer state resumes with its count
    opt2, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), model)
    tckpt.load_checkpoint(tdir / 'epoch_1.npz', model, opt2)
    assert opt2.count == 4


def test_get_loss_agrees_with_jax(trained, tmp_path):
    from reverb_tpu.bin import get_loss as jget_loss
    d, jdir, tdir, _ = trained
    argv = ['--config', str(tdir / 'train.yaml'), '--checkpoint',
            str(jdir / 'epoch_1.npz'), '--test_data', str(d / 'train.list')]
    jget_loss.main(argv + ['--output', str(tmp_path / 'loss_jax.txt')])
    tget_loss.main(argv + ['--output', str(tmp_path / 'loss_torch.txt'),
                           '--device', 'cpu'])
    # both packages shuffle the list unseeded here (list_shuffle stays on
    # in get_loss): compare by key
    def rows(name):
        return {r[0]: [float(x) for x in r[1:]] for r in
                (x.split() for x in
                 (tmp_path / name).read_text().splitlines())}
    want, got = rows('loss_jax.txt'), rows('loss_torch.txt')
    assert sorted(got) == sorted(want) and len(got) == 4
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=1e-4, err_msg=k)
        assert all(math.isfinite(x) for x in v)


@pytest.mark.parametrize('how', ['models', 'last_n', 'val_best'])
def test_average_model_equals_jax(trained, tmp_path, how):
    from reverb_tpu.bin import average_model as javg
    _, jdir, _, _ = trained
    src = tmp_path / 'src'
    shutil.copytree(jdir, src)
    argv = {'models': ['--models', str(src / 'epoch_0.npz'),
                       str(src / 'epoch_1.npz')],
            'last_n': ['--src_path', str(src), '--num', '2'],
            'val_best': ['--src_path', str(src), '--num', '2',
                         '--val_best']}[how]
    javg.main(argv + ['--dst_model', str(tmp_path / 'jax.npz')])
    tavg.main(argv + ['--dst_model', str(tmp_path / 'torch.npz')])
    with np.load(tmp_path / 'jax.npz') as a, \
            np.load(tmp_path / 'torch.npz') as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert b[k].dtype == a[k].dtype == np.float32
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


REC_MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search', 'attention',
             'attention_rescoring']


def test_recognize_text_byte_identical(trained, tmp_path):
    """recognize's `text` file of each mode equals JAX's byte for byte
    (the epoch_1 model; its CTC head was sharpened ×8 before training, and
    the decoder's eos logit is raised here so the attention beam ends)."""
    from reverb_tpu.bin import recognize as jrecognize
    d, jdir, _, _ = trained
    out = tmp_path
    params, _ = load_npz(str(jdir / 'epoch_1.npz'))
    for side in ('left_decoder', 'right_decoder'):
        ol = params['decoder'][side]['output_layer']
        bias = np.asarray(ol['bias']) * 4
        bias[-1] += 3.0
        ol['weight'] = np.asarray(ol['weight']) * 4
        ol['bias'] = bias.astype(np.float32)
    save_npz(str(out / 'rec.npz'), params)
    entries = [json.loads(x) for x in
               (d / 'train.list').read_text().splitlines()]
    _write_list(out / 'test.list', entries + [json.loads(x) for x in (
        d / 'cv.list').read_text().splitlines()][:1])
    argv = ['--config', str(jdir / 'train.yaml'), '--checkpoint',
            str(out / 'rec.npz'), '--test_data', str(out / 'test.list'),
            '--modes', *REC_MODES, '--batch_size', '2',
            '--override_config', 'dataset_conf.list_shuffle=false']
    jrecognize.main(argv + ['--result_dir', str(out / 'rec_jax')])
    trecognize.main(argv + ['--result_dir', str(out / 'rec_torch'),
                            '--device', 'cpu'])
    words = 0
    for mode in REC_MODES:
        want = (out / 'rec_jax' / mode / 'text').read_bytes()
        got = (out / 'rec_torch' / mode / 'text').read_bytes()
        assert got == want, mode
        rows = got.decode().splitlines()
        assert len(rows) == 5
        words += sum(len(r.split()) - 1 for r in rows)
    assert words > 0


def test_entry_points_default_to_cuda(recipe, tmp_path):
    """Without a card the four entry points raise unless --device cpu."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    d, cfg_path = recipe
    with pytest.raises(RuntimeError, match='cuda'):
        ttrain.main(_train_argv(d, cfg_path, tmp_path / 'x'))
    with pytest.raises(RuntimeError, match='cuda'):
        tget_loss.main(['--config', str(cfg_path), '--checkpoint',
                        str(d / 'init.npz'), '--test_data',
                        str(d / 'cv.list'), '--output',
                        str(tmp_path / 'l.txt')])
    with pytest.raises(RuntimeError, match='cuda'):
        trecognize.main(['--config', str(cfg_path), '--checkpoint',
                         str(d / 'init.npz'), '--test_data',
                         str(d / 'cv.list'), '--result_dir',
                         str(tmp_path / 'r')])


@pytest.mark.parametrize('extra,error,match', [
    (['--prng_impl', 'rbg'], NotImplementedError, "torch's generator"),
    # a registry family, or distillation, under a split other than
    # 'data' needs several processes (tests/test_torch_families_axes.py
    # trains them there)
    (['--override_config', 'model=paraformer', '--num_devices_model', '2'],
     ValueError, 'several processes'),
    # 'seq' with 'pipe' (ROADMAP item 3), which raised here until it was
    # ported, under its old id: bin.train's check now accepts the mix
    # with the multi-process flags and returns the family
    # (tests/test_torch_parallel.py trains pipe2seq2)
    pytest.param(['--override_config', 'model=whisper', '--num_processes',
                  '2', '--num_devices_seq', '2', '--num_devices_pipe', '2'],
                 None, 'whisper', id='extra2-NotImplementedError-item 3'),
    (['--override_config', 'ts_conf.teacher_yaml=t.yaml',
      '--num_devices_model', '2'], ValueError, 'several processes'),
])
def test_train_unported_options_raise(recipe, tmp_path, extra, error,
                                      match):
    """What the port does not train raises before any process group
    forms; a mix that raised until it was ported (`error` None) passes
    bin.train's check, which returns the family `match`."""
    d, cfg_path = recipe
    if error is None:
        from reverb_tpu_torch.utils.config import (load_config,
                                                   override_config)
        args = ttrain.get_args(_train_argv(d, cfg_path, tmp_path / 'x',
                                           '--device', 'cpu', *extra))
        configs = override_config(load_config(args.config),
                                  args.override_config)
        assert ttrain.check_supported(args, configs) == match
        return
    with pytest.raises(error, match=match):
        ttrain.main(_train_argv(d, cfg_path, tmp_path / 'x', '--device',
                                'cpu', *extra))


@pytest.mark.parametrize('extra', [
    # the mesh axes (ROADMAP item 14b), also with the multi-process flags
    ['--num_devices_seq', '2'],
    ['--num_devices_pipe', '2'],
    ['--coordinator', 'localhost:1', '--num_devices_seq', '2'],
    ['--num_processes', '2', '--num_devices_pipe', '2'],
    ['--process_id', '1', '--pipeline_microbatches', '2'],
    ['--pipeline_microbatches', '4'],
    # a registry family, or distillation, over several processes (item
    # 15.8: over 'data')
    ['--override_config', 'model=paraformer', '--num_processes', '2'],
    ['--override_config', 'ts_conf.teacher_yaml=t.yaml',
     '--num_processes', '2'],
])
def test_train_parallel_options_accepted(recipe, tmp_path, extra):
    """The options that raised until the 'seq', 'expert' and 'pipe' axes
    and the families over 'data' were ported: bin.train's check accepts
    them (tests/test_torch_parallel.py and
    tests/test_torch_families_parallel.py train them)."""
    from reverb_tpu_torch.utils.config import load_config, override_config
    d, cfg_path = recipe
    args = ttrain.get_args(_train_argv(d, cfg_path, tmp_path / 'x',
                                       '--device', 'cpu', *extra))
    configs = override_config(load_config(args.config), args.override_config)
    ttrain.check_supported(args, configs)


def test_pipeline_stages_in_one_process_train_in_order(recipe, tmp_path):
    """encoder_conf.pipeline_stages 2 without a 'pipe' axis (one
    process) trains the layers in order, as the JAX package does: the
    metrics and checkpoints of the run without the key."""
    d, cfg_path = recipe

    def run(name, *extra):
        argv = _train_argv(d, cfg_path, tmp_path / name, '--device', 'cpu',
                           '--override_config', 'encoder_conf.num_blocks=4',
                           '--max_epoch', '1', *extra)
        i = argv.index('--checkpoint')        # four blocks from the seed
        del argv[i:i + 2]
        ttrain.main(argv)
        return [{k: v for k, v in json.loads(line).items() if k != 'ts'}
                for line in (tmp_path / name / 'metrics.jsonl').read_text()
                .splitlines()]
    want = run('plain')
    got = run('staged', '--override_config', 'encoder_conf.pipeline_stages=2')
    assert got == want and len(want) == 2


@pytest.mark.parametrize('extra', [
    ['--override_config', 'model=k2_model'],
    ['--override_config', 'ts_conf.teacher_yaml=t.yaml'],
    ['--override_config', 'model=whisper'],
    ['--override_config', 'model=ctl_model'],
])
def test_train_ported_options_accepted(recipe, tmp_path, extra):
    """The families and the distillation that raised until they were
    ported: bin.train's check accepts them in one process
    (tests/test_torch_lora_ts.py trains the ts_conf route end to end)."""
    from reverb_tpu_torch.utils.config import load_config, override_config
    d, cfg_path = recipe
    args = ttrain.get_args(_train_argv(d, cfg_path, tmp_path / 'x',
                                       '--device', 'cpu', *extra))
    configs = override_config(load_config(args.config), args.override_config)
    ttrain.check_supported(args, configs)


def test_dynamic_chunk_cv_raises_as_in_jax(recipe, tmp_path, monkeypatch):
    """A fault of the JAX package that the port repairs (ROADMAP queue 3):
    JAX's CV and get_loss compute a use_dynamic_chunk model's loss with no
    rng, so its chunk mask asserts.  The port's CV and get_loss draw the
    chunk from a seeded generator, as WeNet's add_optional_chunk_mask draws
    it in evaluation too: bin/train's epoch with CV and get_loss complete
    with finite losses, and the eval step's loss equals JAX's compute_loss
    when JAX's two draws are the port's (fixed draws,
    `dynamic_chunk_from_draws`), with no dropout on either side."""
    import jax.numpy as jnp
    d, cfg_path = recipe
    with pytest.raises(AssertionError, match='needs an rng'):
        jcommon.add_optional_chunk_mask(jnp.ones((1, 1, 8), bool), True,
                                        False, 0, 0, -1, rng=None)
    conf = yaml.safe_load(cfg_path.read_text())
    conf['encoder_conf']['use_dynamic_chunk'] = True
    dyn = tmp_path / 'dynamic_chunk.yaml'
    dyn.write_text(yaml.safe_dump(conf))
    exp = tmp_path / 'exp'
    ttrain.main(_train_argv(d, dyn, exp, '--device', 'cpu', '--max_epoch',
                            '1', '--steps_per_epoch', '1'))
    cv_loss = _yaml(exp / 'epoch_0.yaml')['cv_loss']
    assert math.isfinite(cv_loss)
    tget_loss.main(['--config', str(dyn), '--checkpoint',
                    str(d / 'init.npz'), '--test_data', str(d / 'cv.list'),
                    '--output', str(tmp_path / 'loss.txt'), '--device',
                    'cpu'])
    rows = [r.split() for r in
            (tmp_path / 'loss.txt').read_text().splitlines()]
    assert rows and all(len(r) == 4 and all(math.isfinite(float(x))
                                            for x in r[1:]) for r in rows)

    # the eval step's arithmetic against JAX's at the same draws
    jconf = jpresets.reverb_tiny()
    jconf['encoder_conf'].update(use_dynamic_chunk=True,
                                 use_dynamic_left_chunk=True)
    jcfg = jam.ModelConfig.from_config(jconf)
    params = jam.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tam.ModelConfig.from_config(jconf)
    model = tam.build_model(tcfg, 'cpu', convert.state_dict_from_jax(
        flatten_params(params)))
    rng = np.random.RandomState(4)
    B, T = 2, 97
    batch = {'feats': rng.randn(B, T, 80).astype(np.float32),
             'feats_lengths': np.array([T, 70], np.int32),
             'target': np.array([[3, 4, 5], [6, 7, -1]], np.int32),
             'target_lengths': np.array([3, 2], np.int32),
             'cat_embs': np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)}
    size = ((T - 1) // 2 - 1) // 2             # encoder frames
    for seed in (0, 1, 2):
        got = ttr.make_eval_step(tcfg)(
            model, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator().manual_seed(seed))
        g = torch.Generator().manual_seed(seed)
        draws = iter([torch.randint(1, max(size, 2), (), generator=g),
                      torch.randint(0, 2 ** 30, (), generator=g)])
        monkeypatch.setattr(jax.random, 'randint',
                            lambda *a, **k: jnp.asarray(int(next(draws))))
        real_mask = jam_encoder.add_optional_chunk_mask
        monkeypatch.setattr(
            jam_encoder, 'add_optional_chunk_mask',
            lambda *a, rng=None, **k: real_mask(
                *a, rng=jax.random.PRNGKey(0), **k))
        want = jam.compute_loss(params, jcfg,
                                {k: jnp.asarray(v) for k, v in batch.items()})
        monkeypatch.undo()
        for k in ('loss', 'loss_att', 'loss_ctc'):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                       err_msg=f'{k} (seed {seed})')


def test_jax_only_config_keys(recipe):
    """Every encoder/decoder key the JAX package's configs read is either a
    field of the port's configs or one the port handles on its own
    (_JAX_ONLY_*_KEYS); gradient_checkpointing (with a remat_policy)
    builds a checkpointed model with the same parameters, without a
    warning, and an unknown remat_policy raises."""
    import dataclasses as dc
    import warnings
    from reverb_tpu.models.decoder import DecoderConfig as JDec
    from reverb_tpu.models.encoder import EncoderConfig as JEnc
    from reverb_tpu_torch.models.decoder import DecoderConfig as TDec
    from reverb_tpu_torch.models.encoder import EncoderConfig as TEnc
    for jc, tc, extra in ((JEnc, TEnc, tam._JAX_ONLY_ENCODER_KEYS),
                          (JDec, TDec, tam._JAX_ONLY_DECODER_KEYS)):
        jf = {f.name for f in dc.fields(jc)}
        tf = {f.name for f in dc.fields(tc)}
        assert jf - tf == set(extra), (jc, jf - tf)
    _, cfg_path = recipe
    conf = yaml.safe_load(cfg_path.read_text())
    plain = tam.ModelConfig.from_config(conf)
    with torch.device('meta'):
        want = {k: v.shape for k, v in tam.ASRModel(plain).state_dict()
                .items()}
    for part, sub in (('encoder_conf', 'encoder'), ('decoder_conf',
                                                    'decoder')):
        for policy in ('full', 'dots', 'dots_no_ln'):
            ck = json.loads(json.dumps(conf))
            ck[part].update(gradient_checkpointing=True,
                            remat_policy=policy)
            with warnings.catch_warnings():
                warnings.simplefilter('error')
                cfg = tam.ModelConfig.from_config(ck)
            assert getattr(cfg, sub).gradient_checkpointing
            assert dc.replace(cfg, **{sub: dc.replace(
                getattr(cfg, sub), gradient_checkpointing=False,
                remat_policy='dots')}) == plain
            with torch.device('meta'):
                got = {k: v.shape for k, v in tam.ASRModel(cfg).state_dict()
                       .items()}
            assert got == want
        ck[part]['remat_policy'] = 'some'
        with pytest.raises(ValueError, match='remat_policy'):
            tam.build_model(tam.ModelConfig.from_config(ck), 'cpu',
                            generator=torch.Generator().manual_seed(0))


# ------------------------------ executor ------------------------------

def _tiny_step_setup():
    conf = jpresets.reverb_tiny()
    cfg = tam.ModelConfig.from_config(conf)
    model = tam.build_model(cfg, 'cpu',
                            generator=torch.Generator().manual_seed(0),
                            train=True)
    opt, schedule = ttr.build_optimizer(ttr.TrainConfig.from_config(conf),
                                        model)
    rng = np.random.RandomState(0)
    B, T, L = 2, 67, 4
    batch = {
        'feats': rng.randn(B, T, 80).astype(np.float32),
        'feats_lengths': np.full((B,), T, np.int32),
        'target': rng.randint(1, cfg.vocab_size - 2, (B, L)).astype(np.int32),
        'target_lengths': np.full((B,), L, np.int32),
        'cat_embs': np.tile(np.array([[1.0, 0.0]], np.float32), (B, 1)),
        'keys': ['a', 'b']}
    return cfg, model, opt, schedule, batch


@pytest.mark.parametrize('named', [False, True])
def test_executor_snapshot_rules(tmp_path, named):
    """After tests/test_train_bin.py:test_rolling_snapshots: rolling names
    (the last odd snapshot overwrites the first), save_optimizer_every 2,
    run_tag in the sidecar; named snapshots keep one file a step; the
    force flag adds the optimizer to the next snapshot and is consumed."""
    cfg, model, opt, schedule, batch = _tiny_step_setup()
    mdir = tmp_path / 'exp'
    mdir.mkdir()
    tracker = ttracking.JsonlTracker(str(mdir))
    ex = Executor(train_step=ttr.make_train_step(cfg, opt),
                  eval_step=ttr.make_eval_step(cfg), model_dir=str(mdir),
                  log_interval=2, save_interval=1, save_optimizer_every=2,
                  schedule=schedule, writer=tracker,
                  use_named_snapshots=named, run_tag='exp-rolling',
                  device='cpu')
    ex.train(model, opt, [batch] * 3, epoch=0,
             generator=torch.Generator().manual_seed(1))
    names = sorted(p.name for p in mdir.iterdir()
                   if p.suffix in ('.npz', '.pt'))
    if named:
        assert names == ['step_1.npz', 'step_2.npz', 'step_2.torch_opt.pt',
                         'step_3.npz'], names
    else:
        assert names == ['snapshot.npz', 'snapshot_and_optimizer.npz',
                         'snapshot_and_optimizer.torch_opt.pt'], names
        info = _yaml(mdir / 'snapshot.yaml')
        assert info['run_tag'] == 'exp-rolling'
        assert info['step'] == 3   # the last odd snapshot overwrote step 1
    (mdir / tckpt.FORCE_SNAPSHOT_FLAG).write_text('')
    ex.train(model, opt, [batch], epoch=0,
             generator=torch.Generator().manual_seed(2),
             cv_dataset=[batch])
    # snapshot 4 keeps the optimizer anyway; the flag is consumed by it
    assert not (mdir / tckpt.FORCE_SNAPSHOT_FLAG).exists()
    tag = 'step_4' if named else 'snapshot_and_optimizer'
    assert (mdir / f'{tag}.torch_opt.pt').exists()
    info = _yaml(mdir / f'{tag}.yaml')
    assert info['step'] == 4 and math.isfinite(info['cv_loss'])
    (mdir / tckpt.FORCE_SNAPSHOT_FLAG).write_text('')
    ex.train(model, opt, [batch], epoch=0)
    tag = 'step_5' if named else 'snapshot_and_optimizer'
    assert _yaml(mdir / f'{tag}.yaml')['step'] == 5   # forced, odd
    tracker.finish()
    steps = [json.loads(x)['step'] for x in
             (mdir / 'metrics.jsonl').read_text().splitlines()]
    assert steps == [2, 4]


def test_jsonl_tracker_records_equal_jax(tmp_path):
    """The same scalars and artifacts through both JSONL trackers: the
    records are equal, timestamps aside."""
    (tmp_path / 'list.txt').write_text('a\nb\n')
    out = {}
    for name, mod in (('jax', jtracking), ('torch', ttracking)):
        tr = mod.JsonlTracker(str(tmp_path / name))
        for step in (1, 2, 2, 5):
            tr.add_scalar('train/loss', 0.5 * step, step)
            tr.add_scalar('train/lr', 1e-3 / step, step)
        tr.log_metrics({'cv/loss': 1.25, 'cv/acc': None}, 6)
        tr.log_artifact('dev_data_list', 'dev_dataset',
                        {'dev.list': str(tmp_path / 'list.txt')})
        tr.finish()
        out[name] = [
            [{k: v for k, v in json.loads(x).items() if k != 'ts'}
             for x in (tmp_path / name / f).read_text().splitlines()]
            for f in ('metrics.jsonl', 'artifacts.jsonl')]
    assert out['torch'] == out['jax']
    assert [r['step'] for r in out['torch'][0]] == [1, 2, 5, 6]


# --------------------------- dynamic chunk ---------------------------

def _jax_mask(size, raw_chunk, raw_left, dyn_left, full_ctx, monkeypatch):
    """JAX's add_optional_chunk_mask with its two draws replaced by the
    given values."""
    import jax.numpy as jnp
    draws = iter([raw_chunk, raw_left])
    monkeypatch.setattr(jax.random, 'randint',
                        lambda *a, **k: jnp.asarray(next(draws)))
    m = jcommon.add_optional_chunk_mask(
        jnp.ones((1, 1, size), bool), True, dyn_left, 0, 0, -1,
        rng=jax.random.PRNGKey(0), enable_full_context=full_ctx)
    return np.asarray(m[0])


@pytest.mark.parametrize('size', [1, 2, 7, 24, 33])
def test_dynamic_chunk_mask_equals_jax(size, monkeypatch):
    """For every raw chunk draw and a spread of left-chunk draws, the
    port's (chunk, num_left) arithmetic and mask equal JAX's."""
    for dyn_left in (False, True):
        for full_ctx in (True, False):
            for raw_chunk in range(1, max(size, 2)):
                for raw_left in (0, 5, 123457, 2 ** 30 - 1):
                    want = _jax_mask(size, raw_chunk, raw_left, dyn_left,
                                     full_ctx, monkeypatch)
                    c, n = tcommon.dynamic_chunk_from_draws(
                        size, torch.tensor(raw_chunk),
                        torch.tensor(raw_left), dyn_left, full_ctx)
                    np.testing.assert_array_equal(
                        tcommon.subsequent_chunk_mask(size, c, n).numpy(),
                        want)


def test_dynamic_chunk_draw_support_matches_jax():
    """Over many seeds the port's draw covers exactly the support JAX's
    arithmetic allows: every (chunk, num_left) it can give, and no other."""
    size = 12
    support = set()
    for raw_chunk in range(1, size):
        for raw_left in range(64):
            c, n = tcommon.dynamic_chunk_from_draws(
                size, torch.tensor(raw_chunk), torch.tensor(raw_left), True)
            support.add((int(c), int(n)))
    seen = set()
    for seed in range(3000):
        c, n = tcommon.draw_dynamic_chunk(
            size, torch.Generator().manual_seed(seed), True)
        seen.add((int(c), int(n)))
    assert seen == support
    assert (size, 0) in seen and (2, 4) in seen and len(seen) == 15


def test_dynamic_chunk_config_trains_one_step():
    """A use_dynamic_chunk model trains a step with a finite loss, every
    LayerNorm through the K5/K6 functions and attention through the masked
    route (no K1/K4 call on any device)."""
    conf = jpresets.reverb_config(output_size=D, attention_heads=2,
                                  linear_units=96, num_blocks=2, dec_blocks=1,
                                  r_blocks=1, vocab_size=23)
    conf['encoder_conf'].update(use_dynamic_chunk=True,
                                use_dynamic_left_chunk=True)
    cfg = tam.ModelConfig.from_config(conf)
    model = tam.build_model(cfg, 'cpu',
                            generator=torch.Generator().manual_seed(0),
                            train=True)
    opt, _ = ttr.build_optimizer(ttr.TrainConfig.from_config(conf), model)
    step = ttr.make_train_step(cfg, opt)
    calls = {'attn': 0, 'ln': 0}
    real_attn, real_ln = fa.rel_pos_attention, ln.layer_norm_fwd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    rng = np.random.RandomState(1)
    batch = {'feats': torch.from_numpy(rng.randn(2, 90, 80).astype('f4')),
             'feats_lengths': torch.tensor([90, 70]),
             'target': torch.tensor([[3, 4, 5], [6, 7, -1]]),
             'target_lengths': torch.tensor([3, 2]),
             'cat_embs': torch.tensor([[1.0, 0.0], [0.0, 1.0]])}
    from reverb_tpu_torch.models.modules import LayerNorm
    seen = [0]

    def hook(mod, args, out):
        seen[0] += int(ln.eligible(args[0]))
    hooks = [mod.register_forward_hook(hook) for mod in model.modules()
             if isinstance(mod, LayerNorm)]
    try:
        fa.rel_pos_attention = count('attn', real_attn)
        ln.layer_norm_fwd = count('ln', real_ln)
        m = step(model, batch, torch.Generator().manual_seed(5))
    finally:
        fa.rel_pos_attention, ln.layer_norm_fwd = real_attn, real_ln
        for h in hooks:
            h.remove()
    assert math.isfinite(m['loss']) and m['skipped'] == 0.0
    assert calls['attn'] == 0
    assert calls['ln'] == seen[0] == len(hooks) > 0


# ------------------------------ tools ------------------------------

def test_step_watchdog_and_epoch_barrier(tmp_path):
    """After tests/test_common.py:test_step_watchdog_semantics: beat()
    keeps it quiet, a stall flips `stalled` and check() raises, beat()
    recovers; epoch_barrier is a no-op alone and a barrier in a group."""
    import time
    import torch.distributed as dist
    from reverb_tpu_torch.train.watchdog import StepWatchdog, epoch_barrier
    wd = StepWatchdog(timeout_s=0.3, exit_on_stall=False, poll_s=0.05)
    try:
        for s in range(3):
            wd.beat(s)
            wd.check()
            time.sleep(0.05)
        time.sleep(0.6)
        assert wd.stalled
        with pytest.raises(RuntimeError, match='stalled'):
            wd.check()
        wd.beat(4)
        wd.check()
    finally:
        wd.stop()
    epoch_barrier('alone')
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/pg',
                            world_size=1, rank=0)
    try:
        epoch_barrier('group')
    finally:
        dist.destroy_process_group()


def test_profile_window_writes_one_trace(tmp_path):
    from reverb_tpu_torch.utils.profiling import ProfileWindow
    pw = ProfileWindow(str(tmp_path / 'prof'), start_step=2, num_steps=2)
    x = torch.ones(8, 8)
    for step in range(6):
        pw.maybe_start(step)
        if step in (2, 3):
            assert pw._active
        x = x @ x / 8
        pw.maybe_stop(step)
    assert pw.done and not pw._active
    assert [p.name for p in (tmp_path / 'prof').iterdir()] == \
        ['trace_step2.json']
    json.loads((tmp_path / 'prof' / 'trace_step2.json').read_text())
    pw.close()
    off = ProfileWindow(None)
    off.maybe_start(10)
    off.maybe_stop(10)
    assert not off._active and not off.done


def test_init_tracking_and_fan_out(tmp_path):
    """init_tracking's launch artifacts (the port's code tree, the data
    lists, the tokenizer files) and MultiTracker's fan-out, as in
    tests/test_tracking.py."""
    (tmp_path / 'train.list').write_text('x\n')
    (tmp_path / 'units.txt').write_text('a 0\n')
    tr = ttracking.init_tracking(
        str(tmp_path / 'model'),
        {'tokenizer_conf': {'symbol_table_path': str(tmp_path / 'units.txt')}},
        train_data=str(tmp_path / 'train.list'))
    tr.finish()
    arts = [json.loads(x) for x in
            (tmp_path / 'model' / 'artifacts.jsonl').read_text().splitlines()]
    assert [a['artifact'] for a in arts] == [
        'reverb-tpu-torch-tree', 'training_data_list', 'tokenizer']
    assert any(f['name'].endswith('bin/train.py') for f in arts[0]['files'])
    m = ttracking.MultiTracker([ttracking.JsonlTracker(str(tmp_path / d))
                                for d in ('a', 'b')])
    m.log_metrics({'loss': 2.0, 'skipped': None}, 5)
    m.finish()
    for d in ('a', 'b'):
        rec = json.loads((tmp_path / d / 'metrics.jsonl').read_text())
        assert rec['loss'] == 2.0 and 'skipped' not in rec


def test_config_override_and_save_equal_jax(tmp_path):
    import argparse
    from reverb_tpu.utils import config as jconfig
    from reverb_tpu_torch.utils import config as tconfig
    import copy
    base = jpresets.reverb_tiny()
    base['dataset_conf'].update(add_cat_emb=True)
    kept = copy.deepcopy(base)
    overrides = ['optim_conf.lr=0.002', 'dataset_conf.batch_conf.batch_size=4',
                 'encoder_conf.causal=true', 'new.key=[1, 2]',
                 'model_conf.name=abc']
    want = jconfig.override_config(base, overrides)
    got = tconfig.override_config(base, overrides)
    assert got == want and base == kept
    table = {f't{i}': i for i in range(7)}
    for mod, sub in ((jconfig, 'j'), (tconfig, 't')):
        mod.check_modify_and_save_config(
            argparse.Namespace(model_dir=str(tmp_path / sub)),
            dict(want, dataset_conf=dict(want['dataset_conf'])), table)
    assert _yaml(tmp_path / 't' / 'train.yaml') == \
        _yaml(tmp_path / 'j' / 'train.yaml')
    # 80 mel bins + the 2-entry cat-emb appended to every frame
    assert tconfig.load_config(tmp_path / 't' / 'train.yaml')['input_dim'] \
        == 82


def test_enc_init_equals_jax(trained, tmp_path):
    """--enc_init's partial load (load_trained_modules) takes the same
    arrays as the JAX package's, from either package's npz."""
    from reverb_tpu.train.checkpoint import load_trained_modules as jltm
    d, jdir, tdir, _ = trained
    init = load_npz(str(d / 'init.npz'))[0]
    conf = _yaml(tdir / 'train.yaml')
    model = tam.build_model(tam.ModelConfig.from_config(conf), 'cpu',
                            convert.state_dict_from_jax(flatten_params(init)),
                            train=True)
    for src in (jdir / 'epoch_1.npz', tdir / 'epoch_1.npz'):
        want = flatten_params(jltm(init, str(src), ['encoder.embed',
                                                    'ctc.']))
        tckpt.load_trained_modules(model, src, ['encoder.embed', 'ctc.'])
        got = convert.flat_from_state_dict(model.state_dict())
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    assert not np.array_equal(got['ctc.ctc_lo.bias'],
                              flatten_params(init)['ctc.ctc_lo.bias'])
