"""The training frontend inside the step (`dataset_conf.device_feats`),
f32 on CPU: the port's frontend/device_feats.py against the JAX package's
— the deterministic fbank (rng=None) and SpecAugment's masks at JAX's
draws — its own draws, the train and eval steps with a frontend, and
bin.train with device_feats on a tiny recipe (2 steps; CV is
deterministic and agrees with the host-feature CV)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from reverb_tpu.frontend import device_feats as jdf
from reverb_tpu_torch.frontend import device_feats as tdf

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

CONF = {'dataset_conf': {
    'device_feats': True, 'spec_aug': True,
    'fbank_conf': {'num_mel_bins': 80, 'frame_length': 25,
                   'frame_shift': 10, 'dither': 0.1},
    'spec_aug_conf': {'num_t_mask': 2, 'num_f_mask': 2, 'max_t': 20,
                      'max_f': 10}}}


def _pcm_batch(seed=0, lens=(16000, 12800, 7000), pad_t=0):
    rng = np.random.RandomState(seed)
    S = max(lens)
    pcm = np.zeros((len(lens), S), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000
        pcm[i, :n] = (np.sin(2 * np.pi * rng.uniform(100, 400) * t)
                      * rng.rand() + 0.05 * rng.randn(n)) * 0.3
    frames = np.array([1 + (n - 400) // 160 for n in lens], np.int32)
    T = int(frames.max()) + pad_t
    return {'pcm': pcm, 'pcm_length': np.array(lens, np.int32),
            'feats': np.zeros((len(lens), T, 0), np.float32),
            'feats_lengths': frames}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_spec_from_configs_matches_jax():
    """FrontendSpec fields equal JAX's; no device_feats → None; spec_sub
    raises in both."""
    want = jdf.frontend_from_configs(CONF)
    got = tdf.frontend_from_configs(CONF)
    for f in ('dither', 'num_t_mask', 'num_f_mask', 'max_t', 'max_f'):
        assert getattr(got, f) == getattr(want, f), f
    for f in ('sample_rate', 'num_mel_bins', 'frame_length_ms',
              'frame_shift_ms'):
        assert getattr(got.fbank, f) == getattr(want.fbank, f), f
    assert tdf.frontend_from_configs({'dataset_conf': {}}) is None
    bad = {'dataset_conf': dict(CONF['dataset_conf'], spec_sub=True)}
    for mod in (jdf, tdf):
        with pytest.raises(ValueError, match='spec_aug only'):
            mod.frontend_from_configs(bad)
    off = {'dataset_conf': dict(CONF['dataset_conf'], spec_aug=False)}
    assert tdf.frontend_from_configs(off).num_t_mask == 0


@pytest.mark.parametrize('pad_t', [0, 7])
def test_deterministic_frontend_matches_jax(pad_t):
    """rng=None (CV): the fbank of the PCM, cut or zero-padded to the
    batch's T, padded frames zero — against JAX's apply_frontend at the
    bar of tests/test_device_feats.py; a batch with features passes
    through."""
    batch = _pcm_batch(pad_t=pad_t)
    want = np.asarray(jdf.apply_frontend(
        {k: jnp.asarray(v) for k, v in batch.items()},
        jdf.frontend_from_configs(CONF), None)['feats'])
    got = tdf.apply_frontend(_tb(batch), tdf.frontend_from_configs(CONF),
                             None)['feats'].numpy()
    assert got.shape == want.shape == batch['feats'].shape[:2] + (80,)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    for i, n in enumerate(batch['feats_lengths']):
        assert not got[i, n:].any() and got[i, :n].any()
    host = {'feats': torch.ones(2, 5, 80), 'feats_lengths': torch.ones(2)}
    assert tdf.apply_frontend(host, tdf.frontend_from_configs(CONF),
                              torch.Generator()) is host


def _jax_draws(key, lengths, spec, M):
    """The draws of reverb_tpu's _spec_aug_device at `key`, in its order."""
    B = lengths.shape[0]
    rng = key
    out = {'t_start': [], 't_width': [], 'f_start': [], 'f_width': []}
    for _ in range(spec.num_t_mask):
        rng, k1, k2 = jax.random.split(rng, 3)
        out['t_start'].append(jax.random.randint(
            k1, (B, 1), 0, jnp.maximum(lengths, 1)[:, None]))
        out['t_width'].append(jax.random.randint(k2, (B, 1), 1,
                                                 spec.max_t + 1))
    for _ in range(spec.num_f_mask):
        rng, k1, k2 = jax.random.split(rng, 3)
        out['f_start'].append(jax.random.randint(k1, (B, 1), 0, M))
        out['f_width'].append(jax.random.randint(k2, (B, 1), 1,
                                                 spec.max_f + 1))
    return {k: torch.from_numpy(np.concatenate([np.asarray(x) for x in v],
                                               1).astype(np.int64))
            for k, v in out.items()}


def test_spec_aug_masks_equal_jax_at_its_draws():
    """SpecAugment with JAX's draws fed in zeroes exactly JAX's cells; the
    port's own draws lie in JAX's ranges and follow the generator."""
    spec_j = jdf.frontend_from_configs(CONF)
    spec_t = tdf.frontend_from_configs(CONF)
    rng = np.random.RandomState(1)
    feats = (rng.rand(3, 90, 80) + 0.5).astype(np.float32)
    lengths = np.array([90, 61, 3], np.int32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jdf._spec_aug_device(
            jnp.asarray(feats), jnp.asarray(lengths), key, spec_j))
        draws = _jax_draws(key, jnp.asarray(lengths), spec_j, 80)
        got = tdf.apply_spec_aug(torch.from_numpy(feats), draws).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want == 0).any()
    g = torch.Generator().manual_seed(0)
    lt = torch.from_numpy(lengths)
    d = tdf.draw_spec_aug(lt, 80, spec_t, g)
    assert d['t_start'].shape == (3, 2) and d['f_width'].shape == (3, 2)
    many = [tdf.draw_spec_aug(lt, 80, spec_t, g) for _ in range(200)]
    ts = torch.stack([m['t_start'] for m in many])
    assert (ts >= 0).all() and (ts < lt[None, :, None]).all()
    assert int(ts[:, 0].max()) > 60          # the range is covered
    tw = torch.stack([m['t_width'] for m in many])
    assert int(tw.min()) == 1 and int(tw.max()) == 20
    fs = torch.stack([m['f_start'] for m in many])
    assert int(fs.min()) == 0 and int(fs.max()) == 79
    again = tdf.draw_spec_aug(lt, 80, spec_t, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], d[k]) for k in d)


def test_train_and_eval_steps_take_the_frontend():
    """make_train_step with a frontend computes features from pcm with
    dither and SpecAugment drawn from the step's generator (a seed gives
    one loss, another seed another); make_eval_step's features are
    deterministic and equal the host-fed features' loss."""
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.train.trainer import (TrainConfig, build_optimizer,
                                                make_eval_step,
                                                make_train_step)
    conf = presets.reverb_tiny()
    cfg = ModelConfig.from_config(conf)
    spec = tdf.frontend_from_configs(CONF)
    batch = _tb(_pcm_batch())
    batch.update(target=torch.tensor([[3, 4, 5], [6, 7, -1], [8, -1, -1]]),
                 target_lengths=torch.tensor([3, 2, 1]),
                 cat_embs=torch.tensor([[1.0, 0.0]] * 3),
                 feats_lengths=batch['feats_lengths'].to(torch.int64))

    def fresh():
        model = build_model(cfg, 'cpu', train=True,
                            generator=torch.Generator().manual_seed(0))
        opt, _ = build_optimizer(TrainConfig.from_config(conf), model)
        return model, make_train_step(cfg, opt, grad_clip=5.0,
                                      frontend=spec)
    losses = []
    for seed in (1, 1, 2):
        model, step = fresh()
        losses.append(step(model, dict(batch),
                           torch.Generator().manual_seed(seed))['loss'])
    assert losses[0] == losses[1] != losses[2]
    assert all(np.isfinite(losses))
    ev = make_eval_step(cfg, frontend=spec)
    a, b = ev(model, dict(batch)), ev(model, dict(batch))
    assert a == b
    host = dict(batch, feats=tdf.apply_frontend(dict(batch), spec,
                                                None)['feats'])
    assert make_eval_step(cfg)(model, host) == a


def test_bin_train_with_device_feats(tmp_path):
    """bin.train on the tiny recipe of tests/test_torch_train_bin.py with
    dataset_conf.device_feats (spec_aug and dither on): 2 steps run, the
    checkpoint is finite, and the executor's CV is deterministic and
    within 1e-3 of the CV of host features."""
    from test_torch_train_bin import _write_recipe
    from reverb_tpu_torch.bin import train as ttrain
    from reverb_tpu_torch.data.dataset import Dataset
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.train.trainer import make_eval_step
    cfg_path = _write_recipe(tmp_path)
    conf = yaml.safe_load(cfg_path.read_text())
    conf['dataset_conf'].update(device_feats=True, spec_aug=True)
    conf['dataset_conf']['fbank_conf']['dither'] = 0.1
    path = tmp_path / 'device_feats.yaml'
    path.write_text(json.dumps(conf))
    ex = ttrain.main(['--config', str(path),
                      '--train_data', str(tmp_path / 'train.list'),
                      '--cv_data', str(tmp_path / 'cv.list'),
                      '--model_dir', str(tmp_path / 'exp'),
                      '--checkpoint', str(tmp_path / 'init.npz'),
                      '--max_epoch', '1', '--steps_per_epoch', '2',
                      '--log_interval', '1', '--device', 'cpu'])
    assert ex.step == 2
    with np.load(tmp_path / 'exp' / 'epoch_0.npz') as z:
        assert all(np.isfinite(z[k]).all() for k in z.files)
    saved = yaml.safe_load((tmp_path / 'exp' / 'train.yaml').read_text())
    tok = init_tokenizer(saved)
    # the two passes compared below must read cv.list in one order: with
    # list_shuffle on (unseeded) they batch it differently
    cv_conf = dict(saved['dataset_conf'], spec_aug=False, shuffle=False,
                   list_shuffle=False)
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch import convert
    cfg = ModelConfig.from_config(saved)
    model = build_model(cfg, 'cpu', convert.state_dict_from_jax(
        convert.load_flat_checkpoint(tmp_path / 'exp' / 'epoch_0.npz')))
    ex.eval_step = make_eval_step(cfg, frontend=tdf.frontend_from_configs(
        saved))
    cv = tmp_path / 'cv.list'
    first = ex.cv(model, Dataset('raw', str(cv), tok, cv_conf,
                                 partition=False))
    again = ex.cv(model, Dataset('raw', str(cv), tok, cv_conf,
                                 partition=False))
    assert first == again and np.isfinite(first['loss'])
    ex.eval_step = make_eval_step(cfg)
    host = ex.cv(model, Dataset('raw', str(cv), tok,
                                dict(cv_conf, device_feats=False),
                                partition=False))
    np.testing.assert_allclose(first['loss'], host['loss'], rtol=1e-3)
    info = json.loads((tmp_path / 'exp' / 'epoch_0.yaml').read_text())
    np.testing.assert_allclose(info['cv_loss'], first['loss'], rtol=1e-6)
