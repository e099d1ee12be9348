"""LoRA and teacher-student distillation in the port against the JAX
package, f32 on the CPU: adapters injected by JAX carried into the port
(state-dict keys both ways), the adapted loss and the adapters' gradient,
a fresh adapter leaving the output as it was, `merge_lora` against JAX's
and against the adapter model's output, only the adapters training under
`lora_trainable_mask`; `ts_loss` with and without `top_k_entries` and its
gradient, and `bin.train` with a `ts_conf` (teacher from its config and
a `.npz`), whose first step's loss is JAX's `ts_loss` on that batch."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from reverb_tpu.convert.torch_ckpt import flatten_params, save_npz
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu.train import lora as jlora
from reverb_tpu.train import teacher_student as jts
from reverb_tpu_torch import convert
from reverb_tpu_torch.bin import train as ttrain
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.train import lora as tlora
from reverb_tpu_torch.train import teacher_student as tts
from reverb_tpu_torch.train import trainer as ttr
from test_torch_train_bin import _write_recipe
from torch_families import (ENC, V, assert_metrics_close, batch, grads_close,
                            jax_loss_and_grads, port_loss_and_grads, to_jax,
                            to_torch)

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

CONF = {'input_dim': 80, 'output_dim': V, 'encoder': 'conformer',
        'encoder_conf': dict(ENC, output_size=128, linear_units=64),
        'decoder': 'bitransformer',
        'decoder_conf': {'attention_heads': 2, 'linear_units': 48,
                         'num_blocks': 1, 'r_num_blocks': 1,
                         'dropout_rate': 0.0, 'positional_dropout_rate': 0.0},
        'model_conf': {'ctc_weight': 0.3, 'reverse_weight': 0.3}}


def _lora_params(seed=0):
    """The JAX tree with adapters on every attention projection, B made
    non-zero (a trained adapter)."""
    params = jinit(CONF, jax.random.PRNGKey(seed)).params
    params = jlora.inject_lora(params, jax.random.PRNGKey(5), rank=4,
                               alpha=8)
    key = [jax.random.PRNGKey(9)]

    def visit(node):
        if isinstance(node, dict):
            if 'lora_B' in node:
                key[0], sub = jax.random.split(key[0])
                node = dict(node, lora_B=0.1 * jax.random.normal(
                    sub, node['lora_B'].shape))
                return node
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node
    return visit(params)


def _port(flat):
    cfg = tam.ModelConfig.from_config(CONF)
    sd = convert.state_dict_from_jax(flat)
    with torch.device('meta'):
        model = tam.ASRModel(cfg)
    tlora.lora_modules(model, sd)
    model = model.to_empty(device='cpu')
    model.load_state_dict(sd, strict=True)
    return model.train()


def test_lora_carried_from_jax_loss_gradient_and_merge():
    params = _lora_params()
    flat = flatten_params(params)
    assert any(k.endswith('lora_scale') for k in flat)
    model = _port(flat)
    assert set(convert.flat_from_state_dict(model.state_dict())) == set(flat)
    cfg = jam.ModelConfig.from_config(CONF)
    b = batch(T=70, U=4)
    jout, jg = jax_loss_and_grads(
        lambda p: jam.compute_loss(p, cfg, to_jax(b)), params)
    tout, tg = port_loss_and_grads(model,
                                   lambda m: tam.compute_loss(m, to_torch(b)))
    assert_metrics_close(tout, jout)
    jg = {k: v for k, v in jg.items() if not k.endswith('lora_scale')}
    grads_close(jg, tg)
    assert any(np.abs(tg[k]).max() > 0 for k in tg if k.endswith('lora_A'))
    # merging: JAX's weights, and the adapter model's output
    merged = flatten_params(jlora.merge_lora(params))
    with torch.no_grad():
        before = tam.compute_loss(model.eval(), to_torch(b))['loss']
        tlora.merge_lora(model)
        after = tam.compute_loss(model, to_torch(b))['loss']
    got = convert.flat_from_state_dict(model.state_dict())
    assert set(got) == set(merged)
    for k, v in merged.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(after), float(before), rtol=1e-5)


def test_fresh_lora_is_the_identity_and_only_adapters_train():
    cfg = tam.ModelConfig.from_config(dict(CONF, optim_conf={'lr': 1e-3}))
    model = tam.build_model(cfg, 'cpu',
                            generator=torch.Generator().manual_seed(0),
                            train=True)
    b = to_torch(batch(T=70, U=4))
    with torch.no_grad():
        base = float(tam.compute_loss(model, b)['loss'])
    tlora.inject_lora(model, torch.Generator().manual_seed(1), rank=8,
                      alpha=8)
    names = [n for n, _ in model.named_parameters() if 'lora_' in n]
    assert len(names) == 2 * 4 * (2 + 2 + 2)   # 2 enc, 2 × 2 dec blocks
    with torch.no_grad():
        assert float(tam.compute_loss(model, b)['loss']) == base
    mask = tlora.lora_trainable_mask(model)
    assert {n for n, v in mask.items() if v} == set(names)
    tc = ttr.TrainConfig.from_config({'optim_conf': {'lr': 1e-2},
                                      'scheduler_conf': {'warmup_steps': 1}})
    opt, _ = ttr.build_optimizer(tc, model)
    assert {opt.names[i] for i in opt.train_idx} == set(names)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ttr.make_train_step(cfg, opt, grad_clip=50.0)(model, b)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) != (n.endswith('lora_B')), n


def _ts_models(seed_t=1):
    scfg = tam.ModelConfig.from_config(CONF)
    tconf = dict(CONF, encoder_conf=dict(CONF['encoder_conf'],
                                         num_blocks=1))
    tcfg = tam.ModelConfig.from_config(tconf)
    jsp = jinit(CONF, jax.random.PRNGKey(0)).params
    jtp = jinit(tconf, jax.random.PRNGKey(seed_t)).params
    student = tam.build_model(scfg, 'cpu', convert.state_dict_from_jax(
        flatten_params(jsp)), train=True)
    teacher = tam.build_model(tcfg, 'cpu', convert.state_dict_from_jax(
        flatten_params(jtp)))
    return (jsp, jtp, jam.ModelConfig.from_config(CONF),
            jam.ModelConfig.from_config(tconf), student, teacher)


@pytest.mark.parametrize('top_k', [0, 3])
def test_ts_loss_and_gradient_match_jax(top_k):
    jsp, jtp, jscfg, jtcfg, student, teacher = _ts_models()
    b = batch(T=70, U=4)
    ts = dict(ts_weight=0.7, top_k_entries=top_k)
    jout, jg = jax_loss_and_grads(
        lambda p: jts.ts_loss(p, jtp, jscfg, jtcfg, to_jax(b),
                              jts.TSConfig(**ts)), jsp)
    tout, tg = port_loss_and_grads(
        student, lambda m: tts.ts_loss(m, teacher, to_torch(b),
                                       tts.TSConfig(**ts)))
    assert set(tout) == set(jout)
    assert float(tout['kl_enc_loss']) > 0 and float(tout['kl_dec_loss']) > 0
    assert_metrics_close(tout, jout)
    grads_close(jg, tg)
    assert all(p.grad is None for p in teacher.parameters())
    assert tts.decay_ts_weight(0.5, tts.TSConfig(
        min_ts_weight=0.1, decrease_factor=0.5)) == jts.decay_ts_weight(
            0.5, jts.TSConfig(min_ts_weight=0.1, decrease_factor=0.5))


def test_bin_train_ts_conf_route(tmp_path, monkeypatch):
    """bin.train with a ts_conf: the teacher (another config and .npz) is
    built frozen, the distillation loss replaces the student's, and the
    first step's loss is JAX's ts_loss on the same batch and weights."""
    d = tmp_path
    cfg_path = _write_recipe(d)
    conf = yaml.safe_load(cfg_path.read_text())
    tconf = json.loads(json.dumps(conf))
    tconf['encoder_conf']['num_blocks'] = 2
    (d / 'teacher.yaml').write_text(yaml.safe_dump(tconf))
    jtcfg = jam.ModelConfig.from_config(tconf)
    from reverb_tpu.frontend.cmvn import load_cmvn
    jtp = jam.init_params(jax.random.PRNGKey(4), jtcfg,
                          cmvn=load_cmvn(str(d / 'global_cmvn'), True))
    save_npz(str(d / 'teacher.npz'), jtp)
    conf['ts_conf'] = {'teacher_yaml': str(d / 'teacher.yaml'),
                       'teacher_checkpoint': str(d / 'teacher.npz'),
                       'ts_weight': 0.6, 'top_k_entries': 2}
    conf['snapshot_saving_conf'] = {'save_interval': 0}
    ts_path = d / 'ts.yaml'
    ts_path.write_text(yaml.safe_dump(conf))
    seen = []
    real = tts.ts_loss

    def spy(model, teacher, batch_, ts, generator=None, ts_weight=None):
        out = real(model, teacher, batch_, ts, generator, ts_weight)
        if not seen and torch.is_grad_enabled():
            seen.append(({k: v.detach().clone() for k, v in batch_.items()},
                         float(out['loss']), teacher, ts))
        return out
    monkeypatch.setattr(tts, 'ts_loss', spy)
    ttrain.main(['--config', str(ts_path), '--train_data',
                 str(d / 'train.list'), '--cv_data', str(d / 'cv.list'),
                 '--model_dir', str(d / 'exp'), '--checkpoint',
                 str(d / 'init.npz'), '--max_epoch', '1',
                 '--steps_per_epoch', '1', '--device', 'cpu'])
    assert (d / 'exp' / 'epoch_0.npz').exists()
    tbatch, loss, teacher, ts = seen[0]
    assert ts.top_k_entries == 2 and not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    from reverb_tpu.convert.torch_ckpt import load_npz
    jsp, _ = load_npz(str(d / 'init.npz'))
    want = jts.ts_loss(jsp, jtp, jam.ModelConfig.from_config(conf), jtcfg,
                       {k: jnp.asarray(v.numpy()) for k, v in
                        tbatch.items()},
                       jts.TSConfig(ts_weight=0.6, top_k_entries=2))
    np.testing.assert_allclose(loss, float(want['loss']), rtol=1e-4)
