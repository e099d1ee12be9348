"""Shared pieces of the port's model-family tests: tiny configs of each
family the registry builds, a seeded batch, and the JAX bundle carried
into the port's (its weights through convert.py) with both losses and
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu_torch import convert
from reverb_tpu_torch.models.registry import init_model as tinit

V = 50
ENC = {'output_size': 32, 'attention_heads': 2, 'linear_units': 48,
       'num_blocks': 2, 'dropout_rate': 0.0, 'positional_dropout_rate': 0.0}
DEC = {'attention_heads': 2, 'linear_units': 48, 'num_blocks': 1,
       'r_num_blocks': 0, 'dropout_rate': 0.0,
       'positional_dropout_rate': 0.0}
ALT = ('branchformer', 'e_branchformer', 'squeezeformer',
       'efficient_conformer')


def transducer_conf(model='transducer', predictor='rnn', width=32):
    return {'input_dim': 80, 'output_dim': V, 'encoder': 'conformer',
            'encoder_conf': dict(ENC, output_size=width),
            'decoder': 'transformer', 'decoder_conf': DEC, 'model': model,
            'predictor': predictor,
            'predictor_conf': {'predictor_embed_size': 32,
                               'predictor_hidden_size': 24,
                               'predictor_kernel': 2},
            'joint_conf': {'join_dim': 32},
            'model_conf': {'transducer_weight': 0.7, 'ctc_weight': 0.3}}


def alt_conf(enc, width=32, blocks=2):
    """An alternative encoder at `width` (128 routes every LayerNorm of
    the width through the K5/K6 functions); the squeezeformer reduces
    before layer 0 and recovers before layer 1, the efficient conformer
    groups layer 0 and strides after layer 1 (of 3)."""
    c = {'output_size': width, 'num_blocks': blocks, 'dropout_rate': 0.0,
         'attention_heads': 2}
    if 'branchformer' in enc:
        c.update(cgmlp_linear_units=2 * width, cgmlp_conv_kernel=7,
                 ffn_units=48)
    else:
        c.update(linear_units=48, cnn_module_kernel=7)
    if enc == 'squeezeformer':
        c.update(reduce_idx=0, recover_idx=blocks - 1)
    if enc == 'efficient_conformer':
        c.update(num_blocks=3, stride_layer_idx=[1], stride=[2],
                 group_size=2, group_layer_idx=[0])
    return {'input_dim': 80, 'output_dim': V, 'encoder': enc,
            'encoder_conf': c, 'decoder': 'transformer', 'decoder_conf': DEC,
            'model_conf': {'ctc_weight': 0.3}}


def moe_conf(width=32, n_expert=3, k=2):
    return {'input_dim': 80, 'output_dim': V, 'encoder': 'conformer',
            'encoder_conf': dict(ENC, output_size=width,
                                 positionwise_layer_type='moe',
                                 n_expert=n_expert, n_expert_per_token=k),
            'decoder': 'bitransformer', 'decoder_conf': DEC,
            'model_conf': {'ctc_weight': 0.3}}


def batch(B=2, T=40, U=4, seed=0):
    """Features (B, T, 80), the second row 10 frames shorter (or 6 when T
    is short), targets (B, U) of U and U − 1 tokens padded with -1."""
    rng = np.random.RandomState(seed)
    short = 10 if T > 30 else 6
    target = rng.randint(1, V - 2, (B, U)).astype(np.int32)
    target[1, U - 1] = -1
    return {'feats': rng.randn(B, T, 80).astype(np.float32),
            'feats_lengths': np.array([T, T - short], np.int32),
            'target': target,
            'target_lengths': np.array([U, U - 1], np.int32)}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == 'i'
            else torch.from_numpy(v) for k, v in b.items()}


def both_bundles(conf, seed=0):
    """The JAX bundle and the port's built on the CPU from its weights."""
    jb = jinit(conf, jax.random.PRNGKey(seed))
    tb = tinit(conf, device='cpu', state_dict=convert.state_dict_from_jax(
        flatten_params(jb.params)))
    return jb, tb


def losses_and_grads(jb, tb, b):
    """(JAX metrics, port metrics, JAX flat gradient, port flat gradient
    under the JAX keys) of one loss on batch b, no dropout."""
    jbatch = to_jax(b)

    def loss(p):
        out = jb.loss_fn(p, jbatch, None)
        return out['loss'], out
    (_, jout), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jb.params)
    model = tb.model
    for p in model.parameters():
        p.grad = None
    tout = tb.loss_fn(model, to_torch(b), None)
    tout['loss'].backward()
    tg = convert.flat_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()})
    return jout, tout, flatten_params(g), tg


def assert_grads_close(jg, tg, atol=1e-4):
    assert set(jg) == set(tg), set(jg) ^ set(tg)
    for k, v in tg.items():
        np.testing.assert_allclose(v, np.asarray(jg[k]), rtol=1e-4,
                                   atol=atol, err_msg=k)


def jax_loss_and_grads(fn, params):
    """(metrics, flat gradient) of fn(params) → metrics with 'loss'."""
    def loss(p):
        out = fn(p)
        return out['loss'], out
    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return out, flatten_params(g)


def port_loss_and_grads(model, fn):
    """(metrics, flat gradient under the JAX keys; zeros where none) of
    fn(model) → metrics with 'loss'."""
    for p in model.parameters():
        p.grad = None
    out = fn(model)
    out['loss'].backward()
    g = convert.flat_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()})
    for p in model.parameters():
        p.grad = None
    return out, g


def assert_metrics_close(got, want, keys=None, rtol=1e-4, atol=1e-5):
    for k in keys or want:
        if want[k] is not None:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=rtol, atol=atol, err_msg=k)


def grads_close(jg, tg, rel=1e-4):
    """Each gradient within `rel` of the largest gradient magnitude."""
    assert set(jg) == set(tg), set(jg) ^ set(tg)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for k, v in tg.items():
        np.testing.assert_allclose(v, np.asarray(jg[k]), rtol=0,
                                   atol=rel * scale, err_msg=k)


def adam_step_both(conf, jparams, jg, model, tg):
    """One update of the JAX package's optimizer (optax, the config's
    optim / optim_conf, its freeze rules) on jg, and of the port's on tg:
    (new JAX params flat, new port params flat)."""
    import optax
    from reverb_tpu.train import trainer as jtrainer
    from reverb_tpu_torch.train import trainer as ttrainer
    tx, _ = jtrainer.build_optimizer(
        jtrainer.TrainConfig.from_config(conf), jparams)
    state = tx.init(jparams)

    def fill(tree, prefix=''):
        if isinstance(tree, dict):
            return {k: fill(v, f'{prefix}{k}.') for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [fill(v, f'{prefix}{i}.') for i, v in enumerate(tree)]
        return jnp.asarray(jg[prefix[:-1]])
    assert set(flatten_params(jparams)) == set(jg)
    upd, _ = tx.update(fill(jparams), state, jparams)
    new_j = flatten_params(optax.apply_updates(jparams, upd))
    opt, _ = ttrainer.build_optimizer(
        ttrainer.TrainConfig.from_config(conf), model)
    sd = convert.state_dict_from_jax(tg)
    names = [n for n, _ in model.named_parameters()]
    opt.step([sd[n] if n in sd else torch.zeros_like(p)
              for n, p in zip(names, model.parameters())])
    new_t = convert.flat_from_state_dict(
        {n: p for n, p in model.named_parameters()})
    return new_j, new_t
