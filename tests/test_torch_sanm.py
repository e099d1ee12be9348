"""The port's SANM stack (reverb_tpu_torch/models/sanm.py) and its SANM
Paraformer forward against the JAX package's (reverb_tpu/models/sanm.py),
f32 on the CPU with the same weights: the LFR gather exactly; the encoder
(asymmetric fsmn padding from the misspelled `sanm_shfit` key, post-LFR
CMVN, a padded row); the decoder with both of its LayerNorm eps values
made to matter; the whole forward with the timestamp branch on a padded
batch (log-probs, token counts exactly, tp α).  The model: 2 + 2 blocks,
d = 32, 4 heads, V = 40, 16 mel bins stacked 7 / 6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import paraformer as jpara
from reverb_tpu.models import sanm as jsanm
from reverb_tpu.models.registry import init_model as jinit
from reverb_tpu.models.registry import sanm_configs as j_sanm_configs
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import registry as treg
from reverb_tpu_torch.models import sanm as tsanm

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

V = 40


def sanm_conf(**model_conf):
    return {'model': 'paraformer', 'encoder': 'sanm_encoder',
            'input_dim': 16, 'output_dim': V,
            'encoder_conf': {'output_size': 32, 'attention_heads': 4,
                             'linear_units': 48, 'num_blocks': 2,
                             'kernel_size': 5, 'sanm_shfit': 1,
                             'sanm_shift': 0, 'dropout_rate': 0.0},
            'decoder_conf': {'num_blocks': 2},
            'lfr_conf': {'lfr_m': 7, 'lfr_n': 6},
            'cif_conf': {'l_order': 1, 'r_order': 1, 'cnn_groups': 1,
                         'residual': False, 'tail_threshold': 0.45},
            'model_conf': dict({'sampler': False, 'ctc_weight': 0.0},
                               **model_conf)}


def feats(seed=0, T=180, short=49):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, T, 16).astype(np.float32),
            np.array([T, T - short], np.int32))


def cmvn_stats(dim, seed=3):
    rng = np.random.RandomState(seed)
    return ((rng.randn(dim) * 0.3).astype(np.float32),
            (rng.rand(dim) + 0.5).astype(np.float32))


@pytest.fixture(scope='module')
def models():
    """(JAX params with the tp branch, SanmConfig, CifConfig, CMVN, the
    port's model from the same weights)."""
    conf = sanm_conf()
    scfg, cif = j_sanm_configs(conf)
    cmvn = cmvn_stats(scfg.input_size)
    p = jinit(conf, jax.random.PRNGKey(0)).params
    p['predictor'].update(jpara.init_predictor_tp(jax.random.PRNGKey(5),
                                                  cif))
    # a nonzero tp bias and BiLSTM biases, so the bridge carries them
    rng = np.random.RandomState(9)
    p['predictor']['tp_upsample_cnn']['bias'] = jnp.asarray(
        rng.randn(scfg.output_size).astype(np.float32) * 0.1)
    for side in ('fwd', 'bwd'):
        p['predictor']['tp_blstm'][side]['b'] = jnp.asarray(
            rng.randn(4 * scfg.output_size).astype(np.float32) * 0.1)
    tb = treg.init_model(conf, device='cpu', cmvn=cmvn,
                         state_dict=convert.state_dict_from_jax(
                             flatten_params(p)))
    return p, scfg, cif, cmvn, tb.model.eval()


def test_sanm_configs_read_the_misspelled_shift():
    conf = sanm_conf()
    jscfg, jcif = j_sanm_configs(conf)
    scfg, cif = treg.sanm_configs(conf)
    assert dataclasses.asdict(scfg) == dataclasses.asdict(jscfg)
    assert dataclasses.asdict(cif) == dataclasses.asdict(jcif)
    assert scfg.sanm_shift == 1 and scfg.fsmn_pad == (3, 1)
    assert scfg.input_size == 112


def test_lfr_matches_jax():
    x, lens = feats(T=47, short=20)
    lens = np.array([47, 1], np.int32)          # a one-frame row clamps
    want, wl = jsanm.lfr(jnp.asarray(x), jnp.asarray(lens), 7, 6)
    got, gl = tsanm.lfr(torch.from_numpy(x), torch.from_numpy(lens), 7, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_sanm_encoder_matches_jax(models):
    p, scfg, _, cmvn, model = models
    x, lens = feats()
    want, wmask = jsanm.sanm_encoder_forward(
        p['encoder'], jnp.asarray(x), jnp.asarray(lens), scfg,
        cmvn=tuple(jnp.asarray(c) for c in cmvn))
    with torch.no_grad():
        got, gmask = model.encoder(torch.from_numpy(x),
                                   torch.from_numpy(lens))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert gmask[1, 0].sum() == 22 and got.shape == (2, 30, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # the CMVN is applied: without it the output moves
    saved = model.encoder.cmvn_mean
    model.encoder.cmvn_mean = None
    try:
        with torch.no_grad():
            plain = model.encoder(torch.from_numpy(x),
                                  torch.from_numpy(lens))[0]
    finally:
        model.encoder.cmvn_mean = saved
    assert float((plain - got).abs().max()) > 1e-2


def _decoder_inputs(scfg, seed=1, scale=1e-4):
    rng = np.random.RandomState(seed)
    mem = rng.randn(2, 30, scfg.output_size).astype(np.float32)
    mem_mask = np.arange(30)[None, None, :] < np.array([30, 22])[:, None,
                                                                 None]
    emb = (rng.randn(2, 9, scfg.output_size) * scale).astype(np.float32)
    return mem, mem_mask, emb, np.array([9, 6], np.int32)


def _small_variance_decoder(p):
    """The JAX decoder tree with layer 0's FFN input weights and the tail's
    output weights scaled down: the 1e-12 norms (norm1 of layer 0 on tiny
    embeddings) and the 1e-5 norms (layer 0's FFN norm, after_norm) then
    see row variances near or below eps."""
    d = jax.tree.map(lambda a: a, p['decoder'])
    ff = d['decoders'][0]['feed_forward']
    ff['w_1'] = {k: v * 1e-4 for k, v in ff['w_1'].items()}
    tail = d['decoders3'][0]['feed_forward']
    tail['w_2'] = {'weight': tail['w_2']['weight'] * 1e-5}
    return d


def _decoder_model(scfg, tree):
    m = tsanm.SanmDecoder(scfg)
    m.load_state_dict(convert.state_dict_from_jax(flatten_params(tree)),
                      strict=True)
    return m.eval()


def test_sanm_decoder_matches_jax_at_both_eps(models):
    """The decoder layers' norm1-norm3 and decoders3's norm1 use eps
    1e-12, the FFN's inner norm and after_norm 1e-5; with row variances
    near eps the output agrees with JAX's, and setting either group's eps
    to the other value moves it away."""
    p, scfg, _, _, _ = models
    tree = _small_variance_decoder(p)
    mem, mem_mask, emb, ys_lens = _decoder_inputs(scfg)
    want = np.asarray(jsanm.sanm_decoder_forward(
        tree, jnp.asarray(mem), jnp.asarray(mem_mask), jnp.asarray(emb),
        jnp.asarray(ys_lens), scfg))
    model = _decoder_model(scfg, tree)

    def run():
        with torch.no_grad():
            return model(torch.from_numpy(mem), torch.from_numpy(mem_mask),
                         torch.from_numpy(emb),
                         torch.from_numpy(ys_lens)).numpy()
    np.testing.assert_allclose(run(), want, rtol=0, atol=1e-4)
    groups = {1e-12: [], 1e-5: []}
    for name, m in model.named_modules():
        if isinstance(m, tsanm.LayerNorm):
            groups[m.eps].append(m)
    assert len(groups[1e-12]) == 3 * scfg.decoder_blocks + 1
    assert len(groups[1e-5]) == scfg.decoder_blocks + 2
    for eps, other in ((1e-12, 1e-5), (1e-5, 1e-12)):
        for m in groups[eps]:
            m.eps = other
        moved = float(np.abs(run() - want).max())
        for m in groups[eps]:
            m.eps = eps
        assert moved > 1e-2, (eps, moved)


def test_sanm_forward_paraformer_matches_jax(models):
    """The whole forward with the timestamp branch, on a padded batch:
    log-probs, token counts exactly, and the tp α (whose BiLSTM reads the
    padding first in its backward direction)."""
    p, scfg, cif, cmvn, model = models
    x, lens = feats()
    jc = tuple(jnp.asarray(c) for c in cmvn)
    logp, num, tp = jsanm.sanm_forward_paraformer(
        p, jnp.asarray(x), jnp.asarray(lens), scfg, cif, max_tokens=16,
        cmvn=jc)
    with torch.no_grad():
        glogp, gnum, gtp = model.forward_paraformer(
            torch.from_numpy(x), torch.from_numpy(lens), max_tokens=16)
    np.testing.assert_array_equal(gnum.numpy(), np.asarray(num))
    assert gnum.dtype == torch.int32 and int(gnum.min()) > 0
    np.testing.assert_allclose(glogp.numpy(), np.asarray(logp), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(gtp.numpy(), np.asarray(tp), rtol=0,
                               atol=1e-5)
    assert gtp.shape == (2, 90) and float(gtp[1, 66:].abs().max()) == 0.0
    # the padded row's BiLSTM reads its padding: running it alone on its
    # valid frames gives other tp values
    with torch.no_grad():
        alone = model.forward_paraformer(
            torch.from_numpy(x[1:, :131]), torch.from_numpy(lens[1:]),
            max_tokens=16)[2]
    assert float((alone[0, :66] - gtp[1, :66]).abs().max()) > 1e-6


def test_state_dict_names_are_wenets(models):
    """The port's parameter names are WeNet's (and the JAX tree's, whose
    tp BiLSTM is fwd/bwd with one bias): the state dict goes back to the
    JAX tree exactly, the second LSTM biases summed in."""
    p, _, _, _, model = models
    names = set(model.state_dict())
    for key in ('encoder.encoders0.0.self_attn.linear_q_k_v.weight',
                'encoder.encoders.0.self_attn.fsmn_block.weight',
                'decoder.decoders.1.src_attn.linear_k_v.bias',
                'decoder.decoders.0.self_attn.fsmn_block.weight',
                'decoder.decoders3.0.feed_forward.norm.weight',
                'predictor.tp_blstm.weight_ih_l0_reverse',
                'predictor.tp_upsample_cnn.weight'):
        assert key in names, key
    flat = convert.flat_from_state_dict(model.state_dict())
    want = flatten_params(p)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)
