"""Model modules of the PyTorch port against the JAX package, f32 on CPU.

Same weights on both sides: the JAX parameter tree is initialized, then
carried into the port through convert.state_dict_from_jax.  Activations
must agree to 1e-4 (summation order differs, nothing else); fbank is held
to the kaldi goldens' own 1e-3 log-domain bar.  Where the JAX side reaches
the Pallas attention kernel it runs in interpret mode.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params, save_npz
from reverb_tpu.frontend import fbank as jfb
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import ctc as jctc
from reverb_tpu.models import decoder as jdec
from reverb_tpu.models import encoder as jenc
from reverb_tpu.models import presets as jpresets
from reverb_tpu.ops import flash_attention as jfa
from reverb_tpu_torch import convert
from reverb_tpu_torch.decode import rescoring as trs
from reverb_tpu_torch.frontend import fbank as tfb
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.models import ctc as tctc
from reverb_tpu_torch.models import presets as tpresets
from reverb_tpu_torch.models.encoder import ConformerEncoderLayer
from reverb_tpu_torch.ops.topk import topk_lastdim

from test_fbank import _oracle_cases

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

ATOL = 1e-4
CAT = np.array([0.7, 0.3], np.float32)


def _config(lsl_decoder=False, num_blocks=3):
    conf = jpresets.reverb_config(output_size=64, attention_heads=4,
                                  linear_units=96, num_blocks=num_blocks,
                                  dec_blocks=3, r_blocks=2, vocab_size=23)
    if lsl_decoder:
        conf['decoder'] = 'lsl_bitransformer'
    return conf


def _models(conf, seed=0, cmvn=True):
    """(JAX params, JAX cfg, port model) with identical weights."""
    jcfg = jam.ModelConfig.from_config(conf)
    rng = np.random.RandomState(seed)
    stats = ((rng.randn(80) * 0.5).astype(np.float32),
             (rng.rand(80) + 0.5).astype(np.float32)) if cmvn else None
    params = jam.init_params(jax.random.PRNGKey(seed), jcfg, cmvn=stats)
    # non-trivial batch-norm statistics and layer-norm affines
    for layer in params['encoder']['encoders']:
        n = layer['norm']
        n['running_mean'] = jnp.asarray(rng.randn(64).astype(np.float32) * .1)
        n['running_var'] = jnp.asarray(rng.rand(64).astype(np.float32) + .5)
        n['weight'] = jnp.asarray(rng.rand(64).astype(np.float32) + .5)
    tcfg = tam.ModelConfig.from_config(conf)
    sd = convert.state_dict_from_jax(flatten_params(params))
    model = tam.build_model(tcfg, 'cpu', sd)
    return params, jcfg, model


# ------------------------------ frontend ------------------------------

@pytest.mark.parametrize('name', list(_oracle_cases()))
def test_fbank_matches_kaldi_golden_and_jax(name):
    sr, wave = _oracle_cases()[name]
    golden = np.load(os.path.join(os.path.dirname(__file__), 'golden',
                                  f'fbank_{name}.npy'))
    got = tfb.compute_fbank(torch.from_numpy(wave),
                            tfb.FbankConfig(sample_rate=sr)).numpy()
    ref = np.asarray(jfb.compute_fbank(wave, jfb.FbankConfig(sample_rate=sr)))
    assert got.shape == golden.shape == ref.shape
    # the goldens' own bar (test_fbank.py): log-domain 1e-3 abs
    np.testing.assert_allclose(got, golden, atol=1e-3, rtol=1e-4)
    # against JAX (its f32 rFFT vs the port's f64 one): the same bar
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-4)


def test_fbank_config_tables_match_jax():
    cfg_t, cfg_j = tfb.FbankConfig(), jfb.FbankConfig()
    np.testing.assert_array_equal(tfb.mel_banks(cfg_t), jfb.mel_banks(cfg_j))
    np.testing.assert_array_equal(tfb._povey_window(400),
                                  jfb._povey_window(400))
    for n in (0, 399, 400, 16000, 480000):
        assert tfb.num_frames(n, cfg_t) == jfb.num_frames(n, cfg_j)


# ------------------------------ encoder ------------------------------

@pytest.fixture(scope='module')
def flagship_small():
    return _models(_config())


def _encoder_inputs(B=2, T=83, seed=1):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, 80).astype(np.float32)
    lens = np.array([T, T - 30], np.int32)[:B]
    return feats, lens


def test_lsl_conformer_layer_matches_jax(flagship_small):
    params, jcfg, model = flagship_small
    ecfg = jcfg.encoder
    rng = np.random.RandomState(2)
    B, T, d = 2, 21, 64
    x = rng.randn(B, T, d).astype(np.float32)
    pos = rng.randn(1, T, d).astype(np.float32)
    lens = np.array([21, 13])
    mask = np.arange(T)[None, None, :] < lens[:, None, None]
    jfa.set_use_pallas(True)
    try:
        want, _, _ = jenc.conformer_layer(
            params['encoder']['encoders'][0], jnp.asarray(x),
            jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(mask), ecfg,
            cat_embs=jnp.asarray(CAT), is_lsl=True)
    finally:
        jfa.set_use_pallas(None)
    layer = model.encoder.encoders[0]
    assert isinstance(layer, ConformerEncoderLayer) and layer.is_lsl
    got = layer(torch.from_numpy(x), torch.from_numpy(lens).int(),
                torch.from_numpy(pos), torch.from_numpy(mask),
                torch.from_numpy(CAT))
    for b in range(B):
        np.testing.assert_allclose(got[b, :lens[b]].numpy(),
                                   np.asarray(want)[b, :lens[b]], atol=ATOL)


def test_encoder_matches_jax(flagship_small):
    params, jcfg, model = flagship_small
    feats, lens = _encoder_inputs()
    jfa.set_use_pallas(True)
    try:
        want, wmask = jam.forward_encoder(params, jcfg, jnp.asarray(feats),
                                          jnp.asarray(lens),
                                          cat_embs=jnp.asarray(CAT))
    finally:
        jfa.set_use_pallas(None)
    got, gmask = model.forward_encoder(torch.from_numpy(feats),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(CAT))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    n = np.asarray(wmask)[:, 0].sum(-1)
    for b in range(len(n)):
        np.testing.assert_allclose(got[b, :n[b]].numpy(),
                                   np.asarray(want)[b, :n[b]], atol=ATOL)


# ------------------------------ decoder / rescoring ------------------------

def _hyps(rng, B, N, L, V):
    hyps = rng.randint(1, V - 1, size=(B, N, L)).astype(np.int32)
    lens = rng.randint(0, L + 1, size=(B, N)).astype(np.int32)
    lens[0, 0] = L
    return hyps, lens


@pytest.mark.parametrize('lsl_decoder', [False, True])
def test_bitransformer_decoder_matches_jax(lsl_decoder):
    conf = _config(lsl_decoder=lsl_decoder, num_blocks=2)
    params, jcfg, model = _models(conf, seed=3)
    assert jcfg.lsl_dec == lsl_decoder == model.cfg.lsl_dec
    rng = np.random.RandomState(4)
    B, N, L, T = 2, 3, 7, 19
    mem = rng.randn(B, T, 64).astype(np.float32)
    mem_mask = (np.arange(T)[None, None, :]
                < np.array([T, 11])[:, None, None])
    ys = rng.randint(0, 23, size=(B * N, L)).astype(np.int32)
    ys_lens = rng.randint(1, L + 1, size=(B * N,)).astype(np.int32)
    r_ys = rng.randint(0, 23, size=(B * N, L)).astype(np.int32)
    dp = params['decoder']
    from reverb_tpu.models import attention as jatt
    kv = [jatt.cross_kv_batched(l['src_attn'], jnp.asarray(mem), 4)
          for l in dp['left_decoder']['decoders']]
    r_kv = [jatt.cross_kv_batched(l['src_attn'], jnp.asarray(mem), 4)
            for l in dp['right_decoder']['decoders']]
    cat = jnp.asarray(CAT) if lsl_decoder else None
    wl, wr = jdec.decoder_forward(dp, jnp.asarray(mem), jnp.asarray(mem_mask),
                                  jnp.asarray(ys), jnp.asarray(ys_lens),
                                  jnp.asarray(r_ys), 0.3, jcfg.decoder,
                                  cat_embs=cat, mem_kv=kv, r_mem_kv=r_kv,
                                  mem_group=N)
    gl, gr = model.decoder(torch.from_numpy(mem), torch.from_numpy(mem_mask),
                           torch.from_numpy(ys), torch.from_numpy(ys_lens),
                           torch.from_numpy(r_ys), 0.3,
                           torch.from_numpy(CAT) if lsl_decoder else None,
                           mem_group=N)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=ATOL)


@pytest.mark.parametrize('reverse_weight', [0.0, 0.3])
def test_rescore_device_all_matches_jax(flagship_small, reverse_weight):
    from reverb_tpu.decode import rescoring as jrs
    params, jcfg, model = flagship_small
    rng = np.random.RandomState(5)
    B, N, L, T = 2, 4, 9, 17
    hyps, lens = _hyps(rng, B, N, L, 23)
    enc = rng.randn(B, T, 64).astype(np.float32)
    enc_lens = np.array([T, 12], np.int32)
    want = jrs._rescore_device_all(params, jcfg, jnp.asarray(hyps),
                                   jnp.asarray(lens), jnp.asarray(enc),
                                   reverse_weight, jnp.asarray(CAT),
                                   jnp.asarray(enc_lens))
    got = trs._rescore_device_all(model, torch.from_numpy(hyps),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(enc), reverse_weight,
                                  torch.from_numpy(CAT),
                                  torch.from_numpy(enc_lens))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


# ------------------------------ CTC head ------------------------------

def test_ctc_topk_logprobs_ties_and_values():
    """Integer-valued (so bf16-exact) logits with many ties: indices exact,
    ties to the lowest index like the reference's top-k."""
    rng = np.random.RandomState(6)
    B, T, D, V, k = 2, 15, 8, 40, 10
    enc = rng.randint(-1, 2, size=(B, T, D)).astype(np.float32)
    w = rng.randint(-1, 2, size=(V, D)).astype(np.float32)
    w[10:20] = w[0:10]                                  # duplicate rows
    b = np.zeros(V, np.float32)
    jp = {'ctc_lo': {'weight': jnp.asarray(w), 'bias': jnp.asarray(b)}}
    head = tctc.CTC(V, D).requires_grad_(False)
    head.load_state_dict({'ctc_lo.weight': torch.from_numpy(w),
                          'ctc_lo.bias': torch.from_numpy(b)})
    for penalty in (0.0, 1.0):
        wl, wi, wb = jctc.ctc_topk_logprobs(jp, jnp.asarray(enc), k, penalty,
                                            0)
        gl, gi, gb = tctc.ctc_topk_logprobs(head, torch.from_numpy(enc), k,
                                            penalty, 0)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=ATOL)


def test_topk_breaks_ties_to_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = topk_lastdim(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]
    xb = x.to(torch.bfloat16)
    assert topk_lastdim(xb, 4)[1].tolist() == [[1, 2, 4, 3]]


def test_topk_matches_lax_top_k_on_ties_and_infs():
    """The tie cases tests/test_beam_kernel.py pins for the Pallas top-k:
    -inf entries, a row of -1e30, runs of equal values."""
    rng = np.random.RandomState(0)
    x = rng.randn(7, 110).astype(np.float32)
    x[0, 5:20] = -np.inf
    x[1, :] = -1e30
    x[2, 10:14] = x[2, 3]
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 10)
    got_v, got_i = topk_lastdim(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ------------------------------ weight bridge ------------------------------

def test_state_dict_bridge_round_trip(flagship_small, tmp_path):
    """JAX tree → port (strict) → back, exact; the JAX .npz loads the same
    way, and a WeNet-keyed .pt (nested conv_module, num_batches_tracked)
    loads to the same weights."""
    params, _, model = flagship_small
    flat = flatten_params(params)
    sd = model.state_dict()
    assert set(sd) == set(convert.state_dict_from_jax(flat))
    assert any('.conv_module.norm.running_var' in k for k in sd)
    assert 'encoder.global_cmvn.istd' in sd
    back = {k.replace('.conv_module.', '.'): v.numpy() for k, v in sd.items()}
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg=k)

    save_npz(str(tmp_path / 'm.npz'), params)
    from_npz = convert.state_dict_from_jax(
        convert.load_flat_checkpoint(str(tmp_path / 'm.npz')))
    wenet = {k: v.clone() for k, v in sd.items()}
    for i in range(len(model.encoder.encoders)):
        wenet[f'encoder.encoders.{i}.conv_module.norm.num_batches_tracked'] \
            = torch.tensor(7)
    torch.save({'model0': wenet}, tmp_path / 'm.pt')
    from_pt = convert.state_dict_from_jax(
        convert.load_flat_checkpoint(str(tmp_path / 'm.pt')))
    for other in (from_npz, from_pt):
        assert set(other) == set(sd)
        for k in sd:
            assert torch.equal(other[k], sd[k]), k


def test_presets_match_jax():
    for name in ('reverb_large', 'reverb_small', 'reverb_tiny'):
        assert getattr(tpresets, name)() == getattr(jpresets, name)()
    cfg = tam.ModelConfig.from_config(tpresets.reverb_large())
    assert (cfg.encoder.num_blocks, cfg.encoder.output_size,
            cfg.encoder.attention_heads, cfg.encoder.num_langs,
            cfg.vocab_size) == (18, 1024, 16, 2, 10000)
    assert cfg.lsl_enc and not cfg.lsl_dec


def test_random_init_is_seeded():
    cfg = tam.ModelConfig.from_config(_config(num_blocks=1))
    a = tam.build_model(cfg, 'cpu', generator=torch.Generator().manual_seed(3))
    b = tam.build_model(cfg, 'cpu', generator=torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
        assert torch.isfinite(x).all(), k
