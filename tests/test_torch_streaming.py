"""The streaming modules of the PyTorch port against the JAX package, f32 on
the CPU: chunk masks, the causal conv module with its cache, rel-pos
attention with a KV cache and per-stream positions, the chunk-masked
encoder, the streaming chunk forward, K2's resume entry (plain version) and
the hop-resumable beam and greedy decoders.

Same weights on both sides (the JAX tree carried over by
convert.state_dict_from_jax); width 128 so every LayerNorm goes through
the K5 functions (their plain versions here).  Activations must agree to
1e-5 (one module) or 1e-4 (the encoder); decoded tokens, times and nbest
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.decode import prefix_beam as jpb
from reverb_tpu.decode import streaming_beam as jsb
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import attention as jatt
from reverb_tpu.models import encoder as jenc
from reverb_tpu.models import presets as jpresets
from reverb_tpu.models.embedding import pe_table
from reverb_tpu.utils import common as jcommon
from reverb_tpu_torch import convert
from reverb_tpu_torch.decode import prefix_beam as tpb
from reverb_tpu_torch.decode import streaming_beam as tsb
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.models import embedding as temb
from reverb_tpu_torch.models.encoder import (init_stream_caches,
                                             subsampled_len)
from reverb_tpu_torch.ops import beam_scan as bs
from reverb_tpu_torch.ops import flash_attention as fa
from reverb_tpu_torch.utils import common as tcommon

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

D = 128
CAT = np.array([0.8, 0.2], np.float32)


def _models(seed=0, num_blocks=2, **enc):
    """(JAX params, JAX cfg, port model) with identical weights at width
    128, the encoder options `enc` set in both configs."""
    conf = jpresets.reverb_config(output_size=D, attention_heads=2,
                                  linear_units=128, num_blocks=num_blocks,
                                  dec_blocks=1, r_blocks=1, vocab_size=23)
    conf['encoder_conf'].update(enc)
    jcfg = jam.ModelConfig.from_config(conf)
    params = jam.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    for layer in params['encoder']['encoders']:
        n = layer['norm']
        n['weight'] = jnp.asarray(rng.rand(D).astype(np.float32) + .5)
        n['bias'] = jnp.asarray(rng.randn(D).astype(np.float32) * .1)
        if 'running_mean' in n:
            n['running_mean'] = jnp.asarray(rng.randn(D).astype(np.float32)
                                            * .1)
            n['running_var'] = jnp.asarray(rng.rand(D).astype(np.float32)
                                           + .5)
    tcfg = tam.ModelConfig.from_config(conf)
    model = tam.build_model(tcfg, 'cpu', convert.state_dict_from_jax(
        flatten_params(params)))
    return params, jcfg, model


@pytest.fixture(scope='module')
def causal():
    return _models(causal=True, static_chunk_size=4)


@pytest.fixture(scope='module')
def dynamic():
    return _models(use_dynamic_chunk=True, use_dynamic_left_chunk=True)


# ------------------------------ chunk masks ------------------------------

@pytest.mark.parametrize('size,chunk,left', [(1, 4, -1), (16, 4, -1),
                                             (16, 4, 1), (13, 5, 2),
                                             (30, 7, 0), (9, 16, 3)])
def test_subsequent_chunk_mask_matches_jax(size, chunk, left):
    want = np.asarray(jcommon.subsequent_chunk_mask(size, chunk, left))
    got = tcommon.subsequent_chunk_mask(size, chunk, left).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('dyn,dyn_left,dcs,static,left', [
    (True, False, -1, 0, -1), (True, False, 4, 0, -1), (True, True, 3, 0, 2),
    (True, False, 5, 4, 1), (False, False, -1, 4, -1), (False, False, 4, 5, 2),
    (False, False, -1, 0, -1), (False, True, 8, 0, 1)])
def test_add_optional_chunk_mask_matches_jax(dyn, dyn_left, dcs, static,
                                             left):
    lens = np.array([17, 11, 1])
    masks = np.arange(17)[None, None, :] < lens[:, None, None]
    want = np.asarray(jcommon.add_optional_chunk_mask(
        jnp.asarray(masks), dyn, dyn_left, dcs, static, left))
    got = tcommon.add_optional_chunk_mask(torch.from_numpy(masks), dyn,
                                          dyn_left, dcs, static, left)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dynamic_chunk_training_draw_raises():
    """The random chunk of use_dynamic_chunk training needs a generator: it
    raises without one instead of falling back to the full context, as the
    JAX package asserts an rng there; with one it draws a chunk mask."""
    masks = torch.ones((2, 1, 9), dtype=torch.bool)
    with pytest.raises(ValueError, match='generator'):
        tcommon.add_optional_chunk_mask(masks, True, False, 0, 0, -1)
    with pytest.raises(AssertionError, match='rng'):
        jcommon.add_optional_chunk_mask(jnp.ones((2, 1, 9), bool), True,
                                        False, 0, 0, -1)
    got = tcommon.add_optional_chunk_mask(
        masks, True, False, 0, 0, -1, torch.Generator().manual_seed(0))
    assert got.shape == (2, 9, 9) and bool(got[:, :, 0].all())


# ------------------------------ modules ------------------------------

@pytest.mark.parametrize('norm', ['batch_norm', 'layer_norm'])
def test_causal_conv_module_with_cache_matches_jax(norm):
    params, jcfg, model = _models(causal=True, cnn_module_norm=norm)
    p = params['encoder']['encoders'][1]
    conv = model.encoder.encoders[1].conv_module
    rng = np.random.RandomState(3)
    B, T, k1 = 2, 9, jcfg.encoder.cnn_module_kernel - 1
    x = rng.randn(B, T, D).astype(np.float32)
    cache = rng.randn(B, D, k1).astype(np.float32)
    mask = np.arange(T)[None, None, :] < np.array([9, 6])[:, None, None]
    for c, m in ((None, mask), (cache, None), (cache, mask)):
        want, wcache = jenc.conv_module(
            p, jnp.asarray(x), None if m is None else jnp.asarray(m),
            jcfg.encoder, cnn_cache=None if c is None else jnp.asarray(c))
        got, gcache = conv(torch.from_numpy(x),
                           None if m is None else torch.from_numpy(m),
                           None if c is None else torch.from_numpy(c))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(gcache.numpy(), np.asarray(wcache),
                                   atol=1e-5)
        assert gcache.shape == (B, D, k1)


@pytest.mark.parametrize('per_stream', [False, True])
def test_cached_rel_pos_attention_matches_jax(causal, per_stream):
    """A chunk of 5 frames after a 12-slot KV ring, right-aligned key mask
    (the first cache_t − min(offset, cache_t) slots invalid), rel-pos rows
    at absolute stream positions: one offset for all streams, or one per
    stream."""
    params, jcfg, model = causal
    p = params['encoder']['encoders'][0]['self_attn']
    att = model.encoder.encoders[0].self_attn
    rng = np.random.RandomState(4)
    B, T, Tc, H = 3, 5, 12, 2
    x = rng.randn(B, T, D).astype(np.float32)
    cache = rng.randn(B, H, Tc, 2 * D // H).astype(np.float32)
    off = np.array([20, 4, 0]) if per_stream else np.array([7])
    S = Tc + T
    idx = np.clip(off[:, None] - Tc + np.arange(S), 0, 4999)
    pos = pe_table(D)[idx]
    got_pos = temb.stream_position_rows(D, torch.from_numpy(off), Tc, S,
                                        torch.float32)
    np.testing.assert_array_equal(got_pos.numpy(), pos)
    valid = np.minimum(off, Tc)
    mask = np.broadcast_to(np.arange(S)[None, None, :]
                           >= Tc - valid[:, None, None], (B, 1, S))
    want, wcache = jatt.rel_pos_mha(p, *(jnp.asarray(x),) * 3,
                                    jnp.asarray(mask), jnp.asarray(pos), H,
                                    cache=jnp.asarray(cache))
    got, gcache = att.forward_masked(torch.from_numpy(x),
                                     torch.from_numpy(mask.copy()), got_pos,
                                     torch.from_numpy(cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gcache.numpy(), np.asarray(wcache), atol=1e-5)


# ------------------------------ the encoder ------------------------------

def _feats(B=2, T=71, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 80).astype(np.float32),
            np.array([T, T - 19][:B], np.int32))


@pytest.mark.parametrize('case', ['dynamic, full context', 'dynamic, chunk 4',
                                  'dynamic, chunk 4, 1 left',
                                  'causal, static chunk 4'])
def test_chunk_masked_encoder_matches_jax(causal, dynamic, case, monkeypatch):
    params, jcfg, model = causal if case.startswith('causal') else dynamic
    dcs = {'dynamic, full context': -1}.get(case, 4)
    left = 1 if '1 left' in case else -1
    feats, lens = _feats()
    want, wmask = jenc.encoder_forward(
        params['encoder'], jnp.asarray(feats), jnp.asarray(lens),
        jcfg.encoder, cat_embs=jnp.asarray(CAT), decoding_chunk_size=dcs,
        num_decoding_left_chunks=left)
    k1 = []
    rpa = fa.rel_pos_attention
    monkeypatch.setattr(fa, 'rel_pos_attention',
                        lambda *a: k1.append(1) or rpa(*a))
    with torch.no_grad():
        got, gmask = model.forward_encoder(
            torch.from_numpy(feats), torch.from_numpy(lens),
            torch.from_numpy(CAT), decoding_chunk_size=dcs,
            num_decoding_left_chunks=left)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    n = np.asarray(wmask)[:, 0].sum(-1)
    for b in range(len(n)):
        np.testing.assert_allclose(got[b, :n[b]].numpy(),
                                   np.asarray(want)[b, :n[b]], atol=1e-4)
    # full context on a use_dynamic_chunk model is the key-length mask: the
    # port keeps kernel K1 there; a chunk mask takes the masked route
    assert len(k1) == (jcfg.encoder.num_blocks if dcs < 0 else 0)


def test_dynamic_full_context_equals_the_plain_model(dynamic):
    """decoding_chunk_size < 0 on a use_dynamic_chunk model computes the
    same function as the model without the key."""
    params, jcfg, model = dynamic
    plain = dataclasses.replace(model.encoder.cfg, use_dynamic_chunk=False,
                                use_dynamic_left_chunk=False)
    feats, lens = _feats()
    with torch.no_grad():
        a, _ = model.forward_encoder(torch.from_numpy(feats),
                                     torch.from_numpy(lens),
                                     torch.from_numpy(CAT))
        model.encoder.cfg, saved = plain, model.encoder.cfg
        try:
            b, _ = model.forward_encoder(torch.from_numpy(feats),
                                         torch.from_numpy(lens),
                                         torch.from_numpy(CAT))
        finally:
            model.encoder.cfg = saved
    assert torch.equal(a, b)


@pytest.mark.parametrize('per_stream', [False, True])
def test_encoder_forward_chunk_matches_jax_per_hop(causal, per_stream):
    """Three hops of the streaming chunk forward (static-shape rings, cache
    8 frames): outputs and both caches within 1e-4 at every hop, with one
    offset, or per-stream offsets of streams that joined at different
    times."""
    params, jcfg, model = causal
    ecfg = jcfg.encoder
    c, cache_t, B = 4, 8, 2
    window = (c - 1) * ecfg.subsampling_rate + 7
    assert subsampled_len(model.encoder.cfg, window) == c
    ja, jc = jenc.init_stream_caches(ecfg, cache_t, B)
    ta, tc = init_stream_caches(model.encoder.cfg, cache_t, B)
    assert ta.shape == ja.shape and tc.shape == jc.shape
    rng = np.random.RandomState(5)
    off = np.array([0, 12]) if per_stream else np.array(0)
    for hop in range(3):
        x = rng.randn(B, window, 80).astype(np.float32)
        want, ja, jc = jenc.encoder_forward_chunk(
            params['encoder'], jnp.asarray(x), jnp.asarray(off), ecfg, ja,
            jc, cat_embs=jnp.asarray(CAT))
        with torch.no_grad():
            got, ta, tc = model.encoder.forward_chunk(
                torch.from_numpy(x), torch.as_tensor(off), ta, tc,
                torch.from_numpy(CAT))
        for g, w in ((got, want), (ta, ja), (tc, jc)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       err_msg=f'hop {hop}')
        off = off + c


def test_chunk_by_chunk_matches_jax_and_the_masked_forward(causal):
    """The whole utterance window by window: equal to JAX's within 1e-4, and
    to the port's own full forward with the chunk mask at JAX's own
    tolerance for that comparison (2e-3, tests/test_streaming.py)."""
    params, jcfg, model = causal
    c, T = 4, 4 * 4 * 4 + 7
    feats = np.random.RandomState(6).randn(1, T, 80).astype(np.float32)
    want, _ = jenc.encoder_forward_chunk_by_chunk(
        params['encoder'], jnp.asarray(feats), jcfg.encoder, c, 2,
        cat_embs=jnp.asarray(CAT))
    with torch.no_grad():
        got, mask = model.encoder.forward_chunk_by_chunk(
            torch.from_numpy(feats), c, 2, torch.from_numpy(CAT))
        full, _ = model.forward_encoder(
            torch.from_numpy(feats), torch.tensor([T]),
            torch.from_numpy(CAT), decoding_chunk_size=c,
            num_decoding_left_chunks=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert mask.shape == (1, 1, got.shape[1]) and bool(mask.all())
    ys, _ = model.encoder.forward_chunk_by_chunk(
        torch.from_numpy(feats), c, -1, torch.from_numpy(CAT))
    n = min(full.shape[1], ys.shape[1])
    np.testing.assert_allclose(ys[0, :n].detach().numpy(),
                               full[0, :n].numpy(), rtol=2e-3, atol=2e-3)


def test_config_keeps_the_dynamic_chunk_keys():
    conf = jpresets.reverb_config(output_size=D, attention_heads=2,
                                  num_blocks=2, vocab_size=23)
    conf['encoder_conf'].update(use_dynamic_chunk=True,
                                use_dynamic_left_chunk=True, causal=True,
                                static_chunk_size=8)
    enc = tam.ModelConfig.from_config(conf).encoder
    assert (enc.use_dynamic_chunk, enc.use_dynamic_left_chunk, enc.causal,
            enc.static_chunk_size) == (True, True, True, 8)


def test_compute_loss_raises_for_dynamic_chunk(dynamic):
    """use_dynamic_chunk training draws its chunk from the step's generator:
    without one the loss raises (the JAX package asserts an rng) instead of
    training without the masks; with one it gives a finite loss."""
    _, _, model = dynamic
    feats, lens = _feats()
    batch = {'feats': torch.from_numpy(feats),
             'feats_lengths': torch.from_numpy(lens),
             'target': torch.tensor([[3, 4, 5], [6, 7, -1]]),
             'target_lengths': torch.tensor([3, 2]),
             'cat_embs': torch.from_numpy(np.stack([CAT, CAT]))}
    with pytest.raises(ValueError, match='generator'):
        tam.compute_loss(model, batch)
    out = tam.compute_loss(model, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(out['loss'].detach()))


# ------------------------------ K2 resumed ------------------------------

def _topk_inputs(B, T, K, V=12, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, V).astype(np.float32) * 3
    logits[..., 0] += 1.0
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    vals, idx = torch.sort(lp, dim=-1, descending=True, stable=True)
    return lp, vals[..., :K].contiguous(), idx[..., :K].to(torch.int32)


def test_beam_scan_resume_equals_the_unsplit_scan():
    """The plain K2 resumed from the state of a scan split at frame t, for
    every t: records and all eight finals exactly those of one scan."""
    B, T, K = 3, 23, 4
    _, lp, ix = _topk_inputs(B, T, K)
    ts = torch.arange(T, dtype=torch.int32)[None].expand(B, T).contiguous()
    valid = torch.arange(T)[None] < torch.tensor([[23], [17], [0]])
    acc, hs = torch.zeros(B, T), torch.zeros(B, T, dtype=torch.bool)
    full_f, full_e = bs.beam_scan_forward_plain(lp, ix, ts, valid, acc, hs,
                                                K, 0)
    assert set(full_f) == set(tpb.STATE_KEYS)
    for t in range(T + 1):
        def part(sl):
            return (lp[:, sl], ix[:, sl], ts[:, sl], valid[:, sl],
                    acc[:, sl], hs[:, sl], K, 0)
        f1, e1 = bs.beam_scan_forward_plain(*part(slice(0, t)))
        f2, e2 = bs.beam_scan_forward(*part(slice(t, T)), state=f1)
        for n in full_e:
            assert torch.equal(torch.cat([e1[n], e2[n]]), full_e[n]), (t, n)
        for n in tpb.STATE_KEYS:
            assert torch.equal(f2[n], full_f[n]), (t, n)
    # the kernel's word layout round-trips the state exactly
    back = bs.unpack_state(bs.pack_state(full_f, B, K, 'cpu'))
    for n in tpb.STATE_KEYS:
        assert back[n].dtype == full_f[n].dtype
        assert torch.equal(back[n], full_f[n])


# ------------------------------ incremental decoders ------------------------------

@pytest.mark.parametrize('hops,init_len', [((5, 1, 16, 3, 20, 25), 8),
                                           ((16,) * 4, 512),
                                           ((1,) * 9 + (40,), 4)])
def test_incremental_beam_and_greedy_match_jax(hops, init_len):
    """Hop by hop against JAX's IncrementalBeam / IncrementalGreedy, and
    against the batch searches over the concatenated stream: tokens, times
    and nbest exact, scores within 1e-5 (a small init_len forces buffer
    growth mid-stream)."""
    K = 4
    lp, _, _ = _topk_inputs(1, sum(hops), K, seed=len(hops))
    lp = lp[0]
    jb, tb = jsb.IncrementalBeam(K, 0, init_len), \
        tsb.IncrementalBeam(K, 0, init_len, device='cpu')
    jg, tg = jsb.IncrementalGreedy(0), tsb.IncrementalGreedy(0)
    s = 0
    for h in hops:
        chunk = lp[s:s + h]
        jb.accept(jnp.asarray(chunk.numpy()))
        tb.accept(chunk)
        jg.accept(np.asarray(chunk.argmax(-1)))
        tg.accept(chunk.argmax(-1))
        s += h
        want, got = jb.finalize(), tb.finalize()
        assert got.nbest == want.nbest and got.nbest_times == want.nbest_times
        np.testing.assert_allclose(got.nbest_scores, want.nbest_scores,
                                   atol=1e-5)
        assert (tg.result().tokens, tg.result().times) == \
            (jg.result().tokens, jg.result().times)
        batch = tpb.ctc_prefix_beam_search_raw(lp[None, :s], torch.tensor([s]),
                                               K, 0)[0][0]
        assert batch.nbest == got.nbest and batch.nbest_times == \
            got.nbest_times
    jbatch = jpb.ctc_prefix_beam_search(jnp.asarray(lp[None].numpy()),
                                        jnp.asarray([s]), K, 0)[0]
    assert jbatch.nbest == tb.finalize().nbest
    assert tb.L >= max(len(h) for h in tb.finalize().nbest)


def test_beams_default_to_the_card():
    """BeamBank and IncrementalBeam run on the card unless the caller asks
    for the CPU: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='cuda'):
        tsb.BeamBank(2, 3)
    with pytest.raises(RuntimeError, match='cuda'):
        tsb.IncrementalBeam(3)
    assert tsb.IncrementalBeam(3, device='cpu').bank.device.type == 'cpu'


def test_beam_bank_holds_streams_that_are_not_ready():
    """A BeamBank hop with a stream not ready leaves that stream's beam and
    offset as they were: the same as hopping the ready streams alone."""
    K = 3
    lp, _, _ = _topk_inputs(2, 12, K, seed=9)
    bank = tsb.BeamBank(2, K, 0, init_len=4, device='cpu')
    solo = [tsb.IncrementalBeam(K, 0, init_len=4, device='cpu')
            for _ in range(2)]
    for h, ready in ((4, [True, False]), (4, [True, True]),
                     (4, [False, True])):
        lo = int(bank.offsets.max())
        bank.hop(lp[:, lo:lo + h], np.array(ready))
        for b in range(2):
            if ready[b]:
                solo[b].accept(lp[b, lo:lo + h])
    for b in range(2):
        got, want = bank.finalize(b), solo[b].finalize()
        assert got.nbest == want.nbest and got.nbest_times == want.nbest_times
        assert int(bank.offsets[b]) == solo[b].offset
    bank.reset_slot(0)
    assert bank.finalize(0).nbest == [[]] and int(bank.offsets[0]) == 0
    assert bank.finalize(1).nbest == solo[1].finalize().nbest


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('B,T', [(1, 1), (1, 16), (8, 16), (8, 33)])
def test_beam_scan_kernel_resumes_like_the_plain_scan(cuda, B, T):
    """K2 on the card, resumed from the state of a 40-frame prefix: records
    and all eight finals exactly those of the plain scan."""
    K = 10
    _, lp, ix = _topk_inputs(B, 40 + T, K, V=50, seed=B + T)
    lp, ix = lp.to(cuda), ix.to(cuda)

    def args(sl, t0):
        n = sl.stop - sl.start
        ts = (t0 + torch.arange(n, dtype=torch.int32, device=cuda))[None]
        return (lp[:, sl].contiguous(), ix[:, sl].contiguous(),
                ts.expand(B, n).contiguous(),
                torch.ones((B, n), dtype=torch.bool, device=cuda),
                torch.zeros((B, n), device=cuda),
                torch.zeros((B, n), dtype=torch.bool, device=cuda), K, 0)
    state, _ = bs.beam_scan_forward_plain(*args(slice(0, 40), 0))
    got = bs.beam_scan_forward(*args(slice(40, 40 + T), 40), state=state)
    want = bs.beam_scan_forward_plain(*args(slice(40, 40 + T), 40),
                                      state=state)
    for n in want[1]:
        assert torch.equal(got[1][n], want[1][n]), n
    for n in tpb.STATE_KEYS:
        assert torch.equal(got[0][n], want[0][n]), n
