"""Kernel modules of the PyTorch port against the JAX package.

K1 (rel-pos attention) and K2/K3 (prefix-beam scan and backtrace) take
their plain PyTorch versions on CPU tensors; here those are held to the
JAX functions running their Pallas kernels in interpret mode.  The CUDA
kernels themselves are held to the plain versions by the `cuda`-marked
tests at the end (they skip without a card) and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.decode import prefix_beam as jpb
from reverb_tpu.models import attention as jatt
from reverb_tpu.ops import flash_attention as jfa
from reverb_tpu_torch.decode import prefix_beam as tpb
from reverb_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from reverb_tpu_torch.ops import beam_scan, flash_attention

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_pos_params(rng, d, h):
    def lin(i, o, bias=True):
        p = {'weight': (rng.randn(o, i) / np.sqrt(i)).astype(np.float32)}
        if bias:
            p['bias'] = (rng.randn(o) * 0.1).astype(np.float32)
        return p
    return {'linear_q': lin(d, d), 'linear_k': lin(d, d),
            'linear_v': lin(d, d), 'linear_out': lin(d, d),
            'linear_pos': lin(d, d, bias=False),
            'pos_bias_u': (rng.randn(h, d // h) * 0.1).astype(np.float32),
            'pos_bias_v': (rng.randn(h, d // h) * 0.1).astype(np.float32)}


@pytest.mark.parametrize('T,lens', [(37, (37, 21)), (130, (130, 64))])
def test_rel_pos_attention_matches_pallas_interpret(T, lens):
    """Tolerance 2e-5 on valid rows: both sides are f32 and differ only in
    summation order (padded query rows are garbage on both sides)."""
    d, h, B = 64, 4, 2
    rng = np.random.RandomState(0)
    p = _rel_pos_params(rng, d, h)
    x = rng.randn(B, T, d).astype(np.float32)
    pos = rng.randn(1, T, d).astype(np.float32)
    mask = np.arange(T)[None, None, :] < np.asarray(lens)[:, None, None]
    jfa.set_use_pallas(True)
    try:
        ref, _ = jatt.rel_pos_mha(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jnp.asarray(x),
                                  jnp.asarray(x), jnp.asarray(mask),
                                  jnp.asarray(pos), h)
    finally:
        jfa.set_use_pallas(None)
    mod = RelPositionMultiHeadedAttention(h, d)
    mod.load_state_dict({
        'linear_q.weight': _t(p['linear_q']['weight']),
        'linear_q.bias': _t(p['linear_q']['bias']),
        'linear_k.weight': _t(p['linear_k']['weight']),
        'linear_k.bias': _t(p['linear_k']['bias']),
        'linear_v.weight': _t(p['linear_v']['weight']),
        'linear_v.bias': _t(p['linear_v']['bias']),
        'linear_out.weight': _t(p['linear_out']['weight']),
        'linear_out.bias': _t(p['linear_out']['bias']),
        'linear_pos.weight': _t(p['linear_pos']['weight']),
        'pos_bias_u': _t(p['pos_bias_u']), 'pos_bias_v': _t(p['pos_bias_v'])})
    with torch.no_grad():
        got = mod(_t(x), torch.tensor(lens, dtype=torch.int32), _t(pos))
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L].numpy(), np.asarray(ref)[b, :L],
                                   rtol=2e-5, atol=2e-5)


def test_rel_pos_attention_empty_row_is_zero():
    """kv_len 0 gives a 0 output, as in the TPU kernel."""
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(2, 2, 9, 8).astype(np.float32)) for _ in range(3))
    pos = _t(rng.randn(1, 2, 9, 8).astype(np.float32))
    u = _t(rng.randn(2, 8).astype(np.float32))
    out = flash_attention.rel_pos_attention(q, k, v, pos, u, u,
                                            torch.tensor([9, 0]))
    assert torch.count_nonzero(out[1]) == 0
    assert torch.isfinite(out).all()


def test_bf16_operands_are_made_16_byte_readable():
    """The bf16 kernels copy 16 bytes a thread: an operand that starts off
    a 16-byte boundary, or has a row stride that is no multiple of 8
    elements, is copied; an aligned strided view is passed as it is."""
    bf = torch.bfloat16
    whole = torch.zeros(2, 5, 3, 64, dtype=bf)
    view = whole.transpose(1, 2)               # (B, H, T, dk) of (B, T, H, dk)
    assert flash_attention._aligned(view) is view
    shifted = torch.arange(4 * 64 + 1, dtype=bf)[1:].view(4, 64)
    padded = torch.arange(4 * 68, dtype=bf).view(4, 68)[:, :64]
    for t in (shifted, padded):
        got = flash_attention._aligned(t)
        assert got is not t and torch.equal(got, t)
        assert got.data_ptr() % 16 == 0 and got.stride(0) % 8 == 0
    # the keep-mask: only its start matters (rows of any length)
    mask = torch.ones(1, 1, 3, 333, dtype=torch.int8)
    assert flash_attention._aligned(mask, strides=False) is mask


def _rand_topk(rng, B, T, K2, V, peaky=False):
    logits = rng.randn(B, T, V).astype(np.float32)
    if peaky:
        logits[..., 0] += rng.uniform(1.0, 4.0, (B, T)).astype(np.float32)
    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    tk_logp, tk_idx = jax.lax.top_k(logp, K2)
    return (np.asarray(tk_logp), np.asarray(tk_idx).astype(np.int32),
            np.asarray(logp[..., 0]))


def _assert_beam_equal(got, want):
    """Tokens, plens and times exact; scores to 1e-5 (both f32, the
    log1p/exp implementations of the two frameworks may differ by an ulp)."""
    for g, w, name in zip(got, want, ['prefixes', 'plens', 'scores',
                                      'times']):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if w.dtype.kind == 'f':
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('num_t', [(40, 17, 1), (1, 1, 1), (40, 40, 40)])
def test_beam_dense_matches_pallas_interpret(num_t):
    rng = np.random.RandomState(1)
    B, T, K2, V, K = 3, 40, 5, 30, 5
    lp, ix, _ = _rand_topk(rng, B, T, K2, V)
    want = jpb._search_batched(jnp.asarray(lp), jnp.asarray(ix),
                               jnp.asarray(num_t, jnp.int32), K, 0, T,
                               interpret=True)
    got = tpb._search_batched(_t(lp), _t(ix), torch.tensor(num_t), K, 0, T)
    _assert_beam_equal(got, want)


@pytest.mark.parametrize('num_t', [(60, 33), (1, 60)])
def test_beam_blank_skip_matches_pallas_interpret(num_t):
    rng = np.random.RandomState(2)
    B, T, K2, V, K = 2, 60, 5, 30, 5
    lp, ix, blank = _rand_topk(rng, B, T, K2, V, peaky=True)
    cap = T // 2
    n = jnp.asarray(num_t, jnp.int32)
    ts, n_keep, acc, hs, tail = jpb._compress_blanks(jnp.asarray(blank), n,
                                                     0.6, cap)
    g_lp = jnp.take_along_axis(jnp.asarray(lp), ts[..., None], axis=1)
    g_ix = jnp.take_along_axis(jnp.asarray(ix), ts[..., None], axis=1)
    want = jpb._search_batched(g_lp, g_ix, n_keep, K, 0, cap, ts, acc, hs,
                               tail, None, interpret=True)
    t_ts, t_nk, t_acc, t_hs, t_tail = tpb._compress_blanks(
        _t(blank), torch.tensor(num_t), 0.6, cap)
    for g, w in zip((t_ts, t_nk, t_hs), (ts, n_keep, hs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(acc), atol=1e-5)
    np.testing.assert_allclose(t_tail.numpy(), np.asarray(tail), atol=1e-5)
    idx = t_ts.long()[..., None].expand(-1, -1, K2)
    got = tpb._search_batched(torch.gather(_t(lp), 1, idx).contiguous(),
                              torch.gather(_t(ix), 1, idx).contiguous(),
                              t_nk, K, 0, cap, t_ts, t_acc, t_hs, t_tail)
    _assert_beam_equal(got, want)


@pytest.mark.parametrize('threshold', [0.0, 0.9])
def test_beam_entry_point_matches_jax(threshold):
    """ctc_prefix_beam_search_device_topk end to end, including the
    half-length scan choice under blank-skip."""
    rng = np.random.RandomState(4)
    B, T, K2, V, K = 3, 64, 6, 40, 6
    lp, ix, blank = _rand_topk(rng, B, T, K2, V, peaky=True)
    lens = np.array([64, 50, 9], np.int32)
    cap = T // 2 if threshold > 0 else 0
    want = jpb.ctc_prefix_beam_search_device_topk(
        jnp.asarray(lp), jnp.asarray(ix), jnp.asarray(blank),
        jnp.asarray(lens), K, 0, 48, threshold, cap)
    got = tpb.ctc_prefix_beam_search_device_topk(
        _t(lp), _t(ix), _t(blank), _t(lens), K, 0, 48, threshold, cap)
    _assert_beam_equal(got, want)


# (B, T, K, K2, num_t, L): the shapes the card's exact checks of the
# redesigned kernels lean on — the 128-candidate limit, a small square beam,
# one frame, a row of no frames, and L = T (the uncapped search)
BEAM_SHAPES = [(2, 24, 16, 7, (24, 13), 24),
               (2, 24, 4, 4, (24, 9), 16),
               (2, 1, 5, 5, (1, 1), 8),
               (3, 20, 5, 5, (20, 0, 7), 20),
               (2, 70, 6, 6, (70, 66), 70)]


@pytest.mark.parametrize('B,T,K,K2,num_t,L', BEAM_SHAPES)
def test_plain_scan_and_walk_match_pallas_interpret(B, T, K, K2, num_t, L):
    """The plain K2 and K3 against the Pallas kernels in interpret mode:
    every record, prefix and time exactly; the final scores to 1e-5 (f32
    on both sides, log1p/exp may differ by an ulp)."""
    from reverb_tpu.ops import beam_scan as jbs
    rng = np.random.RandomState(7)
    lp, ix, _ = _rand_topk(rng, B, T, K2, 30)
    ts = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    valid = np.arange(T)[None, :] < np.asarray(num_t)[:, None]
    acc = np.zeros((B, T), np.float32)
    hs = np.zeros((B, T), bool)
    jfinal, jem = jbs.beam_scan_forward(
        jnp.asarray(lp), jnp.asarray(ix), jnp.asarray(ts),
        jnp.asarray(valid), jnp.asarray(acc), jnp.asarray(hs), K, 0, True)
    final, em = beam_scan.beam_scan_forward(_t(lp), _t(ix), _t(ts), _t(valid),
                                            _t(acc), _t(hs), K, 0)
    for n in tpb.EMIT_KEYS:
        np.testing.assert_array_equal(em[n].numpy(), np.asarray(jem[n]),
                                      err_msg=n)
    np.testing.assert_array_equal(em['wval'].numpy(),
                                  np.asarray(jem['wval'])[:, 0, :])
    np.testing.assert_array_equal(final['plen'].numpy(),
                                  np.asarray(jfinal['plen']))
    for n in ('s', 'ns', 'v_s', 'v_ns'):
        np.testing.assert_allclose(final[n].numpy(), np.asarray(jfinal[n]),
                                   rtol=0, atol=1e-5, err_msg=n)
    total = tpb._log_add(final['s'], final['ns'])
    order = torch.argsort(-total, dim=-1, stable=True).to(torch.int32)
    sel = torch.gather(~(final['v_s'] > final['v_ns']), 1, order.long())
    jpre, jtim = jbs.beam_backtrace(jem, jnp.asarray(order.numpy()),
                                    jnp.asarray(sel.numpy()), L, True)
    pre, tim = beam_scan.beam_backtrace(em, order, sel, L)
    np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jtim))
    assert pre.shape == (B, K, L)


def test_beam_second_prune_tie_order():
    """Forced ties (every extension of a frame equal): the second prune
    keeps the lowest flat indices, as lax.top_k does."""
    B, T, K2, K = 2, 12, 4, 4
    lp = np.full((B, T, K2), -1.5, np.float32)
    ix = np.tile(np.arange(1, K2 + 1, dtype=np.int32), (B, T, 1))
    ix[1, ::2] = np.arange(K2, dtype=np.int32)          # blank in some frames
    num_t = np.array([T, 7], np.int32)
    want = jpb._search_batched(jnp.asarray(lp), jnp.asarray(ix),
                               jnp.asarray(num_t), K, 0, T, interpret=True)
    got = tpb._search_batched(_t(lp), _t(ix), _t(num_t), K, 0, T)
    _assert_beam_equal(got, want)


def test_rolling_hash_wraps_like_uint32():
    rng = np.random.RandomState(5)
    h1 = rng.randint(0, 2 ** 32, size=64, dtype=np.uint64).astype(np.uint32)
    h2 = rng.randint(0, 2 ** 32, size=64, dtype=np.uint64).astype(np.uint32)
    u = rng.randint(0, 10000, size=64).astype(np.int32)
    w1, w2 = jpb._child_hash(jnp.asarray(h1), jnp.asarray(h2),
                             jnp.asarray(u))
    g1, g2 = tpb._child_hash(_t(h1.astype(np.int64)), _t(h2.astype(np.int64)),
                             _t(u))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1).astype(np.int64))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2).astype(np.int64))


def test_beam_wrappers_count_no_cpu_launches():
    """The launch counters count kernel launches only: the CPU path runs the
    plain versions and leaves them alone."""
    before = (beam_scan.FWD_LAUNCHES, beam_scan.BT_LAUNCHES,
              flash_attention.LAUNCHES)
    rng = np.random.RandomState(6)
    lp, ix, _ = _rand_topk(rng, 1, 5, 3, 8)
    tpb._search_batched(_t(lp), _t(ix), torch.tensor([5]), 3, 0, 5)
    assert (beam_scan.FWD_LAUNCHES, beam_scan.BT_LAUNCHES,
            flash_attention.LAUNCHES) == before


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (need a card; skip here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


# a full chunk (T = 512) and a file's last, ragged chunk (T = 333); the
# kv_lens are ragged, with 0 and 1 among them
ATTN_CASES = [(512, [512, 300, 1, 0, 512, 17, 64, 65]),
              (333, [333, 200, 1, 0, 333, 17, 64, 65])]


@pytest.mark.cuda
@pytest.mark.parametrize('T,kv_lens', ATTN_CASES)
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_k1_kernel_matches_plain(cuda, dtype, tol, T, kv_lens):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, dk = 8, 16, 64

    def rnd(*shape):       # unit-scale: |out| ≤ 1, so bf16 rounding ≤ 1 ulp
        return (torch.rand(*shape, device=cuda, generator=g) * 2 - 1).to(
            dtype)
    q, k, v = (rnd(B, T, H, dk).transpose(1, 2) for _ in range(3))
    pos = rnd(1, H, T, dk)
    u, vb = rnd(H, dk).float() * 0.1, rnd(H, dk).float() * 0.1
    lens = torch.tensor(kv_lens, device=cuda)
    out = flash_attention.rel_pos_attention(q, k, v, pos, u, vb, lens)
    ref = flash_attention.rel_pos_attention_plain(q, k, v, pos, u, vb, lens)
    torch.cuda.synchronize()
    for b in range(B):
        L = int(lens[b])
        if L == 0:
            assert torch.count_nonzero(out[b]) == 0
            continue
        err = (out[b, :, :L].float() - ref[b, :, :L].float()).abs().max()
        assert float(err) <= tol


def _cuda_topk(gen, B, T, K2, V=50):
    logits = torch.randn(B, T, V, generator=gen)
    logits[..., 0] += torch.rand(B, T, generator=gen) * 3 + 1.5
    logp = torch.log_softmax(logits, -1)
    vals, idx = torch.sort(logp, dim=-1, descending=True, stable=True)
    return (vals[..., :K2].contiguous(), idx[..., :K2].int().contiguous(),
            logp[..., 0].contiguous())


# (B, T, K, K2, lens, max_tokens, threshold): the serving shapes, dense and
# blank-skip, then one frame, a T that is no multiple of the rings' chunks,
# a T beyond two chunks with a row of no frames and L = T, the
# 128-candidate limit, a small beam, B = 1 and B above 32
K2K3_CASES = [
    (8, 512, 10, 10, [512, 400, 300, 512, 1, 256, 100, 512], 256, 0.0),
    (8, 512, 10, 10, [512, 400, 300, 512, 1, 256, 100, 512], 256, 0.95),
    (2, 1, 10, 10, [1, 1], 256, 0.0),
    (3, 45, 10, 10, [45, 44, 1], 256, 0.0),
    (4, 150, 10, 10, [150, 0, 129, 64], 0, 0.0),
    (4, 150, 10, 10, [150, 0, 129, 64], 0, 0.9),
    (3, 70, 16, 7, [70, 33, 65], 256, 0.0),
    (3, 70, 4, 4, [70, 33, 65], 64, 0.0),
    (1, 40, 10, 10, [40], 256, 0.0),
    (40, 33, 10, 10, [33] * 40, 32, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,T,K,K2,lens,max_tokens,threshold', K2K3_CASES)
def test_k2_k3_kernels_match_plain(cuda, B, T, K, K2, lens, max_tokens,
                                   threshold, monkeypatch):
    """Prefixes, plens and times exactly equal to the plain versions';
    scores within 1e-4 (expf/log1pf of the card against PyTorch's)."""
    gen = torch.Generator().manual_seed(1)
    lp, ix, blank = (x.to(cuda) for x in _cuda_topk(gen, B, T, K2))
    lens = torch.tensor(lens, device=cuda)
    cap = T // 2 if threshold > 0 else 0
    got = tpb.ctc_prefix_beam_search_device_topk(lp, ix, blank, lens, K, 0,
                                                 max_tokens, threshold, cap)
    monkeypatch.setattr(beam_scan, 'beam_scan_forward',
                        beam_scan.beam_scan_forward_plain)
    monkeypatch.setattr(beam_scan, 'beam_backtrace',
                        beam_scan.beam_backtrace_plain)
    want = tpb.ctc_prefix_beam_search_device_topk(lp, ix, blank, lens, K, 0,
                                                  max_tokens, threshold, cap)
    for g, w in zip(got, want):
        if w.dtype.is_floating_point:
            assert float((g - w).abs().max()) <= 1e-4
        else:
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_k2_forced_ties_match_plain(cuda, monkeypatch):
    """Every log-prob equal: the selection is decided by the flat index
    alone (ties to the lowest), exactly as the plain version decides it."""
    B, T, K2, K = 2, 40, 6, 6
    lp = torch.full((B, T, K2), -1.5, device=cuda)
    ix = torch.arange(1, K2 + 1, dtype=torch.int32, device=cuda).repeat(
        B, T, 1)
    ix[1, ::2] = torch.arange(K2, dtype=torch.int32, device=cuda)
    ix = ix.contiguous()
    num_t = torch.tensor([T, 23], device=cuda)
    got = tpb._search_batched(lp, ix, num_t, K, 0, T)
    monkeypatch.setattr(beam_scan, 'beam_scan_forward',
                        beam_scan.beam_scan_forward_plain)
    monkeypatch.setattr(beam_scan, 'beam_backtrace',
                        beam_scan.beam_backtrace_plain)
    want = tpb._search_batched(lp, ix, num_t, K, 0, T)
    for g, w in zip(got, want):
        if w.dtype.is_floating_point:
            assert float((g - w).abs().max()) <= 1e-4
        else:
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize('L,on_chip', [(1400, False), (256, True)])
def test_k3_both_output_routes_match_plain(cuda, L, on_chip):
    """K = 16 with L = 1400 does not fit in shared memory beside the record
    ring, so the outputs are built in device memory; L = 256 is built on
    chip.  Both equal the plain walk exactly, on K2's records."""
    B, T, K, K2 = 2, 150, 16, 7
    assert beam_scan.backtrace_launch_plan(T, K, L)[2] is on_chip
    gen = torch.Generator().manual_seed(2)
    lp, ix, _ = (x.to(cuda) for x in _cuda_topk(gen, B, T, K2))
    ts = torch.arange(T, dtype=torch.int32, device=cuda)[None].expand(
        B, T).contiguous()
    ones = torch.ones((B, T), dtype=torch.bool, device=cuda)
    acc = torch.zeros((B, T), device=cuda)
    final, em = beam_scan.beam_scan_forward(lp, ix, ts, ones, acc, ~ones, K,
                                            0)
    order = torch.argsort(-tpb._log_add(final['s'], final['ns']), dim=-1,
                          stable=True).to(torch.int32)
    sel = torch.gather(~(final['v_s'] > final['v_ns']), 1, order.long())
    got = beam_scan.beam_backtrace(em, order, sel, L)
    want = beam_scan.beam_backtrace_plain(em, order, sel, L)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
