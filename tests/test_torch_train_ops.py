"""Training kernels of the PyTorch port against the JAX package.

K1 with the dropout keep-mask and its backward K4 (rel-pos attention), and
the LayerNorm pair K5/K6, take their plain PyTorch versions on CPU tensors;
here those are held to the JAX functions running the Pallas kernels in
interpret mode, with the same numpy inputs and the same numpy keep-mask.
The CUDA kernels themselves are held to the plain versions by the
`cuda`-marked tests at the end (they skip without a card) and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.ops import flash_attention as jfa
from reverb_tpu.ops import layer_norm as jln
from reverb_tpu_torch.models import modules
from reverb_tpu_torch.models.attention import RelPositionMultiHeadedAttention
from reverb_tpu_torch.ops import flash_attention as fa
from reverb_tpu_torch.ops import layer_norm as ln

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker


@pytest.fixture(autouse=True)
def _single_device_pallas():
    """The JAX references here run on one device.  The Pallas mesh is
    process-global (reverb_tpu/ops/pallas_mesh.py) and some JAX tests leave
    one registered (tests/test_train_bin.py through bin/train.py); in the
    same worker it would send fused_layer_norm through shard_map, which
    raises on its outputs' missing vma."""
    from reverb_tpu.ops import pallas_mesh
    saved = pallas_mesh.get_pallas_mesh()
    pallas_mesh.set_pallas_mesh(None)
    yield
    pallas_mesh._REGISTERED = saved


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _attn_inputs(B, H, T, dk, lens, rate, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, dk).astype(np.float32) for _ in range(3))
    pos = rng.randn(1, H, T, dk).astype(np.float32)
    u, vb = ((rng.randn(H, dk) * 0.1).astype(np.float32) for _ in range(2))
    mask = (rng.rand(B, H, T, T) < 1.0 - rate).astype(np.int8)
    g = rng.randn(B, H, T, dk).astype(np.float32)
    return q, k, v, pos, u, vb, np.asarray(lens, np.int32), mask, g


@pytest.mark.parametrize('T,lens,rate', [(37, (37, 21), 0.1),
                                         (130, (130, 1), 0.25),
                                         (40, (40, 0), 0.0)])
def test_attention_mask_fwd_bwd_matches_pallas_interpret(T, lens, rate):
    """The plain K1-with-mask forward and its autograd backward against
    `_flash_core` in interpret mode, whose VJP runs the Pallas K4 kernel.
    f32 on both sides, so only the summation order differs: output and all
    six gradients within 1e-4.  The cotangent is zero on padded query rows
    (their outputs are not defined the same way on both sides)."""
    B, H, dk = 2, 2, 16
    q, k, v, pos, u, vb, lens, mask, g = _attn_inputs(B, H, T, dk, lens,
                                                      rate, 0)
    g = g * (np.arange(T)[None, None, :, None]
             < np.maximum(lens, 1)[:, None, None, None])
    assert jfa._bwd_kernel_available(True)

    def fold(x):
        return jnp.asarray(x.reshape(B * H, T, dk))

    def core(q_, u_, vb_, k_, p_, v_):
        return jfa._flash_core(q_, u_, vb_, k_, p_, v_,
                               jnp.asarray(np.repeat(lens, H)),
                               jnp.asarray(mask.reshape(B * H, T, T)),
                               H, 128, True, rate)
    want, vjp = jax.vjp(core, fold(q), jnp.asarray(u), jnp.asarray(vb),
                        fold(k), jnp.asarray(pos[0]), fold(v))
    dq, du, dvb, dk_, dp, dv = vjp(fold(g))

    tq, tk, tv, tpos, tu, tvb = (_t(x, True) for x in (q, k, v, pos, u, vb))
    out = fa.rel_pos_attention(tq, tk, tv, tpos, tu, tvb, _t(lens),
                               _t(mask), rate)
    out.backward(_t(g))
    valid = np.arange(T)[None, None, :] < np.maximum(lens, 1)[:, None, None]
    got = out.detach().numpy()
    ref = np.asarray(want).reshape(B, H, T, dk)
    for b in range(B):
        np.testing.assert_allclose(got[b][:, valid[b, 0]],
                                   ref[b][:, valid[b, 0]], rtol=1e-4,
                                   atol=1e-4)
    pairs = [(tq.grad, dq, 'dq'), (tk.grad, dk_, 'dk'), (tv.grad, dv, 'dv'),
             (tpos.grad[0], dp, 'dp'), (tu.grad, du, 'du'),
             (tvb.grad, dvb, 'dvb')]
    for got_g, want_g, name in pairs:
        np.testing.assert_allclose(
            got_g.numpy().reshape(np.shape(want_g)), np.asarray(want_g),
            rtol=1e-4, atol=1e-4, err_msg=name)


def test_attention_without_mask_is_plain_softmax():
    """rate 0 ignores the mask: the mask variant reduces to the serving
    formulation exactly."""
    q, k, v, pos, u, vb, lens, mask, _ = _attn_inputs(2, 2, 24, 8, (24, 9),
                                                      0.5, 1)
    a = fa.rel_pos_attention_plain(*map(_t, (q, k, v, pos, u, vb, lens)))
    b = fa.rel_pos_attention_plain(*map(_t, (q, k, v, pos, u, vb, lens,
                                             mask)), rate=0.0)
    assert torch.equal(a, b)


def test_attention_dropout_mask_draw():
    """The rel-pos module draws a (B, H, T, T) int8 keep-mask from the
    generator with keep fraction ≈ 1 − rate and hands it to the kernel
    wrapper with the rate; the same seed gives the same draw, and no
    generator gives no mask."""
    d, h, B, T, rate = 128, 2, 2, 64, 0.1
    mod = RelPositionMultiHeadedAttention(h, d)
    modules.reset_parameters(mod, torch.Generator().manual_seed(0))
    seen = []
    real = fa.rel_pos_attention

    def spy(*args):
        seen.append(args[7:])
        return real(*args)
    x = torch.randn(B, T, d, generator=torch.Generator().manual_seed(1))
    pos = torch.randn(1, T, d, generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([T, 40], dtype=torch.int32)
    fa.rel_pos_attention = spy
    try:
        outs = [mod(x, lens, pos, rate, torch.Generator().manual_seed(s))
                for s in (5, 5, 6)]
        mod(x, lens, pos, rate, None)
    finally:
        fa.rel_pos_attention = real
    (m5, r5), (m5b, _), (m6, _), (m_none, _) = seen
    assert m5.dtype == torch.int8 and m5.shape == (B, h, T, T) and r5 == rate
    assert torch.equal(m5, m5b) and not torch.equal(m5, m6)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert abs(float(m5.float().mean()) - (1 - rate)) < 0.01
    assert m_none is None


def _ln_case(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 2 + 0.5
    w = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    # round the activations once, so both sides start from the same bits
    x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    g = np.asarray(jnp.asarray(g, jdt).astype(jnp.float32))
    return x, w, b, g, jdt


@pytest.mark.parametrize('shape,eps', [((3, 37, 128), 1e-5),
                                       ((2, 7, 256), 1e-12),
                                       ((257, 1024), 1e-5),
                                       ((1, 1024), 1e-12),
                                       ((640, 1024), 1e-5)])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_layer_norm_fwd_bwd_matches_pallas_interpret(shape, eps, dtype, tol):
    """The plain K5/K6 (forward, and the autograd backward through the
    port's LayerNorm function) against `fused_layer_norm` in interpret mode:
    ragged row counts, eps 1e-12 as in the LSL decoder layers.  f32 within
    1e-5 (summation order); bf16 within 2e-2 relative to each result's scale
    (the bf16 outputs differ by at most an ulp where the rounding points
    differ)."""
    x, w, b, g, jdt = _ln_case(shape, dtype, 0)

    def f(x_, w_, b_):
        return jln.fused_layer_norm(x_, w_, b_, eps)
    want, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(w),
                        jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g, jdt))

    tx = _t(x).to(dtype).requires_grad_(True)
    tw, tb = _t(w, True), _t(b, True)
    assert ln.eligible(tx)
    y = ln.layer_norm(tx, tw, tb, eps)
    assert y.dtype == dtype
    y.backward(_t(g).to(dtype))
    for got, ref, name in ((y, want, 'y'), (tx.grad, dx, 'dx'),
                           (tw.grad, dw, 'dw'), (tb.grad, db, 'db')):
        ref = np.asarray(ref, np.float32)
        scale = max(1.0, float(np.abs(ref).max())) if dtype == \
            torch.bfloat16 else 1.0
        np.testing.assert_allclose(got.detach().float().numpy(), ref,
                                   rtol=tol, atol=tol * scale, err_msg=name)


def test_layer_norm_ineligible_shape_takes_plain_autograd():
    """C % 128 != 0 is the reference's own rule for the unfused path: plain
    formulation, autograd backward, same numerics."""
    x = torch.randn(5, 96, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.rand(96, generator=torch.Generator().manual_seed(1)) + 0.5
    b = torch.zeros(96)
    assert not ln.eligible(x)
    before = (ln.LAUNCHES, ln.BWD_LAUNCHES)
    y = ln.layer_norm(x, w, b, 1e-5)
    assert y.grad_fn is not None and 'LayerNorm' not in type(
        y.grad_fn).__name__
    torch.testing.assert_close(y, ln.layer_norm_plain(x, w, b, 1e-5))
    y.sum().backward()
    assert (ln.LAUNCHES, ln.BWD_LAUNCHES) == before


def test_train_wrappers_count_no_cpu_launches():
    """On CPU tensors the K1/K4/K5/K6 wrappers run the plain versions and
    leave the launch counters alone, forward and backward."""
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, ln.LAUNCHES, ln.BWD_LAUNCHES)
    q, k, v, pos, u, vb, lens, mask, g = _attn_inputs(1, 2, 9, 8, (9,),
                                                      0.2, 2)
    tq = _t(q, True)
    fa.rel_pos_attention(tq, *map(_t, (k, v, pos, u, vb, lens, mask)),
                         0.2).backward(_t(g))
    x = torch.randn(3, 128, requires_grad=True)
    ln.layer_norm(x, torch.ones(128, requires_grad=True),
                  torch.zeros(128, requires_grad=True)).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES, ln.LAUNCHES,
            ln.BWD_LAUNCHES) == before


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


@pytest.mark.cuda
@pytest.mark.parametrize('T,kv_lens', [
    (512, [512, 300, 1, 0, 512, 17, 64, 65]),
    (333, [333, 200, 1, 0, 333, 17, 64, 65])])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-3),
                                       (torch.bfloat16, 6e-2)])
def test_k1_mask_and_k4_kernels_match_plain(cuda, dtype, tol, T, kv_lens):
    """K1 with the keep-mask and K4 against the plain forward and its
    autograd backward at T = 512 and a ragged T = 333, ragged kv_lens with
    0 and 1, rate 0.1.  The bound is
    relative to each tensor's largest value: f32 1e-3 (summation order over
    512 keys; D taken as rowsum(g∘out)), bf16 6e-2 (q+u, probabilities and
    the outputs rounded to bf16)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, dk, rate = 8, 16, 64, 0.1

    def rnd(*shape):
        return (torch.rand(*shape, device=cuda, generator=g) * 2 - 1).to(
            dtype)
    q, k, v = (rnd(B, T, H, dk).transpose(1, 2) for _ in range(3))
    pos = rnd(1, H, T, dk)
    u, vb = rnd(H, dk).float() * 0.1, rnd(H, dk).float() * 0.1
    lens = torch.tensor(kv_lens, device=cuda)
    mask = (torch.rand(B, H, T, T, device=cuda, generator=g)
            < 1 - rate).to(torch.int8)
    gout = rnd(B, H, T, dk)
    row_ok = (torch.arange(T, device=cuda)[None, :]
              < lens.clamp(min=1)[:, None])[:, None, :, None]
    gout = gout * row_ok
    results = []
    for fn in (fa.rel_pos_attention, fa.rel_pos_attention_plain):
        ins = [t.detach().clone().requires_grad_(True)
               for t in (q, k, v, pos, u, vb)]
        out = fn(*ins, lens, mask, rate)
        out.backward(gout)
        results.append([out * row_ok] + [t.grad for t in ins])
    torch.cuda.synchronize()
    for got, want in zip(*results):
        scale = float(want.float().abs().max()) or 1.0
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
    assert torch.count_nonzero(results[0][0][3]) == 0     # kv_len 0 row


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('eps', [1e-5, 1e-12])
@pytest.mark.parametrize('N', [1, 640, 4097])
def test_k5_k6_kernels_match_plain(cuda, dtype, tol, eps, N):
    """K5/K6 against the plain versions on (N, 1024): one row, fewer rows
    than the grid has warps, and a ragged 4097: y and dx within tol of their
    scale, dw/db (f32 sums over the rows) within tol relative to their
    scale."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(N, 1024, device=cuda, generator=gen) * 2 + 0.5).to(
        dtype)
    w = torch.rand(1024, device=cuda, generator=gen) + 0.5
    b = torch.randn(1024, device=cuda, generator=gen)
    gy = torch.randn(N, 1024, device=cuda, generator=gen).to(dtype)
    y = ln.layer_norm_fwd(x, w, b, eps)
    dx, dw, db = ln.layer_norm_bwd(x, w, gy, eps)
    y_p = ln.layer_norm_plain(x, w, b, eps)
    dx_p, dw_p, db_p = ln.layer_norm_bwd_plain(x, w, gy, eps)
    torch.cuda.synchronize()
    for got, want in ((y, y_p), (dx, dx_p), (dw, dw_p), (db, db_p)):
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
