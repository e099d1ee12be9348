"""The int8 serving path of the PyTorch port against the JAX package's
(reverb_tpu/ops/quant.py), f32 and bf16 on the CPU.

The same float weights go through both packages' `quantize_params_int8`
(bitwise the same int8 weights and scales); the int8 products
(`int8_matmul`, `int8_matmul_static`, `int8_conv2d`) give the same int32
accumulators exactly and outputs within 1e-6 relative (f32) or one bf16
ulp; the int8 encoder and CTC agree to 1e-4 in f32 where every site's
int8 codes agree (dynamic rounding turns the packages' 1e-6 f32
differences into one-code steps at a rounding boundary, which the tests
check for first); calibration yields the same scale table by JAX path;
`recognize_wav --quantize int8` writes the JAX CLI's CTM and TXT.  The
model: 2 layers, d = 64, 4 heads, V = 23.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import ctc as jctc
from reverb_tpu.models import presets as jpresets
from reverb_tpu.ops import quant as jq
from reverb_tpu_torch import convert
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.models import ctc as tctc
from reverb_tpu_torch.ops import quant as tq

from torch_tiny import reshaped_tiny_dir

CAT = np.array([1.0, 0.0], np.float32)
MODES = ['ctc_prefix_beam_search', 'attention_rescoring']


def _config():
    conf = jpresets.reverb_config(output_size=64, attention_heads=4,
                                  linear_units=96, num_blocks=2, dec_blocks=2,
                                  r_blocks=1, vocab_size=23)
    conf['dataset_conf'] = {'pass_cat_emb': True,
                            'cat_emb_conf': {'emb_len': 2}}
    return conf


@pytest.fixture(scope='module')
def params():
    """(JAX float params, JAX cfg, port cfg)."""
    conf = _config()
    jcfg = jam.ModelConfig.from_config(conf)
    rng = np.random.RandomState(0)
    stats = ((rng.randn(80) * 0.5).astype(np.float32),
             (rng.rand(80) + 0.5).astype(np.float32))
    p = jam.init_params(jax.random.PRNGKey(0), jcfg, cmvn=stats)
    return p, jcfg, tam.ModelConfig.from_config(conf)


def _port_model(tcfg, tree):
    return tam.build_model(tcfg, 'cpu', convert.state_dict_from_jax(
        flatten_params(tree)))


def _feats(seed, B=2, T=160):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, 80).astype(np.float32)
    lens = np.array([T, T - 37][:B], np.int32)
    return feats, lens


def test_quantize_params_matches_jax(params):
    p, _, _ = params
    want = flatten_params(jq.quantize_params_int8(p))
    sd = convert.state_dict_from_jax(flatten_params(p))
    got = convert.flat_from_state_dict(tq.quantize_params_int8(sd))
    assert set(got) == set(want)
    quantized = {k[:-len('.weight_q8')] for k in want
                 if k.endswith('.weight_q8')}
    # the JAX package's sites, the subsampling convs among them; the CTC
    # head, norms, embeddings and the conv module stay float
    for site in ('encoder.embed.conv.0', 'encoder.embed.conv.2',
                 'encoder.encoders.0.self_attn.linear_pos',
                 'encoder.encoders.0.feed_forward_macaron.w_1',
                 'encoder.encoders.0.language_layers.1',
                 'decoder.left_decoder.output_layer',
                 'decoder.right_decoder.decoders.0.src_attn.linear_v'):
        assert site in quantized
    assert not any(s.startswith(('ctc.', 'encoder.embed.out'))
                   or 'norm' in s or 'conv1' in s for s in quantized)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


def _jax_quantize_rows(x):
    """reverb_tpu/ops/quant.py:int8_matmul's activation quantization."""
    s = jnp.max(jnp.abs(x), axis=-1, keepdims=True).astype(jnp.float32) / 127.
    s = jnp.maximum(s, 1e-8)
    return jnp.clip(jnp.round(x.astype(jnp.float32) / s), -127,
                    127).astype(jnp.int8)


def _jax_dot(xq, w_q8):
    return jax.lax.dot_general(xq, w_q8, (((xq.ndim - 1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)


def _assert_close(got, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    else:   # one bf16 ulp of the JAX value
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


def _to_jax(x, dtype):
    return jnp.asarray(x.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('op', ['matmul', 'matmul_static', 'conv2d'])
def test_int8_ops_match_jax(op, dtype):
    rng = np.random.RandomState(1)
    if op == 'conv2d':
        x = torch.from_numpy(rng.randn(2, 3, 21, 17).astype(np.float32))
        w = rng.randn(12, 3, 3, 3).astype(np.float32)
    else:
        x = torch.from_numpy(rng.randn(2, 13, 40).astype(np.float32) * 3)
        w = rng.randn(23, 40).astype(np.float32)
    x = x.to(dtype)
    xj = _to_jax(x, dtype)
    w_q8, w_scale = tq.quantize_weight(torch.from_numpy(w))
    wj = jq.quantize_params_int8({'m': {'weight': jnp.asarray(w)}},
                                 skip=())['m'] if op != 'conv2d' else \
        jq.quantize_conv2d_int8({'weight': jnp.asarray(w)})
    np.testing.assert_array_equal(w_q8.numpy(), np.asarray(wj['weight_q8']))
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(wj['w_scale']))
    if op == 'matmul':
        xq, _ = tq.quantize_rows(x)
        xqj = _jax_quantize_rows(xj)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(xqj))
        np.testing.assert_array_equal(
            tq.matmul_acc(xq, w_q8).numpy(),
            np.asarray(_jax_dot(xqj, wj['weight_q8'])))
        _assert_close(tq.int8_matmul(x, w_q8, w_scale),
                      jq.int8_matmul(xj, wj['weight_q8'], wj['w_scale']),
                      dtype)
    elif op == 'matmul_static':
        a = float(np.abs(x.float().numpy()).max() * 0.8)   # some clip
        a_t, a_j = torch.tensor(a), jnp.asarray(a, jnp.float32)
        xq = tq.quantize_static(x, a_t)
        xqj = jnp.clip(jnp.round(xj.astype(jnp.float32) * (127.0 / a_j)),
                       -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(xqj))
        np.testing.assert_array_equal(
            tq.matmul_acc(xq, w_q8).numpy(),
            np.asarray(_jax_dot(xqj, wj['weight_q8'])))
        _assert_close(
            tq.int8_matmul_static(x, w_q8, w_scale, a_t),
            jq.int8_matmul_static(xj, wj['weight_q8'], wj['w_scale'], a_j),
            dtype)
    else:
        s = jnp.maximum(jnp.max(jnp.abs(xj), axis=(1, 2, 3), keepdims=True)
                        .astype(jnp.float32), 1e-8) / 127.0
        xqj = jnp.clip(jnp.round(xj.astype(jnp.float32) / s), -127,
                       127).astype(jnp.int8)
        accj = jax.lax.conv_general_dilated(
            xqj, wj['weight_q8'], (2, 2), [(0, 0), (0, 0)],
            dimension_numbers=('NCHW', 'OIHW', 'NCHW'),
            preferred_element_type=jnp.int32)
        xq = torch.from_numpy(np.array(xqj))
        np.testing.assert_array_equal(
            tq.conv_acc(xq, w_q8, (2, 2)).numpy(), np.asarray(accj))
        _assert_close(tq.int8_conv2d(x, w_q8, w_scale, (2, 2)),
                      jq.int8_conv2d(xj, wj['weight_q8'], wj['w_scale'],
                                     (2, 2), (0, 0)), dtype)


@pytest.mark.parametrize('M,K,N', [(1, 9, 5), (16, 64, 24), (17, 8, 8),
                                   (40, 100, 23)])
def test_int_mm_pads_to_its_shape_rules(M, K, N):
    """Zero padding to M > 16 and K, N multiples of 8 leaves every int32
    sum as the int64 product's."""
    g = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    got = tq.int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.long(), a.long() @ b.long().t())


def _jax_forward(qp, jcfg, feats, lens):
    enc, mask = jam.forward_encoder(qp, jcfg, jnp.asarray(feats),
                                    jnp.asarray(lens), jnp.asarray(CAT))
    return enc, mask, jctc.ctc_logprobs(qp['ctc'], enc, 0.0, jcfg.blank_id)


def _port_forward(model, feats, lens):
    with torch.no_grad():
        enc, mask = model.forward_encoder(torch.from_numpy(feats),
                                          torch.from_numpy(lens),
                                          torch.from_numpy(CAT))
        return enc, mask, tctc.ctc_logprobs(model.ctc, enc, 0.0,
                                            model.cfg.blank_id)


def _site_inputs(monkeypatch, mod, fn):
    """Run fn() with every int8 product of `mod` (a package's quant
    module) recording its float input: {sha1 of the site's w_q8: [x as
    f32 numpy, per call]}."""
    rec = {}

    def wrap(name):
        orig = getattr(mod, name)

        def call(x, w_q8, *args, **kwargs):
            key = hashlib.sha1(np.asarray(w_q8).tobytes()).hexdigest()
            rec.setdefault(key, []).append(np.asarray(
                jnp.asarray(x, jnp.float32) if isinstance(x, jax.Array)
                else x.to(torch.float32)))
            return orig(x, w_q8, *args, **kwargs)
        monkeypatch.setattr(mod, name, call)
    for name in ('int8_matmul', 'int8_matmul_static', 'int8_conv2d'):
        wrap(name)
    try:
        out = fn()
    finally:
        monkeypatch.undo()
    return out, rec


def _code_rows(xs, a_scale=None):
    """The set of int8 code rows of a site's recorded inputs: one per
    token (per sample for the 4-D conv input), the unit a dynamic scale
    covers; with `a_scale`, the static codes.  The packages may batch a
    site's rows differently (JAX broadcasts the decoder's memory to every
    hypothesis, the port projects it once), so rows are compared as a
    set."""
    rows = set()
    for x in xs:
        x = torch.from_numpy(np.array(x))
        if a_scale is not None:
            a = torch.tensor(a_scale, dtype=torch.float32)
            q = (tq.quantize_static(x, a) if x.dim() < 4 else torch.clamp(
                torch.round(x / (a / 127.0)), -127, 127).to(torch.int8))
            q = q.reshape(-1, x.shape[-1]) if x.dim() < 4 else \
                q.reshape(x.shape[0], -1)
        elif x.dim() == 4:
            s = torch.clamp(x.abs().amax((1, 2, 3), keepdim=True),
                            min=1e-8) / 127
            q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            q = q.reshape(x.shape[0], -1)
        else:
            q = tq.quantize_rows(x)[0].reshape(-1, x.shape[-1])
        rows.update(r.tobytes() for r in q.numpy())
    return rows


def _flipped_sites(want, got):
    """The sites whose int8 code rows differ between two recordings (of
    at least the encoder's 24 sites)."""
    assert set(got) == set(want) and len(want) >= 24
    return [k for k in want if _code_rows(got[k]) != _code_rows(want[k])]


def test_int8_encoder_and_ctc_match_jax(params, monkeypatch):
    """The JAX-quantized tree loads strictly into the port's int8 model;
    on an input where every int8 site quantizes its input to the same
    codes in both packages (checked first), the encoder output and CTC
    log-probs agree to 1e-4 in f32.

    Where the two packages' f32 inputs to a site (1e-6 apart: summation
    order) straddle a rounding boundary, one code differs by 1 and the
    outputs move apart by a quantization step; the input of
    `test_int8_rounding_boundary_flip` shows such a case."""
    p, jcfg, tcfg = params
    qp = jq.quantize_params_int8(p)
    model = _port_model(tcfg, qp)
    assert isinstance(model.encoder.embed.conv['0'].weight_q8, torch.Tensor)
    assert model.ctc.ctc_lo.weight_q8 is None
    feats, lens = _feats(2)
    want, rec_j = _site_inputs(monkeypatch, jq,
                               lambda: _jax_forward(qp, jcfg, feats, lens))
    got, rec_t = _site_inputs(monkeypatch, tq,
                              lambda: _port_forward(model, feats, lens))
    assert _flipped_sites(rec_j, rec_t) == []
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)
    # the int8 path differs from the float one: the check is not vacuous
    float_enc = _port_forward(_port_model(tcfg, p), feats, lens)[0]
    assert float((float_enc - got[0]).abs().max()) > 1e-3


def test_int8_rounding_boundary_flip(params, monkeypatch):
    """An input on which the packages' int8 codes differ: at a site whose
    f32 inputs agree to 1e-5 of their row's scale, codes differ by exactly
    1, where the JAX input's x/s lies within 1e-3 of a half-integer (a
    rounding boundary)."""
    p, jcfg, tcfg = params
    qp = jq.quantize_params_int8(p)
    model = _port_model(tcfg, qp)
    feats, lens = _feats(5)
    _, rec_j = _site_inputs(monkeypatch, jq,
                            lambda: _jax_forward(qp, jcfg, feats, lens))
    _, rec_t = _site_inputs(monkeypatch, tq,
                            lambda: _port_forward(model, feats, lens))
    clean = []
    for k in _flipped_sites(rec_j, rec_t):
        for a, b in zip(rec_t[k], rec_j[k]):
            a, b = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))
            if a.dim() == 4 or a.shape != b.shape:
                continue
            scale = b.abs().amax(-1, keepdim=True)
            if not bool(((a - b).abs() <= 1e-5 * scale).all()):
                continue
            diff = (tq.quantize_rows(a)[0].int()
                    - tq.quantize_rows(b)[0].int()).abs()
            if diff.max() != 1:
                continue
            v = (b / torch.clamp(scale / 127, min=1e-8))[diff > 0]
            clean.append(float((v.abs() - v.abs().floor() - 0.5).abs()
                               .max()))
    assert clean and min(clean) < 1e-3


def _jax_run(qp, jcfg):
    def run(p, feats, lens, hyps, hyps_lens):
        enc, _ = jam.forward_encoder(p, jcfg, feats, lens, jnp.asarray(CAT))
        jam.forward_attention_decoder(p, jcfg, hyps, hyps_lens, enc[:1],
                                      jcfg.reverse_weight)
    return run


def _port_run(model, feats, lens, hyps, hyps_lens):
    enc, _ = model.forward_encoder(feats, lens, torch.from_numpy(CAT))
    tam.forward_attention_decoder(model, hyps, hyps_lens, enc[:1],
                                  model.cfg.reverse_weight)


def _calib_batches(vocab, sos, seeds):
    out = []
    for seed in seeds:
        feats, lens = _feats(seed)
        rng = np.random.RandomState(seed)
        hyps = rng.randint(1, vocab - 1, (4, 7)).astype(np.int32)
        hyps[:, 0] = sos
        hyps_lens = np.array([7, 5, 3, 1], np.int32)
        out.append((feats, lens, hyps, hyps_lens))
    return out


CALIB_SEEDS = (4, 6)


def _site_paths(qp):
    """{sha1 of a site's w_q8: its JAX path} of a quantized tree."""
    return {hashlib.sha1(np.asarray(v).tobytes()).hexdigest():
            k[:-len('.weight_q8')]
            for k, v in flatten_params(qp).items()
            if k.endswith('.weight_q8')}


def test_calibration_matches_jax(params, monkeypatch):
    """Calibration on the same two batches (encoder and rescoring
    decoder).  The port's table is exactly each site's largest recorded
    input absmax; JAX's (its calibration step runs jitted, whose f32
    arithmetic differs from eager JAX's and the port's by 1e-6, which a
    value on an int8 rounding boundary turns into a quantization step
    downstream) has the same JAX paths and values within 1 %.  With JAX's
    table in both packages, on an input whose static int8 code rows agree
    at every site (checked first) the static-scale encoders agree to
    1e-4, and the calibrated tree carries its `a_scale` leaves both
    ways."""
    p, jcfg, tcfg = params
    qp = jq.quantize_params_int8(p)
    paths = _site_paths(qp)
    batches = _calib_batches(jcfg.vocab_size, jcfg.sos, CALIB_SEEDS)
    model = _port_model(tcfg, qp)
    want = jq.calibrate_activation_scales(
        qp, _jax_run(qp, jcfg),
        [tuple(jnp.asarray(a) for a in b) for b in batches])
    tbatches = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    got, rec_t = _site_inputs(monkeypatch, tq, lambda: (
        tq.calibrate_activation_scales(model, _port_run, tbatches)))
    assert set(got) == set(want) == set(paths.values()) and len(got) > 30
    for key, xs in rec_t.items():
        assert got[paths[key]] == max(float(np.abs(x).max()) for x in xs)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)
    assert all(m.calib is None for m in tq.int8_sites(model).values())
    sqp = jq.apply_activation_scales(qp, want)
    tq.apply_activation_scales(model, want)
    flat_j = flatten_params(sqp)
    flat_t = convert.flat_from_state_dict(model.state_dict())
    assert set(flat_t) == set(flat_j)
    for k in (k for k in flat_j if k.endswith('.a_scale')):
        np.testing.assert_array_equal(flat_t[k], np.asarray(flat_j[k]))
    # the calibrated tree loads strictly into a fresh port model
    reloaded = _port_model(tcfg, sqp)
    feats, lens = _feats(CALIB_SEEDS[0])
    wj, rec_j = _site_inputs(monkeypatch, jq, lambda: _jax_forward(
        sqp, jcfg, feats, lens))
    for m in (model, reloaded):
        g, rec_t = _site_inputs(monkeypatch, tq, lambda: _port_forward(
            m, feats, lens))
        assert set(rec_t) == set(rec_j)
        for key in rec_j:
            assert _code_rows(rec_t[key], want[paths[key]]) == \
                _code_rows(rec_j[key], want[paths[key]]), paths[key]
        for a, b in ((g[0], wj[0]), (g[2], wj[2])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)
    # static scales are in use: the output moved from the dynamic one's
    dyn = _port_forward(_port_model(tcfg, qp), feats, lens)[0]
    assert float((dyn - g[0]).abs().max()) > 1e-4


def test_calibration_needs_the_model_it_is_given(params):
    _, _, tcfg = params
    model = tam.quantize_model_int8(tam.build_model(
        tcfg, 'cpu', generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match='no int8 sites'):
        tq.calibrate_activation_scales(model, lambda m, x: None, [(1,)])


@pytest.fixture(scope='module')
def tiny64(tmp_path_factory):
    return reshaped_tiny_dir(tmp_path_factory.mktemp('torch_quant'),
                             output_size=64, attention_heads=4)


def test_recognize_wav_int8_matches_jax(tiny64, tmp_path):
    """The port's `recognize_wav --quantize int8` writes the CTM bytes of
    the JAX package's int8 ReverbASR (what its `reverb --quantize int8`
    writes), and the two ReverbASRs give the same TXT; in bf16 the port
    decodes too."""
    from reverb_tpu.cli.reverb import ReverbASR as JaxASR
    from reverb_tpu_torch.cli import recognize_wav as torch_cli
    from reverb_tpu_torch.cli.reverb import ReverbASR as TorchASR
    cfg, ckpt = str(tiny64 / 'config.yaml'), str(tiny64 / 'model.npz')
    wav = str(tiny64 / 'a.wav')
    ref = JaxASR(cfg, ckpt, quantize='int8')
    torch_cli.main(['--audio_file', wav, '--model', str(tiny64), '--modes',
                    *MODES, '--quantize', 'int8', '--result_dir',
                    str(tmp_path), '--device', 'cpu'])
    for mode, want in zip(MODES, ref.transcribe_modes(wav, MODES,
                                                      format='ctm')):
        got = (tmp_path / mode / 'a.ctm').read_text()
        assert got == want and want
    want = ref.transcribe_modes(wav, MODES, format='txt')
    port = TorchASR(cfg, ckpt, quantize='int8', device='cpu')
    assert port.model.decoder.left_decoder.output_layer.weight is None
    assert port.transcribe_modes(wav, MODES, format='txt') == want
    assert all(out.split() for out in want)
    bf16 = TorchASR(cfg, ckpt, quantize='int8', compute_dtype='bfloat16',
                    device='cpu')
    assert all(bf16.transcribe_modes(wav, MODES, format='txt'))
