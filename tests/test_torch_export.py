"""The port's export of the serving function set (reverb_tpu_torch/export,
bin/export.py) against the JAX package's (reverb_tpu/export/aot.py), f32
on the CPU.

Each `torch.export` program, saved and loaded back, is held to the port's
eager module and to the JAX package's `serialize_serving_functions` →
`load_serialized` on the same inputs (≤1e-4), with the same
manifest.json; the encoder chunk over three chained chunks with the
caches carried.  The model: 2 layers, d = 64, 4 heads, V = 23.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.export import aot as jaot
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import presets as jpresets
from reverb_tpu_torch import _build
from reverb_tpu_torch import convert
from reverb_tpu_torch.bin import export as texport_bin
from reverb_tpu_torch.export import aot as taot
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.ops import layer_norm as ln

from helpers import build_tiny_model_dir

ATOL = 1e-4


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """(JAX params, JAX cfg, port model, {name: (JAX callable, port
    module, port eager module)}, JAX dir, port dir)."""
    conf = jpresets.reverb_config(output_size=64, attention_heads=4,
                                  linear_units=96, num_blocks=2, dec_blocks=2,
                                  r_blocks=1, vocab_size=23)
    conf['dataset_conf'] = {'pass_cat_emb': True,
                            'cat_emb_conf': {'emb_len': 2}}
    jcfg = jam.ModelConfig.from_config(conf)
    params = jam.init_params(jax.random.PRNGKey(0), jcfg)
    model = tam.build_model(tam.ModelConfig.from_config(conf), 'cpu',
                            convert.state_dict_from_jax(
                                flatten_params(params)))
    jdir = tmp_path_factory.mktemp('jax_export')
    tdir = tmp_path_factory.mktemp('torch_export')
    jpaths = jaot.serialize_serving_functions(params, jcfg, str(jdir))
    tpaths = taot.serialize_serving_functions(model, str(tdir))
    eager, _ = taot.serving_inputs(model)
    fns = {name: (jaot.load_serialized(jpaths[name]),
                  taot.load_serialized(tpaths[name]), eager[name][0])
           for name in taot.NAMES}
    return params, jcfg, model, fns, jdir, tdir


def _inputs(name, seed, model):
    rng = np.random.RandomState(seed)
    ecfg = model.cfg.encoder
    if name == 'ctc_activation':
        return (rng.randn(1, 16, 64).astype(np.float32),)
    hyps = rng.randint(1, model.cfg.vocab_size - 1, (10, 64)).astype(
        np.int32)
    hyps[:, 0] = model.cfg.sos
    lens = rng.randint(1, 65, (10,)).astype(np.int32)
    lens[0] = 64
    for i, n in enumerate(lens):
        hyps[i, n:] = model.cfg.eos
    return hyps, lens, rng.randn(1, 256, ecfg.output_size).astype(np.float32)


def _flat(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o) if not isinstance(o, torch.Tensor) else o.numpy()
            for o in out if o is not None]


def _run_all(fns, args):
    jfn, prog, mod = fns
    want = _flat(jfn(*(jnp.asarray(a) if a is not None else None
                       for a in args)))
    targs = [torch.from_numpy(a) if a is not None else None for a in args]
    with torch.no_grad():
        got = _flat(prog(*targs))
        eager = _flat(mod(*targs))
    return want, got, eager


@pytest.mark.parametrize('name', ['ctc_activation', 'attention_decoder'])
def test_exported_program_matches_eager_and_jax(exported, name):
    _, _, model, fns, _, _ = exported
    want, got, eager = _run_all(fns[name], _inputs(name, 1, model))
    assert len(want) == len(got) == len(eager) == (
        2 if name == 'attention_decoder' else 1)
    for w, g, e in zip(want, got, eager):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, e)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert np.isfinite(got[0]).all() and np.abs(got[-1]).max() > 0


def test_exported_encoder_chunk_chains(exported):
    """Three chained chunks, each side carrying its own caches: the loaded
    program equals the eager module and agrees with JAX's to 1e-4."""
    _, _, model, fns, _, _ = exported
    jfn, prog, mod = fns['encoder_chunk']
    rng = np.random.RandomState(2)
    cfg = model.cfg.encoder
    att = np.zeros((cfg.num_blocks, 1, cfg.attention_heads, 256,
                    2 * cfg.head_dim), np.float32)
    cat = np.array([0.7, 0.3], np.float32)
    carry = {'jax': att, 'prog': att, 'eager': att}
    for i in range(3):
        feats = rng.randn(1, 67, 80).astype(np.float32)
        off = np.asarray(16 * i, np.int32)
        outs = {}
        for side, fn in (('jax', jfn), ('prog', prog), ('eager', mod)):
            if side == 'jax':
                ys, a, c = jfn(jnp.asarray(feats), jnp.asarray(off),
                               jnp.asarray(carry[side]), None,
                               jnp.asarray(cat))
            else:
                with torch.no_grad():
                    ys, a, c = fn(torch.from_numpy(feats),
                                  torch.from_numpy(off),
                                  torch.from_numpy(carry[side]), None,
                                  torch.from_numpy(cat))
            assert c is None
            outs[side] = (np.asarray(ys), np.asarray(a))
            carry[side] = np.asarray(a)
        for k in range(2):
            np.testing.assert_array_equal(outs['prog'][k], outs['eager'][k])
            np.testing.assert_allclose(outs['prog'][k], outs['jax'][k],
                                       rtol=0, atol=ATOL)
        assert outs['prog'][0].shape == (1, 16, 64)


def test_manifest_matches_jax(exported):
    _, _, _, _, jdir, tdir = exported
    assert json.loads((tdir / 'manifest.json').read_text()) == json.loads(
        (jdir / 'manifest.json').read_text())
    assert (tdir / 'manifest.json').read_bytes() == \
        (jdir / 'manifest.json').read_bytes()
    assert sorted(p.name for p in tdir.iterdir()) == [
        'attention_decoder.pt2', 'ctc_activation.pt2', 'encoder_chunk.pt2',
        'manifest.json']


def test_scriptability_check(exported):
    _, _, model, _, _, _ = exported
    assert taot.scriptability_check(model) is True


def test_export_cli(tmp_path, capsys):
    """`python -m reverb_tpu_torch.bin.export` writes the three programs
    and the manifest, printing the JAX CLI's lines; `--format stablehlo`
    names pt2; `--format aot` needs the card."""
    d = build_tiny_model_dir(tmp_path / 'model')
    base = ['--config', str(d / 'config.yaml'), '--checkpoint',
            str(d / 'model.npz'), '--device', 'cpu']
    out = tmp_path / 'out'
    assert texport_bin.main(base + ['--output_dir', str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f'exported {n} -> {out / n}.pt2'
                     for n in sorted(taot.NAMES)]
    assert sorted(p.name for p in out.iterdir()) == [
        'attention_decoder.pt2', 'ctc_activation.pt2', 'encoder_chunk.pt2',
        'manifest.json']
    manifest = json.loads((out / 'manifest.json').read_text())
    assert (manifest['window'], manifest['cache_t']) == (67, 256)
    prog = taot.load_serialized(str(out / 'ctc_activation.pt2'))
    assert prog(torch.zeros(1, 16, 32)).shape[-1] > 1
    with pytest.raises(SystemExit):
        texport_bin.main(base + ['--output_dir', str(out), '--format',
                                 'stablehlo'])
    assert '--format pt2' in capsys.readouterr().err
    with pytest.raises(RuntimeError, match='CUDA'):
        texport_bin.main(base + ['--output_dir', str(tmp_path / 'aot'),
                                 '--format', 'aot'])


def test_kernel_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv(_build.KERNEL_DIR_ENV, raising=False)
    assert _build.kernel_dir() == _build._OUT
    monkeypatch.setenv(_build.KERNEL_DIR_ENV, '')
    assert _build.kernel_dir() == _build._OUT
    monkeypatch.setenv(_build.KERNEL_DIR_ENV, str(tmp_path))
    assert _build.kernel_dir() == tmp_path


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_layer_norm_op_fake(dtype):
    """`reverb::layer_norm` traces on fake CUDA tensors (what torch.export
    sees): its output has the input's shape, dtype and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(3, 5, 256, device='cuda', dtype=dtype)
        w = torch.empty(256, device='cuda')
        b = torch.empty(256, device='cuda')
        y = torch.ops.reverb.layer_norm(x, w, b, 1e-5)
        assert y.shape == x.shape and y.dtype == dtype
        assert y.device.type == 'cuda'
    assert ln.LAYER_NORM_OP is torch.ops.reverb.layer_norm.default


def test_layer_norm_op_in_an_exported_graph():
    """Traced on a CUDA-placed fake input, `layer_norm` is the operator
    (not the plain version): an exported graph keeps K5."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    with FakeTensorMode():
        x = torch.empty(4, 128, device='cuda')
        w = torch.empty(128, device='cuda')
        b = torch.empty(128, device='cuda')
        gm = make_fx(lambda x, w, b: ln.layer_norm(x, w, b))(x, w, b)
    targets = [n.target for n in gm.graph.nodes if n.op == 'call_function']
    assert ln.LAYER_NORM_OP in targets
