"""Context biasing in the PyTorch port against the JAX package, on the CPU.

Serving: the in-beam biased prefix search (kernel K2b's plain version, the
biased `_step`) against reverb_tpu's `ctc_prefix_beam_search_topk_raw(...,
context_graph=)` on the same seeded top-k, dense and with blank-skip, at
beam widths 4 and 10; the context graph's tables and n-best rescoring; a
tiny model's `transcribe_modes(..., context_graph=)` CTM.  Training: the
context adaptor's phrase encoder and bias, the loss and every gradient of
a deep-biasing model, and the data pipeline's `cv_list` batches.  The
`cuda`-marked case holds K2b to its plain version on the card.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverb_tpu.convert.torch_ckpt import flatten_params
from reverb_tpu.data import processor as jproc
from reverb_tpu.decode import context_graph as jcg
from reverb_tpu.decode import prefix_beam as jpb
from reverb_tpu.decode.results import DecodeResult as JResult
from reverb_tpu.models import asr_model as jam
from reverb_tpu.models import context_adaptor as jca
from reverb_tpu.models import presets as jpresets
from reverb_tpu_torch import convert
from reverb_tpu_torch.data import processor as tproc
from reverb_tpu_torch.decode import context_graph as tcg
from reverb_tpu_torch.decode import prefix_beam as tpb
from reverb_tpu_torch.decode.results import DecodeResult as TResult
from reverb_tpu_torch.models import asr_model as tam
from reverb_tpu_torch.ops import beam_scan as bs

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

B, T, V = 3, 64, 40


class _WordTokenizer:
    """Whitespace words w<i> → token i (the graphs' tokenizer here)."""

    def tokenize(self, line):
        words = line.split()
        return words, [int(w[1:]) for w in words]


def _topk(K, seed=0):
    """Seeded (B, T, K) top-k log-probs and ids (ties to the lower id),
    blank log-probs (blank-top on ~2/3 of the frames) and lengths."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, V).astype(np.float32) * 3
    logits[:, :, 0] += 2.5
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    order = np.argsort(-lp, -1, kind='stable')[:, :, :K]
    return (np.take_along_axis(lp, order, -1).astype(np.float32),
            order.astype(np.int32), lp[:, :, 0].astype(np.float32),
            np.array([T, 50, 33], np.int32))


def _phrases(idx):
    """Phrases over tokens of the top-k's first columns: pairs, one
    triple, and single tokens."""
    toks = [int(t) for t in np.unique(idx[:, :, :3]) if t != 0]
    out = [[toks[i % len(toks)], toks[(i * 7 + 3) % len(toks)]]
           for i in range(12)]
    out += [[toks[1], toks[2], toks[3]], [toks[5]], [toks[8], toks[5]]]
    return [' '.join(f'w{t}' for t in p) for p in out]


def _graphs(phrases, score=3.0):
    tok = _WordTokenizer()
    return (jcg.ContextGraph(context_list=phrases, tokenizer=tok,
                             context_score=score),
            tcg.ContextGraph(context_list=phrases, tokenizer=tok,
                             context_score=score))


@pytest.fixture(scope='module')
def graphs():
    return _graphs(_phrases(_topk(10)[1]))


@pytest.mark.parametrize('threshold', [0.0, 0.95])
@pytest.mark.parametrize('K', [4, 10])
def test_biased_beam_equals_jax(graphs, K, threshold):
    """Tokens, plens and times exactly, scores within 1e-5 (the reported
    score is acoustic − node_score[ctx], the order by acoustic + bonus);
    the graph changes the best hypothesis of some utterance."""
    jg, tg = graphs
    lp, idx, blank, lens = _topk(K)
    _, want = jpb.ctc_prefix_beam_search_topk_raw(
        lp, idx, blank, lens, K, 0, threshold, context_graph=jg,
        vocab_size=V)
    args = (torch.from_numpy(lp), torch.from_numpy(idx),
            torch.from_numpy(blank), torch.from_numpy(lens), K, 0, threshold)
    launches = bs.BIASED_LAUNCHES
    res, got = tpb.ctc_prefix_beam_search_topk_raw(
        *args, context_graph=tg, vocab_size=V)
    assert bs.BIASED_LAUNCHES == launches      # the plain version on CPU
    for g, w, name in zip(got, want, ('prefixes', 'plens', 'scores',
                                      'times')):
        w = np.asarray(w)
        if name == 'scores':
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64),
                                          err_msg=name)
    plain = tpb.ctc_prefix_beam_search_topk_raw(*args)[0]
    assert any(a.tokens != b.tokens for a, b in zip(res, plain))


def test_biased_scan_refuses_a_resumed_state(graphs):
    """JAX has no biased streaming: a biased scan takes no carried state."""
    _, tg = graphs
    lp, idx, _, _ = _topk(4)
    tables = tpb._graph_tables(tg, V, 'cpu')[:2]
    ts = torch.zeros((B, T), dtype=torch.int32)
    flags = torch.ones((B, T), dtype=torch.bool)
    state = tpb._init_state(B, 4, 'cpu')
    with pytest.raises(ValueError, match='empty prefix'):
        bs.beam_scan_forward(torch.from_numpy(lp), torch.from_numpy(idx), ts,
                             flags, torch.zeros((B, T)), ~flags, 4, 0,
                             state=state, ctx_tables=tables)


def test_graph_tables_and_nbest_rescoring_equal_jax(graphs):
    """device_tables, score_sequence over seeded sequences and
    rescore_nbest equal reverb_tpu's; the tables are cached per vocabulary
    size and device."""
    jg, tg = graphs
    for a, b in zip(jg.device_tables(V), tg.device_tables(V)):
        np.testing.assert_array_equal(a, b)
    assert tg.num_nodes == jg.num_nodes > 10
    rng = np.random.RandomState(1)
    toks = [int(t) for t in np.unique(_topk(10)[1][:, :, :3])]
    for _ in range(50):
        seq = [int(t) for t in rng.choice(toks, rng.randint(0, 9))]
        assert tg.score_sequence(seq) == jg.score_sequence(seq)
    nbest = [[int(t) for t in rng.choice(toks, rng.randint(1, 6))]
             for _ in range(5)]
    scores = [float(s) for s in -np.sort(rng.rand(5) * 10)]
    times = [list(range(len(h))) for h in nbest]
    kw = dict(tokens=nbest[0], score=scores[0], times=times[0], nbest=nbest,
              nbest_scores=scores, nbest_times=times)
    want = jg.rescore_nbest([JResult(**kw), JResult(tokens=[])])
    got = tg.rescore_nbest([TResult(**kw), TResult(tokens=[])])
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert tpb._graph_tables(tg, V, 'cpu') is tpb._graph_tables(tg, V, 'cpu')


# ------------------------------ serving ------------------------------

@pytest.fixture(scope='module')
def tiny_models(tmp_path_factory):
    """The reshaped tiny model (tests/torch_tiny.py) loaded by both
    packages."""
    from reverb_tpu.cli.reverb import ReverbASR as JaxASR
    from reverb_tpu_torch.cli.reverb import ReverbASR as TorchASR

    from torch_tiny import reshaped_tiny_dir
    d = reshaped_tiny_dir(tmp_path_factory.mktemp('torch_context'))
    cfg, ckpt = str(d / 'config.yaml'), str(d / 'model.npz')
    return d, JaxASR(cfg, ckpt), TorchASR(cfg, ckpt, device='cpu')


def test_transcribe_modes_with_context_graph_byte_identical(tiny_models):
    """ctc_prefix_beam_search and attention_rescoring with a context graph
    built from text by each package's tokenizer: CTM bytes equal, and the
    graph changes the CTM.  (The two encoders differ by f32 rounding, which
    moves the beam's scores by ~3e-3 over 3 s; at context_score 2.0 two
    rescored hypotheses of this wav lie closer than that, so the score
    here is 3.0.)"""
    d, ref, port = tiny_models
    phrases = ['c', 'b a', 'ab c', 'a c b']
    kw = dict(context_list=phrases, context_score=3.0)
    jg = jcg.ContextGraph(tokenizer=ref.tokenizer, **kw)
    tg = tcg.ContextGraph(tokenizer=port.tokenizer, **kw)
    modes = ['ctc_prefix_beam_search', 'attention_rescoring']
    wav = str(d / 'a.wav')
    want = ref.transcribe_modes(wav, modes, format='ctm', context_graph=jg)
    got = port.transcribe_modes(wav, modes, format='ctm', context_graph=tg)
    assert got == want
    assert got != port.transcribe_modes(wav, modes, format='ctm')
    assert all(out for out in got)


# ------------------------------ training ------------------------------

def _adaptor_conf():
    conf = jpresets.reverb_config(output_size=32, attention_heads=2,
                                  linear_units=64, num_blocks=3, dec_blocks=1,
                                  r_blocks=1, vocab_size=23)
    conf['dataset_conf']['deep_bias_conf'] = {'deep_biasing': True}
    return conf


def _adaptor_batch(seed=0):
    rng = np.random.RandomState(seed)
    B, T = 2, 67
    return {'feats': (rng.randn(B, T, 80) * 2).astype(np.float32),
            'feats_lengths': np.array([T, 50], np.int32),
            'target': np.array([[3, 4, 5, 6], [7, 8, -1, -1]], np.int32),
            'target_lengths': np.array([4, 2], np.int32),
            'cat_embs': np.array([[1., 0.], [0., 1.]], np.float32),
            'cv_list': np.array([[3, 4, 0], [5, 6, 7], [9, 0, 0],
                                 [11, 12, 0]], np.int64),
            'cv_list_lengths': np.array([2, 3, 1, 2], np.int32)}


@pytest.fixture(scope='module')
def adaptor():
    """A deep-biasing model's JAX parameters (the adaptor with them) and
    the port's model from the same values."""
    conf = _adaptor_conf()
    jcfg = jam.ModelConfig.from_config(conf)
    params = jam.init_params(jax.random.PRNGKey(0), jcfg,
                             with_context_adaptor=True)
    # a wider spread of the adaptor's attention scores, so every frame's
    # argmax is clear of the runner-up
    att = params['context_adaptor']['attention']
    att['linear_q']['weight'] = att['linear_q']['weight'] * 6
    tcfg = tam.ModelConfig.from_config(conf)
    model = tam.build_model(tcfg, 'cpu', convert.state_dict_from_jax(
        flatten_params(params)), train=True)
    return jcfg, params, model


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def test_context_adaptor_equals_jax(adaptor):
    """encode_cv and the adaptor's bias within 1e-4 of JAX's, on seeded
    stand-ins for three encoder layers' outputs; every frame's attention
    argmax is clear of its runner-up by more than 1e-3 (no near-tie can
    flip the blank rule), and both rules occur."""
    jcfg, params, model = adaptor
    batch = _adaptor_batch()
    ca_cfg = jca.ContextAdaptorConfig(vocab_size=jcfg.vocab_size,
                                      output_size=32)
    pa = params['context_adaptor']
    jemb = jca.encode_cv(pa, jnp.asarray(batch['cv_list']),
                         jnp.asarray(batch['cv_list_lengths']), ca_cfg)
    ca = model.context_adaptor
    with torch.no_grad():
        temb = ca.encode_cv(torch.from_numpy(batch['cv_list']),
                            torch.from_numpy(batch['cv_list_lengths']))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=0,
                               atol=1e-4)
    rng = np.random.RandomState(3)
    layers = [(rng.randn(2, 17, 32) * 16).astype(np.float32)
              for _ in range(3)]
    jlayers = [jnp.asarray(x) for x in layers]
    want = np.asarray(jca.context_adaptor_forward(pa, jlayers, jemb, ca_cfg))
    kv = jnp.broadcast_to(jemb, (2,) + jemb.shape[1:])
    _, _, attn = jca.mha(pa['attention'], jca.combine_layers(jlayers), kv,
                         kv, None, 1, return_weights=True)
    top2 = np.sort(np.asarray(attn[:, 0]), -1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > 1e-3
    blank = np.asarray(jnp.argmax(attn[:, 0], -1) == 0)
    assert blank.any() and not blank.all()
    with torch.no_grad():
        got = ca([torch.from_numpy(x) for x in layers], temb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert (got.numpy()[blank] == 0).all()


def test_loss_and_gradients_with_cv_list_equal_jax(adaptor):
    """compute_loss with a cv_list batch (the adaptor's bias added to the
    encoder output) within 1e-5 relative of JAX's, every gradient (the
    adaptor's included) within 1e-4."""
    jcfg, params, model = adaptor
    batch = _adaptor_batch()

    def loss_fn(p):
        out = jam.compute_loss(p, jcfg,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        return out['loss'], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    jgrads = flatten_params(jgrads)
    for p in model.parameters():
        p.grad = None
    out = tam.compute_loss(model, _tb(batch))
    out['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc'):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   rtol=1e-5, err_msg=k)
    names = dict(model.named_parameters())
    assert {convert.tree_key(n) for n in names} == set(jgrads)
    assert any(n.startswith('context_adaptor.') for n in names)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   jgrads[convert.tree_key(name)], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert float(names['context_adaptor.lstm.1.bwd.w_ih'].grad.abs().max()) \
        > 0
    for p in model.parameters():
        p.grad = None


def test_cv_list_batches_equal_jax():
    """The processor's padding with mined context phrases and distractors
    (the same Python random stream on both sides): cv_list and its lengths
    equal reverb_tpu's."""
    rng = np.random.RandomState(0)
    samples = []
    for i in range(4):
        n = 40 + 10 * i
        samples.append({
            'key': f'u{i}', 'feat': rng.randn(n, 80).astype(np.float32),
            'label': list(rng.randint(2, 20, 5)),
            'wav': rng.randn(1, 160 * n).astype(np.float32),
            'cv_label_list': [list(rng.randint(2, 20, rng.randint(1, 4)))
                              for _ in range(2)],
            'dist_label_list': [list(rng.randint(2, 20, rng.randint(1, 4)))
                                for _ in range(3)],
            'cv_list': ['x']})
    conf = {'distractor_ratio': 0.5, 'max_epoch': 1}
    random.seed(5)
    want = jproc.padding([dict(s) for s in samples],
                         deep_biasing_conf=conf)
    random.seed(5)
    got = tproc.padding([dict(s) for s in samples], deep_biasing_conf=conf)
    for k in ('cv_list', 'cv_list_lengths'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['cv_list'].shape[0] >= 4


# ------------------------------ the card ------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
def test_biased_kernel_equals_plain_version(cuda, graphs):
    """K2b against the plain biased scan on the card: every record, plen,
    last, hash and trie state exactly, scores and bonuses within 1e-4."""
    _, tg = graphs
    lp, idx, _, lens = _topk(10)
    lp, idx = torch.from_numpy(lp).to(cuda), torch.from_numpy(idx).to(cuda)
    valid = (torch.arange(T, device=cuda)[None]
             < torch.from_numpy(lens).to(cuda)[:, None])
    ts = torch.arange(T, dtype=torch.int32, device=cuda)[None].expand(
        B, T).contiguous()
    zeros = torch.zeros((B, T), device=cuda)
    args = (lp, idx, ts, valid, zeros, zeros > 0, 10, 0)
    tables = tpb._graph_tables(tg, V, cuda)[:2]
    n = bs.BIASED_LAUNCHES
    final, em = bs.beam_scan_forward(*args, ctx_tables=tables)
    assert bs.BIASED_LAUNCHES == n + 1
    final_p, em_p = bs.beam_scan_forward_plain(*args, ctx_tables=tables)
    for k in em_p:
        assert torch.equal(em[k], em_p[k]), k
    for k in ('plen', 'last', 'h1', 'h2', 'ctx'):
        assert torch.equal(final[k], final_p[k]), k
    for k in ('s', 'ns', 'v_s', 'v_ns', 'cum'):
        assert float((final[k] - final_p[k]).abs().max()) <= 1e-4, k
