"""The host side of the redesigned prefix-beam kernels K2/K3 that needs no
card: their launch plans as pure functions, the wrappers' packed outputs'
layout, and the LayerNorm backward's result buffers.  The `cuda`-marked test
at the end needs a card and skips without one."""

import importlib.util
from pathlib import Path

import pytest
import torch

from reverb_tpu_torch.ops import beam_scan as bs
from reverb_tpu_torch.ops import layer_norm as ln

torch.set_num_threads(1)   # one intra-op thread a pytest-xdist worker

# T: every length up to 130 (all ragged last chunks of both rings), then
# lengths around the chunk multiples and the longest supported
_TS = list(range(1, 131)) + [255, 256, 257, 511, 512, 513, 1000, 2047, 2048,
                             2051, 4095, 4096]
_KK2 = [(K, K2) for K in range(1, 17) for K2 in range(1, 17)
        if K * (K2 + 1) <= 128]


def test_scan_plan_covers_every_frame_once_within_shared_memory():
    """Over T in _TS and every (K, K2) the kernel takes: the chunks cover
    each frame exactly once in order, a chunk is at most a warp's 32 lanes
    long, and the ring (two stages of 16-column rows) stays far below a
    block's 232,448 bytes (it needs no opt-in: <= 48 KB)."""
    for T in _TS:
        for K, K2 in _KK2:
            chunk, smem = bs.scan_launch_plan(T, K, K2)
            assert 1 <= chunk <= 32
            spans = bs.chunk_spans(T, chunk)
            assert [t for a, b in spans for t in range(a, b)] == list(range(T))
            assert all(0 < b - a <= chunk for a, b in spans)
            stage = chunk * (8 * 16 + 10)
            assert smem % 32 == 0 and 2 * stage <= smem < 2 * stage + 32
            assert smem <= 48 * 1024 <= bs.SMEM_MAX


@pytest.mark.parametrize('K,K2', [(17, 4), (4, 17), (16, 8), (0, 4), (4, 0)])
def test_scan_plan_rejects_shapes_outside_the_kernel_limits(K, K2):
    with pytest.raises(ValueError, match='kernel limits'):
        bs.scan_launch_plan(64, K, K2)


def test_backtrace_plan_covers_every_frame_and_picks_the_documented_route():
    """Over T in _TS, K in 1..16 and L in {32, 256, T}: the record ring's
    chunks cover each frame once, the bytes stay within 232,448, and the
    outputs are built in shared memory exactly when ring + 2·K·L·4 bytes
    fit there (else in device memory, and then the ring alone is asked
    for)."""
    for T in _TS:
        for K in range(1, 17):
            for L in (32, 256, T):
                chunk, smem, on_chip = bs.backtrace_launch_plan(T, K, L)
                assert 1 <= chunk <= 64
                spans = bs.chunk_spans(T, chunk)
                assert [t for a, b in spans for t in range(a, b)] == \
                    list(range(T))
                ring = 2 * (8 * chunk * 16 + chunk) * 4
                out = 2 * K * L * 4
                assert on_chip == (ring + out <= 232448)
                assert smem == ring + (out if on_chip else 0)
                assert smem <= bs.SMEM_MAX == 232448


@pytest.mark.parametrize('T,K,L,on_chip', [
    (512, 10, 256, True),       # the serving call
    (256, 10, 256, True),       # blank-skip: the keep cap
    (512, 10, 512, True),       # the uncapped search of a chunk, L = T
    (2048, 10, 2048, True),     # K = 10 fits up to L = 2080
    (2081, 10, 2081, False),
    (1300, 16, 1300, True),     # K = 16 fits up to L = 1300
    (1301, 16, 1301, False),
    (4096, 16, 4096, False)])
def test_backtrace_route_by_shape(T, K, L, on_chip):
    assert bs.backtrace_launch_plan(T, K, L)[2] is on_chip


def test_plans_are_cached_per_shape():
    bs.scan_launch_plan.cache_clear()
    bs.backtrace_launch_plan.cache_clear()
    for _ in range(3):
        bs.scan_launch_plan(512, 10, 10)
        bs.backtrace_launch_plan(512, 10, 256)
    assert bs.scan_launch_plan.cache_info().misses == 1
    assert bs.scan_launch_plan.cache_info().hits == 2
    assert bs.backtrace_launch_plan.cache_info().misses == 1


def test_layer_norm_bwd_plain_returns_gradients_of_their_own_size():
    """On the CPU the plain version runs; its dw and db own C floats each
    (the kernel wrapper's are the two rows of a (2, C) result, checked on
    the card below)."""
    x = torch.randn(6, 128)
    _, dw, db = ln.layer_norm_bwd(x, torch.ones(128), torch.randn(6, 128),
                                  1e-5)
    assert dw.shape == db.shape == (128,)
    assert dw.untyped_storage().nbytes() <= 2 * 128 * 4
    assert db.untyped_storage().nbytes() <= 2 * 128 * 4


def _beam_variants():
    spec = importlib.util.spec_from_file_location(
        'beam_variants', Path(__file__).resolve().parents[1]
        / 'beam_variants.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_beam_variants_apply_to_the_kernel_source():
    """beam_variants.py cuts stages out of csrc/beam_scan.cu by the text
    around them: every variant, and the cycle counters, must still find
    their places in the source as it is."""
    bv = _beam_variants()
    src = bv.SOURCE.read_text()
    for name, transform in bv.VARIANTS.items():
        out = transform(src)
        assert out != src and 'beam_scan_kernel' in out, name
    counted = bv.with_cycle_counters(src)
    assert counted.count('PROF(') == len(bv.STAGES) + 1   # uses + the macro
    assert 'variants_read_cycles' in counted


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('N,C', [(4097, 1024), (640, 128), (9, 2048)])
def test_layer_norm_bwd_gradients_share_no_storage_with_the_partials(cuda, N,
                                                                     C):
    """K6's dw and db are the two rows of a (2, C) f32 result: their storage
    is 2·C floats, whatever the backward's (blocks, C) partials took, and
    the values equal the plain version's (f32: 1e-4 of the largest value,
    the sums run in another order)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(N, C, device=cuda, generator=gen)
    w = torch.rand(C, device=cuda, generator=gen) + 0.5
    g = torch.randn(N, C, device=cuda, generator=gen)
    dx, dw, db = ln.layer_norm_bwd(x, w, g, 1e-5)
    want = ln.layer_norm_bwd_plain(x, w, g, 1e-5)
    torch.cuda.synchronize()
    assert dw.untyped_storage().nbytes() == 2 * C * 4
    assert dw.untyped_storage().data_ptr() == db.untyped_storage().data_ptr()
    assert dx.untyped_storage().data_ptr() != dw.untyped_storage().data_ptr()
    for got, ref in zip((dx, dw, db), want):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-4 * scale
