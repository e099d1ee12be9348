"""The host side of the port's kernels that needs no card: the LayerNorm
backward's launch plan, the nvcc command lines of the build, and
chip_smoke.py's summing of profiler events into device time."""

import importlib.util
from pathlib import Path

import pytest

from reverb_tpu_torch import _build
from reverb_tpu_torch.ops import layer_norm as ln

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize('C', [128, 1024, 2048, 8192])
@pytest.mark.parametrize('N', [1, 7, 8, 9, 640, 4097, 100000])
@pytest.mark.parametrize('sms', [132, 114])
def test_ln_launch_plan_covers_every_row_once(N, C, sms):
    """blocks · iters · rows_per_block ≥ N, at most one wave of blocks, and
    every block starts with a row: block b's rows are (b·iters + it)·rb +
    r, so the last block's first row is below N.  The partial buffer has
    one row per block, so each row of x lands in exactly one partial."""
    rb = ln.rows_per_block(C)
    blocks, iters = ln.launch_plan(N, C, sms)
    assert rb == max(1, 8 // -(-C // 1024))
    assert 1 <= blocks <= sms and iters >= 1
    assert blocks * iters * rb >= N
    assert (blocks - 1) * iters * rb < N
    rows = [(b * iters + it) * rb + r for b in range(blocks)
            for it in range(iters) for r in range(rb)]
    assert sorted(r for r in rows if r < N) == list(range(N))


def test_ln_plan_is_cached_per_shape_and_device(monkeypatch):
    """The wrapper's plan reads the card's SM count and computes (blocks,
    iters) once per (N, C, device), not on every backward."""
    seen = []

    def sms(device_index):
        seen.append(device_index)
        return 114
    monkeypatch.setattr(ln, '_sms', sms)
    ln._plan.cache_clear()
    try:
        for _ in range(3):
            assert ln._plan(4097, 1024, 1) == ln.launch_plan(4097, 1024, 114)
        assert seen == [1]
    finally:
        ln._plan.cache_clear()


@pytest.mark.parametrize('names', [('a.cu', 'b.cu', 'c.cuh', 'notes.txt'),
                                   ('layer_norm.cu',)])
def test_nvcc_commands_compile_every_source_into_out(tmp_path, names):
    csrc, out = tmp_path / 'csrc', tmp_path / 'out'
    csrc.mkdir()
    for n in names:
        (csrc / n).write_text('')
    compiles, link = _build.commands(csrc, out, nvcc='NVCC', tag='t')
    cus = sorted(n for n in names if n.endswith('.cu'))
    assert [Path(c[-1]).name for c in compiles] == cus
    objs = []
    for argv in compiles:
        assert argv[0] == 'NVCC' and argv[-3] == '-o' and '-c' in argv
        assert 'arch=compute_90a,code=sm_90a' in argv
        obj = Path(argv[-2])
        assert obj.parent == out and obj.suffix == '.o'
        objs.append(str(obj))
    assert link[0] == 'NVCC' and '-shared' in link
    assert link[-len(objs):] == objs
    lib = Path(link[link.index('-o') + 1])
    assert lib.parent == out and lib.name.endswith('.so')
    assert not out.exists()          # the function only lists commands


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_EVENTS = [('void (anonymous namespace)::ln_fwd_warp_kernel<bf16, 4>', 10.0,
            14.5),
           ('Memset (Device)', 15.0, 16.0),
           ('void (anonymous namespace)::ln_bwd_warp_kernel<bf16, 4, true>',
            20.0, 30.0),
           ('void (anonymous namespace)::ln_colsum_kernel', 30.0, 32.0),
           ('void (anonymous namespace)::ln_fwd_warp_kernel<bf16, 4>', 40.0,
            44.5)]


@pytest.mark.parametrize('pattern,reps,want', [(None, 1, 0.022),
                                               (r'ln_fwd', 2, 0.0045),
                                               (r'ln_(bwd|colsum)', 1, 0.012),
                                               (r'nothing', 3, 0.0)])
def test_device_ms_sums_matching_events(pattern, reps, want):
    cs = _chip_smoke()
    assert cs.device_ms_of(_EVENTS, reps, pattern) == pytest.approx(want)


@pytest.mark.parametrize('drop', [(), (4,), (0,)])
def test_device_ms_by_name_survives_lost_events(drop):
    """A named kernel's time is the mean duration of its events times its
    launches per call, so a trace that lost events of some calls reads
    the same per-call time (here 2 calls: ln_fwd 4.5 µs each; with both
    backward kernels 10 + 2 µs a call)."""
    cs = _chip_smoke()
    events = [e for i, e in enumerate(_EVENTS) if i not in drop]
    assert cs.device_ms_by_name(events, 2, r'ln_fwd') == pytest.approx(0.0045)
    assert cs.device_ms_by_name(_EVENTS, 1, r'ln_(bwd|colsum)') == \
        pytest.approx(0.012)
    assert cs.device_ms_by_name(_EVENTS, 2, r'ln_fwd') == pytest.approx(
        cs.device_ms_of(_EVENTS, 2, r'ln_fwd'))


def test_ptxas_table_names_beam_kernels():
    log = '\n'.join([
        "ptxas info : Compiling entry function '_ZN45_GLOBAL__N__d1dde0fa_12_"
        "beam_scan_cu_b45db26f16beam_scan_kernelENS_6ScanInEPiPfiiiiii' for "
        "'sm_90a'",
        'ptxas info : Used 98 registers, used 1 barriers, 11024 bytes smem',
        '0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        "ptxas info : Compiling entry function '_ZN45_GLOBAL__N__d1dde0fa_12_"
        "beam_scan_cu_b45db26f21beam_backtrace_kernelILb1EEEvNS_7RecordsEPKi"
        "PKhPiS6_iiiii' for 'sm_90a'",
        'ptxas info : Used 64 registers'])
    cs = _chip_smoke()
    assert cs.ptxas_table(log) == {'beam_scan_kernel': [98, 0, 0],
                                   'beam_backtrace_kernel<1>': [64, 0, 0]}
    assert sorted(cs.ptxas_smem(log).values()) == [0, 11024]


def test_ptxas_table_names_layer_norm_kernels():
    log = '\n'.join([
        "ptxas info : Compiling entry function '_ZN12_GLOBAL__N_118ln_fwd_"
        "warp_kernelI13__nv_bfloat16Li4EEEvPKT_PKfS6_PS3_iif' for 'sm_90a'",
        'ptxas info : Used 90 registers',
        '0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        "ptxas info : Compiling entry function '_ZN12_GLOBAL__N_118ln_bwd_"
        "warp_kernelIfLi8ELb0EEEvPKT_PKfS3_PS1_PfS7_iiif' for 'sm_90a'",
        'ptxas info : Used 190 registers',
        '8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads',
        "ptxas info : Compiling entry function '_ZN12_GLOBAL__N_116ln_colsum"
        "_kernelEPKfS1_PfS2_ii' for 'sm_90a'",
        'ptxas info : Used 20 registers'])
    assert _chip_smoke().ptxas_table(log) == {
        'ln_fwd_warp_kernel<bf16,4>': [90, 0, 0],
        'ln_bwd_warp_kernel<f32,8,0>': [190, 8, 4],
        'ln_colsum_kernel': [20, 0, 0]}
