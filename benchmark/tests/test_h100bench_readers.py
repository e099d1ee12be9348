"""The readers on hand-made traces: a kernel that the program's counter
saw launched has to show in the trace, as often as the shapes window
recorded its op; one that it never saw launched gives no reading."""

from __future__ import annotations

import types

import pytest

from benchmark import core, counts
from benchmark.readers import idle_share, roofline

COUNTER = 'reverb_tpu_torch.ops.layer_norm:LAUNCHES'
PARAMS = {'count': 'k5_layer_norm', 'counter': COUNTER, 'kernel': 'ln_fwd',
          'shapes_op': 'reverb::layer_norm'}


def kernel(ts, dur, name):
    return {'ph': 'X', 'cat': 'kernel', 'ts': ts, 'dur': dur, 'name': name,
            'args': {'correlation': ts}}


def op(ts, dims):
    return {'ph': 'X', 'cat': 'cpu_op', 'ts': ts, 'dur': 1.0, 'tid': 1,
            'name': 'reverb::layer_norm',
            'args': {'Input Dims': dims, 'Input type': ['float'] * 3}}


def ctx(kernels, shapes, launches, walls=(1.0,), steps=1):
    c = types.SimpleNamespace()
    c.trace = core.Trace(kernels)
    c.shapes_trace = core.Trace(shapes)
    c.launches = {COUNTER: launches}
    c.peak_flops = 67e12
    c.traced_steps = steps
    c.step_walls = list(walls)
    return c


DIMS = [[6000, 1280], [1280], [1280]]


def test_a_kernel_off_the_path_gives_no_reading():
    assert roofline.read(ctx([], [], 0), **PARAMS) is None


def test_a_launched_kernel_missing_from_the_trace_raises():
    with pytest.raises(core.BenchError, match='no kernel matching'):
        roofline.read(ctx([kernel(0, 50, 'other_kernel')], [op(0, DIMS)], 1),
                      **PARAMS)


def test_launches_and_shapes_have_to_agree():
    with pytest.raises(core.BenchError, match='recorded 2'):
        roofline.read(ctx([kernel(0, 50, 'ln_fwd_kernel')],
                          [op(0, DIMS), op(5, DIMS)], 1), **PARAMS)


def test_the_share_is_the_bound_over_the_device_time():
    got = roofline.read(ctx([kernel(0, 40, 'ln_fwd_kernel'),
                             kernel(100, 60, 'ln_fwd_warp_kernel')],
                            [op(0, DIMS), op(5, DIMS)], 2), **PARAMS)
    one = counts.k5_layer_norm(DIMS, ['float'] * 3)
    bound = 2 * max(one[0] / 67e12, one[1] / core.PEAK_BYTES_S)
    assert got == pytest.approx(100.0 * bound / 100e-6)


def test_idle_share_is_of_an_unprofiled_step():
    # 0.9 s busy over two traced steps, unprofiled steps of 0.5 s
    c = ctx([kernel(0, 4e5, 'a'), kernel(2e5, 5e5, 'b')], [], 0,
            walls=(0.5, 0.5, 0.6), steps=2)
    assert idle_share.read(c) == pytest.approx(100.0 * (1 - 0.35 / 0.5))
