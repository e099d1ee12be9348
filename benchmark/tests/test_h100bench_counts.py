"""The count functions against hand counts at tiny shapes."""

from __future__ import annotations

import pytest

from benchmark import counts


def test_layer_norm_counts():
    ops, byt = counts.k5_layer_norm([[4097, 1024], [1024], [1024]],
                                    ['c10::BFloat16', 'float', 'float'])
    assert byt == 2 * 4097 * 1024 * 2 + 2 * 1024 * 4
    # PERF.md's K5 row: 0.0050 ms by its bytes
    assert byt / 3.35e12 * 1e3 == pytest.approx(0.0050, rel=0.01)
    ops6, byt6 = counts.k6_layer_norm_bwd([[10, 8]], ['float'])
    assert byt6 == 3 * 10 * 8 * 4 + 3 * 8 * 4 and ops6 == 12 * 80


def test_whisper_flops_by_hand():
    c = {'d_model': 4, 'vocab_size': 10, 'num_mel_bins': 2,
         'encoder_layers': 1, 'decoder_layers': 1}
    T, L = 3, 2                  # mel 6 frames → 3 after the stride-2 conv
    enc = 2 * 6 * 2 * 4 * 3 + 2 * T * 4 * 4 * 3 \
        + 24 * T * 16 + 4 * T * T * 4
    dec = 8 * L * 16 + 4 * L * L * 4 + 4 * L * 16 + 4 * T * 16 \
        + 4 * L * T * 4 + 16 * L * 16
    assert counts.whisper_forward_flops(c, 6, L) == enc + dec + 2 * L * 4 * 10
    assert counts.whisper_step_flops(c, 6, [L, L]) == 6 * (enc + dec + 160)


def test_bound_takes_the_larger_side():
    assert counts.bound_seconds([(10.0, 1.0), (1.0, 30.0)], 10.0, 10.0) \
        == pytest.approx(1.0 + 3.0)
