"""Waveform distortion augmentation suite (host numpy).

The port's copy of reverb_tpu/data/wav_distortion.py: given the same
`random.Random` stream it gives the same output.  Behavioral parity with the reference's amplitude-domain distortion tool
(asr/wenet/dataset/wav_distortion.py:23-321): the same six distortion
families (max / poly / quad / fence / jag / gain-dB), the same randomized
amplitude-mask construction, and the same per-sample Bernoulli application
— including its quirks, which are kept deliberately:

* poly distortion leaves |x| < 1e-6 untouched and caps the output
  amplitude at 0.9997;
* fence distortion maps in-mask NEGATIVE samples to +max_amp (the sign is
  not restored);
* ``gain_db`` clamps with ``min(0.997, ·)`` only from above, so negative
  samples are never clamped;
* ``distort_wav_conf`` applies ``gain_db`` at the *default* rate 0.8,
  ignoring its ``rate`` argument (all other families honor it).

The implementation is vectorized: each ``make_*`` factory returns an
array→array function and ``distort`` applies it to the Bernoulli-selected
samples in one shot (the reference loops per sample in Python). RNG draws
use the stdlib ``random`` module in the reference's exact order — mask
construction first, then one uniform per sample — so a seeded run is
bit-compatible with the reference.
"""

from __future__ import annotations

import logging
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Mask = List[Tuple[float, float]]


def db2amp(db: float) -> float:
    return 10.0 ** (db / 20.0)


def amp2db(amp):
    return 20.0 * np.log10(amp)


def make_poly_distortion(conf: Dict) -> Callable[[np.ndarray], np.ndarray]:
    """dB-domain polynomial waveshaper f(t) = a·t^m·(1-t)^n + t.

    t is the amplitude mapped to [0, 1] via t = dB/100 + 1 (so -100 dB → 0,
    0 dB → 1), f is clamped to ≤1, mapped back to amplitude, capped at
    0.9997, and given x's sign. Samples with |x| < 1e-6 pass through.
    """
    a, m, n = conf['a'], conf['m'], conf['n']

    def poly_distortion(x: np.ndarray) -> np.ndarray:
        abs_x = np.abs(x)
        tiny = abs_x < 1e-6
        t = amp2db(np.where(tiny, 1.0, abs_x)) / 100.0 + 1.0
        t = np.maximum(t, 0.0)
        f = np.minimum(a * t ** m * (1.0 - t) ** n + t, 1.0)
        amp = np.minimum(10.0 ** ((f - 1.0) * 100.0 / 20.0), 0.9997)
        return np.where(tiny, x, np.where(x > 0, amp, -amp))

    return poly_distortion


def make_quad_distortion() -> Callable[[np.ndarray], np.ndarray]:
    return make_poly_distortion({'a': 1, 'm': 1, 'n': 1})


def make_max_distortion(conf: Dict) -> Callable[[np.ndarray], np.ndarray]:
    """Every nonzero sample snaps to ±max_amp (max_db unset → 0.997)."""
    max_db = conf['max_db']
    max_amp = db2amp(max_db) if max_db else 0.997

    def max_distortion(x: np.ndarray) -> np.ndarray:
        return np.where(x > 0, max_amp, np.where(x < 0, -max_amp, 0.0))

    return max_distortion


def make_amp_mask(db_mask: Optional[Sequence[Tuple[float, float]]] = None
                  ) -> Mask:
    """dB-domain slots → amplitude-domain slots."""
    if db_mask is None:
        db_mask = [(-110, -95), (-90, -80), (-65, -60), (-50, -30), (-15, 0)]
    return [(db2amp(lo), db2amp(hi)) for lo, hi in db_mask]


default_mask = make_amp_mask()


def generate_amp_mask(mask_num: int, rng=random) -> Mask:
    """Random amplitude mask of `mask_num` slots spanning [-100 dB, 0 dB]:
    2·mask_num cumulative uniform(0.5, 1) increments (first pinned to 0),
    normalized so the last edge lands at 0 dB; alternating spans become the
    slots. Consumes 2·mask_num - 1 draws from `rng`."""
    a = [0.0] * (2 * mask_num)
    for i in range(1, 2 * mask_num):
        a[i] = a[i - 1] + rng.uniform(0.5, 1)
    max_val = a[-1]
    db = [((a[2 * i] - max_val) / max_val * 100,
           (a[2 * i + 1] - max_val) / max_val * 100) for i in range(mask_num)]
    return make_amp_mask(db)


def _in_mask(v: np.ndarray, mask: Mask) -> np.ndarray:
    hit = np.zeros(v.shape, dtype=bool)
    for lo, hi in mask:
        hit |= (v >= lo) & (v <= hi)
    return hit


def _signed_masks(mask_number: int, rng=random) -> Tuple[Mask, Mask]:
    """fence/jag share this: mask_number ≤ 0 uses the fixed default masks,
    else two independently drawn masks (positive first, then negative)."""
    if mask_number <= 0:
        return default_mask, make_amp_mask([(-50, 0)])
    return generate_amp_mask(mask_number, rng), \
        generate_amp_mask(mask_number, rng)


def make_fence_distortion(conf: Dict, rng=random
                          ) -> Callable[[np.ndarray], np.ndarray]:
    """In-mask samples snap to max_amp (for BOTH signs — negative samples
    come out positive), out-of-mask samples zero, exact zeros pass."""
    positive_mask, negative_mask = _signed_masks(conf['mask_number'], rng)
    max_amp = db2amp(conf['max_db'])

    def fence_distortion(x: np.ndarray) -> np.ndarray:
        pos_in = _in_mask(x, positive_mask)
        neg_in = _in_mask(np.abs(x), negative_mask)
        out = np.where((x > 0) & pos_in, max_amp,
                       np.where((x < 0) & neg_in, max_amp, 0.0))
        return np.where(x == 0, x, out)

    return fence_distortion


def make_jag_distortion(conf: Dict, rng=random
                        ) -> Callable[[np.ndarray], np.ndarray]:
    """In-mask samples pass unchanged, out-of-mask samples zero."""
    positive_mask, negative_mask = _signed_masks(conf['mask_number'], rng)

    def jag_distortion(x: np.ndarray) -> np.ndarray:
        keep = np.where(x > 0, _in_mask(x, positive_mask),
                        _in_mask(np.abs(x), negative_mask))
        return np.where(x == 0, x, np.where(keep, x, 0.0))

    return jag_distortion


def make_gain_db(conf: Dict) -> Callable[[np.ndarray], np.ndarray]:
    """Linear gain of `db` decibels, ceiling-clamped at 0.997."""
    g = db2amp(conf['db'])

    def gain_db(x: np.ndarray) -> np.ndarray:
        return np.minimum(0.997, x * g)

    return gain_db


def _bernoulli(n: int, rate: float, rng=random) -> np.ndarray:
    """One uniform(0, 1) draw per sample, in sample order."""
    return np.fromiter((rng.uniform(0, 1) < rate for _ in range(n)),
                       dtype=bool, count=n)


def distort(x: np.ndarray, func, rate: float = 0.8, rng=random) -> np.ndarray:
    """Apply `func` to each sample independently with probability `rate`.

    Mutates and returns x (any shape; samples are its flat view). The
    selected samples go through `func` in float64, matching the reference's
    ``float(x[0][i])`` promotion before the store back into x's dtype.
    """
    flat = _flat_view(x)
    sel = _bernoulli(flat.size, rate, rng)
    flat[sel] = func(flat[sel].astype(np.float64))
    return x


def _flat_view(x: np.ndarray) -> np.ndarray:
    """Flat VIEW of x — reshape(-1) on a non-contiguous array silently
    returns a copy and the write-back is dropped, so that case is an error
    here rather than an undistorted waveform."""
    flat = x.reshape(-1)
    if flat.base is None and flat is not x:
        raise ValueError('distort() needs a contiguous array (reshape(-1) '
                         'copied); pass np.ascontiguousarray(x)')
    return flat


def distort_chain(x: np.ndarray, funcs, rate: float = 0.8,
                  rng=random) -> np.ndarray:
    """Like `distort`, composing funcs left-to-right on selected samples."""
    flat = _flat_view(x)
    sel = _bernoulli(flat.size, rate, rng)
    v = flat[sel].astype(np.float64)
    for func in funcs:
        v = func(v)
    flat[sel] = v
    return x


def distort_wav_conf(x: np.ndarray, distort_type: str, distort_conf,
                     rate: float = 0.1, rng=random) -> np.ndarray:
    """Dispatch one named distortion over a waveform (the reference's CLI
    entry semantics, including gain_db running at the default 0.8 rate)."""
    if distort_type == 'gain_db':
        return distort(x, make_gain_db(distort_conf), rng=rng)
    if distort_type == 'max_distortion':
        return distort(x, make_max_distortion(distort_conf), rate, rng)
    if distort_type == 'fence_distortion':
        return distort(x, make_fence_distortion(distort_conf, rng), rate, rng)
    if distort_type == 'jag_distortion':
        return distort(x, make_jag_distortion(distort_conf, rng), rate, rng)
    if distort_type == 'poly_distortion':
        return distort(x, make_poly_distortion(distort_conf), rate, rng)
    if distort_type == 'quad_distortion':
        return distort(x, make_quad_distortion(), rate, rng)
    if distort_type != 'none_distortion':
        logging.warning('unsupported distortion type %s', distort_type)
    return x


# default confs for the pipeline stage, per distortion family (the
# reference tool's own example configurations)
DEFAULT_CONFS = {
    'max_distortion': {'max_db': -10.0},
    'poly_distortion': {'a': 4, 'm': 2, 'n': 2},
    'quad_distortion': None,
    'fence_distortion': {'mask_number': 1, 'max_db': -30},
    'jag_distortion': {'mask_number': 4},
    'gain_db': {'db': 6.0},
}


def distort_wav(sample: Dict, distort_types=None, prob: float = 0.2,
                rate: float = 0.1, confs=None, rng=random) -> Dict:
    """Pipeline stage: with probability `prob`, apply one randomly chosen
    distortion family to sample['wav'] at per-sample rate `rate`."""
    if rng.uniform(0, 1) > prob:
        return sample
    types = distort_types or list(DEFAULT_CONFS)
    kind = types[int(rng.uniform(0, 1) * len(types)) % len(types)]
    conf = (confs or DEFAULT_CONFS).get(kind)
    wav = np.array(sample['wav'], copy=True)
    sample['wav'] = distort_wav_conf(wav, kind, conf, rate, rng)
    return sample
