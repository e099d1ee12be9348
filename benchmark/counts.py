"""Operations and bytes that the work needs, from shapes: the yardstick of
the roofline and MFU readers.

Kernel rule (the port's PERF.md kernel table): a call's least time is the
larger of its operations over the peak of its dtype and its bytes over
3.35 TB/s, each input read once and each output written once.  Model
FLOPs count the multiply-adds of the matrix products and convolutions
(2 a multiply-add) on the frames and tokens that the inputs hold, not on
padding; a training step counts three forwards (forward and backward).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

ELEM = {'float': 4, 'float32': 4, 'c10::BFloat16': 2, 'bfloat16': 2,
        'c10::Half': 2, 'float16': 2, 'double': 8}

Call = Tuple[float, float]        # (operations, bytes)


def _numel(dims: Sequence[int]) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


# ------------------------------ kernels ------------------------------

def k5_layer_norm(dims: List, types: List) -> Call:
    """K5 forward, one call on x (N, C): x read, y written, the affine
    read; about 8 operations an element."""
    x = _numel(dims[0])
    c = int(dims[0][-1])
    elem = ELEM.get(types[0], 4)
    return 8.0 * x, float(2 * x * elem + 2 * c * 4)


def k6_layer_norm_bwd(dims: List, types: List) -> Call:
    """K6, the backward of one K5 call: x and dy read, dx written (the
    per-column dw, db partial sums are the kernel's own)."""
    x = _numel(dims[0])
    c = int(dims[0][-1])
    elem = ELEM.get(types[0], 4)
    return 12.0 * x, float(3 * x * elem + 3 * c * 4)


# ------------------------------ models ------------------------------

def whisper_forward_flops(c: Dict, mel_frames: int,
                          text_positions: int) -> float:
    """One Whisper forward of one clip: the conv front, the encoder blocks,
    and the decoder over `text_positions` positions with cross-attention
    over the audio and the tied output projection."""
    d = c['d_model']
    V = c['vocab_size']
    m = c['num_mel_bins']
    T = (mel_frames - 1) // 2 + 1
    enc = 2.0 * mel_frames * m * d * 3 + 2.0 * T * d * d * 3
    enc += c['encoder_layers'] * (24.0 * T * d * d + 4.0 * T * T * d)
    L = text_positions
    dec = c['decoder_layers'] * (8.0 * L * d * d + 4.0 * L * L * d
                                 + 4.0 * L * d * d + 4.0 * T * d * d
                                 + 4.0 * L * T * d + 16.0 * L * d * d)
    return enc + dec + 2.0 * L * d * V


def whisper_step_flops(c: Dict, mel_frames: int,
                       text_positions: Sequence[int]) -> float:
    """A training step: three forwards of each clip."""
    return 3.0 * sum(whisper_forward_flops(c, mel_frames, L)
                     for L in text_positions)


def bound_seconds(calls: Iterable[Call], peak_flops: float,
                  peak_bytes_s: float) -> float:
    """Σ over calls of max(operations / peak, bytes / bandwidth)."""
    return sum(max(o / peak_flops, b / peak_bytes_s) for o, b in calls)
