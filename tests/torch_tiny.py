"""The tiny model directory of tests/helpers.py with its CTC head reshaped
like a trained one, for the port's tests that compare a whole model's output
with the JAX package's (tests/test_torch_slice.py says why a random head
must be reshaped: flat random logits take a degenerate path)."""

import jax.numpy as jnp
import numpy as np

from helpers import build_tiny_model_dir, write_wav


def reshaped_tiny_dir(d):
    """build_tiny_model_dir(d) plus a 3 s `a.wav`, the CTC head's weight ×8,
    each token's logit centred over the wav's frames and the blank bias
    raised to the 75th percentile of (best non-blank − blank)."""
    from reverb_tpu.cli.reverb import ReverbASR
    from reverb_tpu.convert.torch_ckpt import load_npz, save_npz
    from reverb_tpu.decode.api import encode_and_ctc
    from reverb_tpu.models import ctc as ctc_mod
    d = build_tiny_model_dir(d)
    wav = write_wav(d / 'a.wav', seconds=3.0)
    ref = ReverbASR(str(d / 'config.yaml'), str(d / 'model.npz'))
    feats = np.asarray(ref.compute_feats(str(wav)))
    params, _ = load_npz(str(d / 'model.npz'))
    w = np.asarray(params['ctc']['ctc_lo']['weight']) * 8
    probe = dict(ref.params)
    probe['ctc'] = {'ctc_lo': {'weight': jnp.asarray(w),
                               'bias': jnp.zeros(w.shape[0])}}
    enc, lens, _ = encode_and_ctc(probe, ref.model_config,
                                  jnp.asarray(feats[None]),
                                  jnp.asarray([feats.shape[0]]),
                                  jnp.asarray([1.0, 0.0]))
    logits = np.asarray(ctc_mod.ctc_logits(probe['ctc'], enc))[0][
        :int(lens[0])]
    bias = -logits.mean(0)
    logits = logits + bias
    bias[0] += float(np.quantile(logits[:, 1:].max(-1) - logits[:, 0], 0.75))
    params['ctc']['ctc_lo'] = {'weight': w, 'bias': bias.astype(np.float32)}
    save_npz(str(d / 'model.npz'), params)
    return d


def speechy_wav(path, seconds: float, seed: int, sr: int = 16000):
    """A 16-bit mono WAV of harmonic bursts and noise under a varying
    envelope: its frames differ from each other (a steady tone's frames are
    all alike, so any two alignments of it tie)."""
    import wave
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = np.repeat(rng.rand(n // 1600 + 1), 1600)[:n]
    f0 = np.repeat(rng.uniform(90, 250, n // 3200 + 1), 3200)[:n]
    x = (np.sin(2 * np.pi * f0 * t) + 0.3 * rng.randn(n)) * env * 6000
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(x, -32768, 32767).astype(np.int16).tobytes())
    return path
