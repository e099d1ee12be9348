"""Rev-specific augmentation / conditioning transforms (the port's copy of
reverb_tpu/data/rev_processor.py).

Parity targets (asr/wenet/dataset/rev_processor.py):
  - add_one_hot (:41-113): append a normalized one-hot cat-emb to EVERY frame
  - pass_one_hot (:115-159): sample-level cat_emb vector for LSL conditioning
    (multi-hot sampling with p=0.25)
  - SpecialTokensHandler (:161-229): reject/remove/relabel words, trailing
    dash stripping
  - generate_speaker_switch_utterances (:295-384): concatenate consecutive
    utterances with ' <sw> ' separators between different speakers
  - apply_telephony (:469-537): lowpass+8k downsample + codec roundtrip —
    here scipy filters + μ-law quantization (sox/ffmpeg-free equivalent)
  - RIREngine (:410-466): convolutional reverb from an impulse list, p=0.2
  - filter_long_yeah_okay (:540-587)
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
from scipy import signal as _signal

from reverb_tpu_torch.data.pipeline import mystats

DEFAULTS_VALS = {'lang': 'en', 'style': 'nv'}


def _resolve_field(sample: Dict, field: str, defaults=DEFAULTS_VALS):
    if field == 'lang' and field not in sample:
        sample[field] = sample.get('tk_lang', defaults['lang'])
    elif field == 'style' and field not in sample:
        sample[field] = defaults['style']
    val = sample.get(field, '')
    if isinstance(val, bytes):
        val = val.decode('utf8').strip()
        sample[field] = val
    return val


def _one_hot(sample: Dict, emb_len: int, field: str, one_hot_ids,
             force_hot, multi_hot: bool) -> np.ndarray:
    onehot = np.zeros((emb_len,), np.float32)
    val = _resolve_field(sample, field)
    if one_hot_ids:
        for f in str(val).split():
            onehot[one_hot_ids[f]] = 1.0
    for f in (force_hot or []):
        onehot[int(f)] = 1.0
    if multi_hot and random.random() > 0.75:
        samp = random.randint(0, emb_len)
        if samp == emb_len:
            onehot = np.ones((emb_len,), np.float32)
        else:
            onehot[samp] = 1.0
    s = onehot.sum()
    return onehot / s if s > 0 else onehot


def add_one_hot(sample: Dict, emb_len: int = 1, field: str = 'lang',
                one_hot_ids=None, multi_hot: bool = False, force_hot=None,
                defaults_vals=DEFAULTS_VALS) -> Dict:
    """Append the cat-emb to every feature frame (+CMVN handled by the model
    config's input_dim)."""
    onehot = _one_hot(sample, emb_len, field, one_hot_ids, force_hot,
                      multi_hot)
    T = sample['feat'].shape[0]
    sample['feat'] = np.concatenate(
        [sample['feat'], np.tile(onehot[None, :], (T, 1))], axis=1)
    return sample


def pass_one_hot(sample: Dict, emb_len: int = 1, field: str = 'lang',
                 one_hot_ids=None, multi_hot: bool = False, force_hot=None,
                 defaults_vals=DEFAULTS_VALS) -> Dict:
    sample['cat_emb'] = _one_hot(sample, emb_len, field, one_hot_ids or {},
                                 force_hot, multi_hot)
    return sample


class SpecialTokensHandler:
    """reject_on / remove / relabel word-level rules (rev_processor.py:161-229).
    transform() returns None for rejected samples; filter() drops them."""

    def __init__(self, config: Dict):
        self.reject_set = set(config.get('reject_on', []) or [])
        self.remove_set = set(config.get('remove', []) or [])
        self.relabel_map = dict(config.get('relabel', []) or [])
        self.remove_trailing_dash = config.get('remove_trailing_dash', False)

    def filter(self, sample) -> bool:
        return sample is not None

    def transform(self, sample: Optional[Dict]) -> Optional[Dict]:
        if sample is None:
            return None
        words = sample['txt'].split()
        out: List[str] = []
        for w in words:
            if self.remove_trailing_dash and w.endswith('-'):
                w = w[:-1]
            if w in self.reject_set:
                mystats[w] += 1
                return None
            if w in self.remove_set:
                mystats[w] += 1
                continue
            if w in self.relabel_map:
                mystats[w] += 1
                out.append(self.relabel_map[w])
            else:
                out.append(w)
        if not out:
            return None
        sample['otxt'] = sample['txt']
        sample['txt'] = ' '.join(out)
        return sample


def generate_speaker_switch_utterances(samples: Iterable[Dict],
                                       config: Dict) -> Iterator[Dict]:
    """Concatenate consecutive short utterances; insert ' <sw> ' between
    different speakers (rev_processor.py:295-384). Speaker id = key up to the
    last '-'."""
    sr = config.get('sampling_rate', 16000)
    min_ok = config.get('min_audio_len_acceptable_secs', 1)
    min_len = config.get('min_audio_len_secs', 10)
    max_len = config.get('max_audio_len_secs', 20)
    max_utt = config.get('max_utt_combined', 7)

    def speaker_of(key: str) -> str:
        return key[:key.rindex('-')] if '-' in key else key

    cur = None
    cur_spk = None
    n_comb = 0
    for sample in samples:
        spk = speaker_of(sample['key'])
        if cur is None:
            cur, cur_spk, n_comb = sample, spk, 1
            continue
        cur_T = cur['wav'].shape[1]
        if (cur_T < sr * min_ok or cur_T > sr * min_len
                or n_comb >= max_utt
                or cur_T + sample['wav'].shape[1] > sr * max_len):
            yield cur
            cur, cur_spk, n_comb = sample, spk, 1
            continue
        n_comb += 1
        cur['wav'] = np.concatenate([cur['wav'], sample['wav']], axis=1)
        sep = ' ' if cur_spk == spk else ' <sw> '
        cur['txt'] = (cur['txt'] + sep + sample['txt']).replace(
            '<sw> <sw>', '<sw>')
        cur_spk = spk
    if cur is not None:
        yield cur


# ------------------------------ telephony ------------------------------

def _mu_law_roundtrip(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    """μ-law companding codec roundtrip (8-bit G.711-style degradation)."""
    comp = np.sign(x) * np.log1p(mu * np.abs(np.clip(x, -1, 1))) / np.log1p(mu)
    q = np.round((comp + 1) / 2 * mu) / mu * 2 - 1
    return np.sign(q) * (np.expm1(np.abs(q) * np.log1p(mu))) / mu


def apply_telephony(sample: Dict, prob: float = 0.2,
                    codecs=('ulaw',), lowpass_hz: float = 3400.0) -> Dict:
    """Telephony channel simulation (rev_processor.py:469-537): lowpass →
    8 kHz downsample → companding codec roundtrip → upsample back."""
    if random.random() > prob:
        return sample
    sr = sample['sample_rate']
    wav = sample['wav'][0]
    sos = _signal.butter(6, lowpass_hz, btype='low', fs=sr, output='sos')
    wav = _signal.sosfilt(sos, wav).astype(np.float32)
    nb = _signal.resample_poly(wav, 8000, sr).astype(np.float32)
    peak = np.abs(nb).max() or 1.0
    nb = _mu_law_roundtrip(nb / peak) * peak
    wav = _signal.resample_poly(nb, sr, 8000).astype(np.float32)
    sample['wav'] = wav[None, :len(sample['wav'][0])]
    mystats['telephony_applied'] += 1
    return sample


class RIREngine:
    """Convolutional reverb from a list of impulse-response wavs
    (rev_processor.py:410-466)."""

    def __init__(self, config: Dict):
        self.prob = config.get('prob', 0.2)
        self.rirs: List[np.ndarray] = []
        rir_list = config.get('rir_list_fn') or config.get('rir_list')
        if isinstance(rir_list, str):
            from reverb_tpu_torch.frontend.audio import load_audio, to_mono
            with open(rir_list) as f:
                for line in f:
                    path = line.strip()
                    if path:
                        x, sr = load_audio(path)
                        self.rirs.append(to_mono(x))
        elif isinstance(rir_list, list):
            self.rirs = [np.asarray(r, np.float32) for r in rir_list]

    def apply_rir(self, sample: Dict) -> Dict:
        if not self.rirs or random.random() > self.prob:
            return sample
        rir = random.choice(self.rirs)
        rir = rir / (np.linalg.norm(rir) or 1.0)
        wav = sample['wav'][0]
        out = _signal.fftconvolve(wav, rir)[:len(wav)].astype(np.float32)
        sample['wav'] = out[None, :]
        mystats['rir_applied'] += 1
        return sample


def filter_long_yeah_okay(sample: Dict, max_count: int = 10) -> bool:
    """Drop degenerate utterances that are mostly repeated fillers
    (rev_processor.py:540-587 behavior: long runs of yeah/okay/uh-huh etc.)."""
    words = sample.get('txt', '').lower().split()
    if len(words) < max_count:
        return True
    fillers = {'yeah', 'okay', 'yes', 'uh-huh', 'mm-hmm', 'right', 'mhm'}
    n_fill = sum(1 for w in words if w in fillers)
    if n_fill >= max_count and n_fill / len(words) > 0.8:
        mystats['filter_yeah_okay'] += 1
        return False
    return True
