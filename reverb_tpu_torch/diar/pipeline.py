"""Speaker diarization: sliding-window segmentation → per-segment speaker
embeddings → agglomerative clustering → stitched global annotation → RTTM.

Counterpart of reverb_tpu/diar/pipeline.py.  The file's wave goes to the
device once, zero-padded to a 256 s bucket plus one spare bucket; the
windows of the segmentation net and the crops of the embedding net are
gathers from it, in fixed tiles (SEG_TILE windows, EMB_TILE crops; fewer
rows round up to a power of two), the crops of one file at one power-of-two
frame count.  A padding row starts at the wave's end and reads zeros; a
crop reads `samp_buck` samples from its segment's start, trailing audio
and then zeros, and the embedding net's stats pooling masks the frames
past its length — the TDNN's dilated convolutions still see them, so the
crops and the bucket are the JAX package's own.  Only binarization,
clustering and stitching run on the host (numpy, copied from the JAX
package).

On the native route (`SegmentationNet` + `EmbeddingNet` at 512 channels)
each embedding tile launches kernel K5 four times (the TDNN's
LayerNorms); the pyannote route (`PyanNet` + `ResNet34`) launches no
kernel of this repository.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from reverb_tpu_torch.diar.models import (EmbeddingConfig,
                                          build_embedding,
                                          powerset_to_multilabel)
from reverb_tpu_torch.frontend.fbank import (FbankConfig,
                                             compute_fbank_batch, num_frames)
from reverb_tpu_torch.utils.common import resolve_device


@dataclasses.dataclass
class DiarizationConfig:
    window_sec: float = 10.0
    step_sec: float = 5.0
    onset: float = 0.5           # speaker-activity binarization threshold
    offset: float = 0.45
    min_duration_on: float = 0.25
    min_duration_off: float = 0.2
    clustering_threshold: float = 0.7    # cosine distance for AHC merge
    min_cluster_size: int = 1
    max_speakers: int = 8


@dataclasses.dataclass
class Segment:
    start: float
    end: float
    speaker: str


def sliding_windows(n_samples: int, sr: int, cfg: DiarizationConfig
                    ) -> List[Tuple[int, int]]:
    win = int(cfg.window_sec * sr)
    step = int(cfg.step_sec * sr)
    if n_samples <= win:
        return [(0, win)]
    starts = list(range(0, n_samples - win + 1, step))
    if starts[-1] + win < n_samples:
        starts.append(n_samples - win)
    return [(s, s + win) for s in starts]


def binarize(activity: np.ndarray, frame_sec: float, cfg: DiarizationConfig
             ) -> List[Tuple[float, float]]:
    """Hysteresis-threshold a per-frame activity curve → (start, end) list."""
    segs = []
    active = False
    start = 0.0
    for t, a in enumerate(activity):
        if not active and a >= cfg.onset:
            active = True
            start = t * frame_sec
        elif active and a < cfg.offset:
            active = False
            end = t * frame_sec
            if end - start >= cfg.min_duration_on:
                segs.append((start, end))
    if active:
        end = len(activity) * frame_sec
        if end - start >= cfg.min_duration_on:
            segs.append((start, end))
    # merge gaps shorter than min_duration_off
    merged = []
    for s in segs:
        if merged and s[0] - merged[-1][1] < cfg.min_duration_off:
            merged[-1] = (merged[-1][0], s[1])
        else:
            merged.append(list(s))
    return [(a, b) for a, b in merged]


def binarize_binary(activity: np.ndarray, frame_sec: float,
                    cfg: DiarizationConfig) -> List[Tuple[float, float]]:
    """`binarize` for BINARY (0/1) activity curves: hysteresis degenerates
    to thresholding, so runs come from np.diff instead of a per-frame
    python loop.  Output order and semantics as `binarize`:
    min_duration_on filter at segment close, THEN min_duration_off gap
    merge."""
    a = activity.astype(bool)
    if not a.any():
        return []
    d = np.diff(a.astype(np.int8))
    starts = np.nonzero(d == 1)[0] + 1
    ends = np.nonzero(d == -1)[0] + 1
    if a[0]:
        starts = np.concatenate([[0], starts])
    if a[-1]:
        ends = np.concatenate([ends, [len(a)]])
    segs = [(s * frame_sec, e * frame_sec)
            for s, e in zip(starts, ends)
            if (e - s) * frame_sec >= cfg.min_duration_on]
    merged: List[List[float]] = []
    for s in segs:
        if merged and s[0] - merged[-1][1] < cfg.min_duration_off:
            merged[-1][1] = s[1]
        else:
            merged.append(list(s))
    return [(x, y) for x, y in merged]


def agglomerative_cluster(embeddings: np.ndarray, threshold: float,
                          max_clusters: int = 8) -> np.ndarray:
    """Average-linkage AHC on cosine distance (host-side), by Lance-Williams
    updates: S[a∪b, k] = (n_a·S[a,k] + n_b·S[b,k]) / (n_a + n_b).  The best
    pair is np.argmax's first in flat order over the original rows, as in
    the JAX package (exact ties may merge in another order than a
    cluster-list scan; both partitions are valid)."""
    n = len(embeddings)
    if n == 0:
        return np.zeros((0,), np.int32)
    S = (embeddings @ embeddings.T).astype(np.float64)
    np.fill_diagonal(S, -np.inf)
    alive = np.ones(n, bool)
    sizes = np.ones(n)
    members: List[List[int]] = [[i] for i in range(n)]
    n_alive = n
    while n_alive > 1:
        i, j = np.unravel_index(int(np.argmax(S)), S.shape)
        best_sim = S[i, j]
        if best_sim < 1.0 - threshold and n_alive <= max_clusters:
            break
        i, j = min(i, j), max(i, j)
        na, nb = sizes[i], sizes[j]
        row = (na * S[i, :] + nb * S[j, :]) / (na + nb)
        S[i, :] = row
        S[:, i] = row
        S[i, i] = -np.inf
        S[j, :] = -np.inf                 # retire j
        S[:, j] = -np.inf
        alive[j] = False
        sizes[i] = na + nb
        members[i] += members[j]
        n_alive -= 1
    labels = np.zeros((n,), np.int32)
    ci = 0
    for idx in range(n):
        if alive[idx]:
            for m in members[idx]:
                labels[m] = ci
            ci += 1
    return labels


def merge_segments(segs: List[Segment], gap: float = 0.1) -> List[Segment]:
    """Stitch overlapping/adjacent same-speaker segments."""
    segs = sorted(segs, key=lambda s: (s.speaker, s.start))
    out: List[Segment] = []
    for s in segs:
        if out and out[-1].speaker == s.speaker and \
                s.start <= out[-1].end + gap:
            out[-1] = Segment(out[-1].start, max(out[-1].end, s.end),
                              s.speaker)
        else:
            out.append(s)
    return sorted(out, key=lambda s: s.start)


def write_rttm(f, segments: List[Segment], uri: str):
    """RTTM rows: SPEAKER <uri> 1 <start> <dur> <NA> <NA> <speaker> <NA> <NA>."""
    for s in segments:
        f.write(f'SPEAKER {uri} 1 {s.start:.3f} {s.end - s.start:.3f} '
                f'<NA> <NA> {s.speaker} <NA> <NA>\n')


def load_rttm(path) -> Dict[str, List[Segment]]:
    out: Dict[str, List[Segment]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0] != 'SPEAKER':
                continue
            uri, start, dur, spk = parts[1], float(parts[3]), \
                float(parts[4]), parts[7]
            out.setdefault(uri, []).append(Segment(start, start + dur, spk))
    return out


def _rows(wave_dev, starts: np.ndarray, n: int):
    """(len(starts), n) rows of wave_dev from each start, the start clamped
    so that the row fits (jax.lax.dynamic_slice's rule)."""
    s = torch.from_numpy(np.clip(starts, 0, wave_dev.shape[0] - n)).to(
        wave_dev.device)
    return wave_dev.unfold(0, n, 1)[s]


class Diarizer:
    """End-to-end diarization of one audio file on `device` (default
    'cuda', which raises without a card).

    `segmentation(wave (B, T)) → (B, T', C)` powerset log-probs, with
    attributes frame_sec, max_speakers and max_simultaneous;
    `embedding(feats (B, T, F), lens (B,)) → (B, E)`, with feat_dim.  The
    native nets (diar/models.py) and the pyannote-compatible ones
    (diar/pyannet.py, `from_pyannote_checkpoints`) both fit.  The last
    call's per-phase wall times land in `last_phases` (ms) and its
    segments' embeddings in `last_embeddings` (n_segments, E)."""

    # Windows and crops run as fixed tiles of rows (fewer rows round up to
    # a power of two), crops at a power-of-two frame count (64-1024 for
    # segments up to a window): the shapes the JAX package compiles once.
    SEG_TILE = 512
    EMB_TILE = 128
    # the device wave's length: 256 s multiples plus one spare 256 s
    WAVE_CHUNK_S = 256

    def __init__(self, segmentation: nn.Module, embedding: nn.Module,
                 cfg: DiarizationConfig = DiarizationConfig(),
                 device='cuda'):
        self.device = resolve_device(device)
        self.segmentation = segmentation.to(self.device)
        self.embedding = embedding.to(self.device)
        self.cfg = cfg
        self.last_phases: Dict[str, float] = {}
        self.last_embeddings = np.zeros((0, 0), np.float32)

    @classmethod
    def from_pyannote_checkpoints(cls, segmentation_ckpt: str,
                                  embedding_ckpt: Optional[str] = None,
                                  cfg: Optional[DiarizationConfig] = None,
                                  device='cuda'):
        """A Diarizer from released pyannote-format checkpoints: a PyanNet
        segmentation .ckpt/.bin (e.g. Revai/reverb-diarization-v1/2) and
        optionally a wespeaker ResNet34 embedding .pt.  Without the latter
        the native embedding net, randomly initialized from a generator
        seeded 0 (a smoke run's weights)."""
        from reverb_tpu_torch.diar.pyannet import (load_pyannet_checkpoint,
                                                   load_resnet34_checkpoint)
        dev = resolve_device(device)
        seg = load_pyannet_checkpoint(segmentation_ckpt, dev)
        if embedding_ckpt:
            emb = load_resnet34_checkpoint(embedding_ckpt, dev)
        else:
            emb = build_embedding(EmbeddingConfig(), dev, generator=(
                torch.Generator(device=dev).manual_seed(0)))
        return cls(seg, emb, cfg or DiarizationConfig(), dev)

    @staticmethod
    def _tile_rows(n: int, cap: int) -> int:
        if n >= cap:
            return cap
        t = 1
        while t < n:
            t *= 2
        return t

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _bucket_wave(self, wave: np.ndarray, sr: int):
        chunk = self.WAVE_CHUNK_S * sr
        bucket = (len(wave) // chunk + 2) * chunk
        wave_dev = torch.zeros(bucket, dtype=torch.float32,
                               device=self.device)
        wave_dev[:len(wave)] = torch.from_numpy(
            np.ascontiguousarray(wave, np.float32)).to(self.device)
        return wave_dev

    def _activity(self, wave_dev, starts: np.ndarray, win_len: int):
        """(rows, T', S) uint8 speaker activity of the windows at starts."""
        seg = self.segmentation
        logp = seg(_rows(wave_dev, starts, win_len))
        return powerset_to_multilabel(torch.exp(logp), seg.max_speakers,
                                      seg.max_simultaneous).to(torch.uint8)

    @staticmethod
    def _fbank_from_wave(wave_dev, starts: np.ndarray, fb_cfg: FbankConfig,
                         samp: int, n_frames: int):
        """(rows, n_frames, M) fbank of the samp-sample crops at starts."""
        return compute_fbank_batch(_rows(wave_dev, starts, samp) * (1 << 15),
                                   fb_cfg, n_frames)

    def warm_buckets(self, sr: int = 16000,
                     buckets=(64, 128, 256, 512, 1024)):
        """One fbank and embedding tile at each crop bucket a long file can
        hit, so that their first use (workspace, allocator) falls outside
        a timed call."""
        fb_cfg = FbankConfig(sample_rate=sr,
                             num_mel_bins=self.embedding.feat_dim)
        with torch.inference_mode():
            for bt in buckets:
                samp = (bt - 1) * fb_cfg.window_shift + fb_cfg.window_size
                f = self._fbank_from_wave(
                    torch.zeros(samp, device=self.device),
                    np.zeros(self.EMB_TILE, np.int64), fb_cfg, samp, bt)
                self.embedding(f, torch.ones(self.EMB_TILE, dtype=torch.long,
                                             device=self.device))
        self._sync()

    def __call__(self, wave: np.ndarray, sr: int = 16000) -> List[Segment]:
        """Diarize one file (wave in [-1, 1]); per-phase wall times in
        `self.last_phases` (ms)."""
        with torch.inference_mode():
            return self._diarize(wave, sr)

    def _diarize(self, wave: np.ndarray, sr: int) -> List[Segment]:
        cfg = self.cfg
        ph = {}
        t_start = time.perf_counter()
        windows = sliding_windows(len(wave), sr, cfg)
        win_len = windows[0][1] - windows[0][0]
        n_win = len(windows)
        tile = self._tile_rows(n_win, self.SEG_TILE)
        n_pad = -n_win % tile
        wave_dev = self._bucket_wave(wave, sr)
        starts = np.full((n_win + n_pad,), len(wave), np.int64)
        starts[:n_win] = [s for (s, _) in windows]
        activity = np.concatenate([
            self._activity(wave_dev, starts[t:t + tile], win_len).cpu()
            .numpy() for t in range(0, len(starts), tile)])[:n_win]
        frame_sec = self.segmentation.frame_sec
        t1 = time.perf_counter()
        ph['segmentation_ms'] = round((t1 - t_start) * 1e3, 1)

        # local segments: (start, end, window, speaker slot)
        local: List[Tuple[float, float, int, int]] = []
        for w, (ws, _) in enumerate(windows):
            off = ws / sr
            for s_idx in range(activity.shape[2]):
                for a, b in binarize_binary(activity[w, :, s_idx],
                                            frame_sec, cfg):
                    local.append((off + a, off + b, w, s_idx))
        t2 = time.perf_counter()
        ph['binarize_ms'] = round((t2 - t1) * 1e3, 1)
        if not local:
            self.last_phases = ph
            self.last_embeddings = np.zeros((0, 0), np.float32)
            return []

        # each segment's crop: its start, samp_buck samples, frames up to
        # the power-of-two bucket (≥ 64); stats pooling masks by lens
        fb_cfg = FbankConfig(sample_rate=sr,
                             num_mel_bins=self.embedding.feat_dim)
        n_seg = len(local)
        seg_lens = [max(int(b * sr) - int(a * sr), fb_cfg.window_size)
                    for (a, b, _, _) in local]
        lens_f = [num_frames(n, fb_cfg) for n in seg_lens]
        buck_T = 64
        while buck_T < max(lens_f):
            buck_T *= 2
        samp_buck = (buck_T - 1) * fb_cfg.window_shift + fb_cfg.window_size
        tile = self._tile_rows(n_seg, self.EMB_TILE)
        n_pad = -n_seg % tile
        seg_starts = np.full((n_seg + n_pad,), len(wave), np.int64)
        lens = np.ones((n_seg + n_pad,), np.int64)
        for i, ((a, _, _, _), lf) in enumerate(zip(local, lens_f)):
            seg_starts[i] = int(a * sr)
            lens[i] = max(lf, 1)
        feats = [self._fbank_from_wave(wave_dev, seg_starts[t:t + tile],
                                       fb_cfg, samp_buck, buck_T)
                 for t in range(0, len(seg_starts), tile)]
        self._sync()
        t3 = time.perf_counter()
        ph['fbank_ms'] = round((t3 - t2) * 1e3, 1)

        lens_dev = torch.from_numpy(lens).to(self.device)
        embs = torch.cat([self.embedding(f, lens_dev[i * tile:(i + 1) * tile])
                          for i, f in enumerate(feats)]).cpu().numpy()[:n_seg]
        t4 = time.perf_counter()
        ph['embedding_ms'] = round((t4 - t3) * 1e3, 1)

        labels = agglomerative_cluster(embs, cfg.clustering_threshold,
                                       cfg.max_speakers)
        segs = [Segment(a, b, f'SPEAKER_{labels[i]:02d}')
                for i, (a, b, _, _) in enumerate(local)]
        out = merge_segments(segs)
        t5 = time.perf_counter()
        ph['cluster_stitch_ms'] = round((t5 - t4) * 1e3, 1)
        ph['total_ms'] = round((t5 - t_start) * 1e3, 1)
        self.last_phases = ph
        self.last_embeddings = embs
        return out
