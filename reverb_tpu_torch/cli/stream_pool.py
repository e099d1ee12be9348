"""Multi-stream serving: B concurrent streams advanced by one batched hop.

Counterpart of reverb_tpu/cli/stream_pool.py (`MultiStreamASR`).  Every
slot's static att/cnn rings are stacked on the batch axis, and `step()`
advances ALL slots that have a full window buffered with one
`ConformerEncoder.forward_chunk` call, per-slot absolute offsets (B,)
carried into the rel-pos rows and the cache-validity masks, so streams may
join at any time.  A slot that is not ready is stepped on a zero window and
its caches are put back (`torch.where`), as the JAX pool does.  The B
prefix beams are one `decode/streaming_beam.BeamBank`: ONE launch of kernel
K2 a step for all slots, a slot that is not ready holding its state (its
frames are invalid to K2).  `reset_slot` frees one slot for a new stream
without touching the others.

Unlike the JAX pool (reverb_tpu/cli/stream_pool.py:189-222, whose per-slot
sample and feature buffers grow for the life of the stream), each slot keeps
only the samples and frames a later window still reads.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from reverb_tpu_torch.cli.model import CONTEXT
from reverb_tpu_torch.decode import prefix_beam as pb
from reverb_tpu_torch.decode import rescoring as rs
from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.decode.streaming_beam import BeamBank, IncrementalGreedy
from reverb_tpu_torch.frontend.fbank import compute_fbank, num_frames
from reverb_tpu_torch.models.ctc import ctc_logprobs
from reverb_tpu_torch.models.encoder import init_stream_caches


class MultiStreamASR:
    """Pool of `n_streams` chunk-incremental recognizers sharing one set of
    batched device calls.  `accept_waveform(slot, samples)` buffers audio;
    `step()` advances every slot with a full window buffered (call it after
    feeding a hop to each active slot; again to drain a backlog);
    `decode(slot, mode)` reads the current hypothesis; `reset_slot(slot)`
    frees a slot for a new stream.

    keep_encoder_out=True keeps each slot's encoder output on the device
    (attention_rescoring needs it; off by default)."""

    def __init__(self, reverb_model, n_streams: int,
                 decoding_chunk_size: int = 16, num_left_chunks: int = 16,
                 verbatimicity: float = 1.0, beam_size: int = 10,
                 keep_encoder_out: bool = False):
        self.asr = reverb_model
        self.model = reverb_model.model
        self.cfg = self.model.cfg
        self.device = reverb_model.device
        self.fbank_cfg = reverb_model.fbank
        self.B = int(n_streams)
        self.sub = self.cfg.encoder.subsampling_rate
        self.chunk = int(decoding_chunk_size)
        self.window = (self.chunk - 1) * self.sub + CONTEXT[self.sub]
        self.stride = self.sub * self.chunk
        self.cache_t = self.chunk * int(num_left_chunks)
        self.cat = torch.tensor([verbatimicity, 1.0 - verbatimicity],
                                dtype=torch.float32, device=self.device)
        self.beam_size = int(beam_size)
        self.keep_encoder_out = keep_encoder_out
        self.blank_id = self.cfg.blank_id
        self.reset()

    # ------------------------------ state ------------------------------

    def reset(self):
        B, M = self.B, self.fbank_cfg.num_mel_bins
        self.att_cache, self.cnn_cache = init_stream_caches(
            self.cfg.encoder, self.cache_t, B, self.cfg.compute_dtype,
            self.device)
        self._offsets = np.zeros((B,), np.int64)     # encoder frames out
        self._pcm = [np.zeros((0,), np.float32) for _ in range(B)]
        self._pcm_start = np.zeros((B,), np.int64)   # sample of _pcm[b][0]
        self._feat = [torch.zeros((0, M), dtype=torch.float32,
                                  device=self.device) for _ in range(B)]
        self._feat_start = np.zeros((B,), np.int64)  # frame of _feat[b][0]
        self._n_feats = np.zeros((B,), np.int64)     # frames computed
        self._consumed = np.zeros((B,), np.int64)    # first frame needed
        self._beams = BeamBank(B, self.beam_size, self.blank_id,
                               device=self.device)
        self._greedy = [IncrementalGreedy(self.blank_id) for _ in range(B)]
        self._enc_chunks: List[List[torch.Tensor]] = [[] for _ in range(B)]

    def reset_slot(self, b: int):
        """Zero slot b's caches, beam and buffers; the other slots' state is
        untouched."""
        with torch.inference_mode():
            self.att_cache[:, b] = 0
            if self.cnn_cache is not None:
                self.cnn_cache[:, b] = 0
            self._beams.reset_slot(b)
        self._offsets[b] = 0
        self._pcm[b] = np.zeros((0,), np.float32)
        self._pcm_start[b] = 0
        self._feat[b] = self._feat[b][:0]
        self._feat_start[b] = 0
        self._n_feats[b] = 0
        self._consumed[b] = 0
        self._greedy[b].reset()
        self._enc_chunks[b] = []

    def buffered(self, b: int):
        """(samples, feature frames) slot b holds now."""
        return len(self._pcm[b]), int(self._feat[b].shape[0])

    # ------------------------------ input ------------------------------

    def accept_waveform(self, b: int, samples: np.ndarray,
                        sample_rate: int = 16000):
        """Buffer samples (float32 in [-1, 1)) for slot b.  No device work:
        call `step()` once per hop after feeding the active slots."""
        if sample_rate != self.fbank_cfg.sample_rate:
            raise ValueError(f'sample rate {sample_rate}, the model takes '
                             f'{self.fbank_cfg.sample_rate}')
        self._pcm[b] = np.concatenate(
            [self._pcm[b], np.asarray(samples, np.float32) * (1 << 15)])

    def _advance_fbank(self):
        """The fbank frames each slot's buffered samples now complete; the
        samples before the next frame's first one are dropped."""
        cfg = self.fbank_cfg
        for b in range(self.B):
            start = int(self._n_feats[b]) * cfg.window_shift \
                - int(self._pcm_start[b])
            n_new = num_frames(len(self._pcm[b]) - start, cfg)
            if n_new <= 0:
                continue
            wave = torch.from_numpy(self._pcm[b][start:]).to(self.device)
            self._feat[b] = torch.cat(
                [self._feat[b], compute_fbank(wave, cfg, n_frames=n_new)])
            self._n_feats[b] += n_new
            drop = int(self._n_feats[b]) * cfg.window_shift \
                - int(self._pcm_start[b])
            self._pcm[b] = self._pcm[b][drop:]
            self._pcm_start[b] += drop

    def step(self) -> np.ndarray:
        """Advance every slot with a full window buffered by ONE hop in one
        batched encoder call and one K2 launch.  Returns the ready mask
        (who advanced)."""
        self._advance_fbank()
        ready = self._n_feats - self._consumed >= self.window
        if not ready.any():
            return ready
        M = self.fbank_cfg.num_mel_bins
        win = torch.zeros((self.B, self.window, M), dtype=torch.float32,
                          device=self.device)
        for b in np.nonzero(ready)[0]:
            s = int(self._consumed[b] - self._feat_start[b])
            win[b] = self._feat[b][s:s + self.window]
        ready_t = torch.from_numpy(ready).to(self.device)
        with torch.inference_mode():
            ys, att, cnn = self.model.encoder.forward_chunk(
                win.to(self.cfg.compute_dtype),
                torch.from_numpy(self._offsets).to(self.device),
                self.att_cache, self.cnn_cache,
                self.cat if self.cfg.lsl_enc else None)
            self.att_cache = torch.where(ready_t[None, :, None, None, None],
                                         att, self.att_cache)
            if cnn is not None:
                self.cnn_cache = torch.where(ready_t[None, :, None, None],
                                             cnn, self.cnn_cache)
            lp = ctc_logprobs(self.model.ctc, ys, 0.0, self.blank_id)
            self._beams.hop(lp, ready)
            top1 = lp.argmax(-1).cpu().numpy()
        chunk_t = int(ys.shape[1])
        for b in np.nonzero(ready)[0]:
            self._greedy[b].accept(top1[b])
            if self.keep_encoder_out:
                self._enc_chunks[b].append(ys[b])
            self._consumed[b] += self.stride
            self._offsets[b] += chunk_t
            # frames before the slot's next window are not read again
            drop = int(self._consumed[b] - self._feat_start[b])
            self._feat[b] = self._feat[b][drop:]
            self._feat_start[b] = self._consumed[b]
        return ready

    # ------------------------------ output ------------------------------

    def decode(self, b: int, mode: str = 'ctc_prefix_beam_search',
               ctc_weight: float = 0.1,
               reverse_weight: float = 0.0) -> DecodeResult:
        if self._beams.offsets[b] == 0:
            return DecodeResult(tokens=[])
        if mode == 'ctc_greedy_search':
            return self._greedy[b].result()
        if mode == 'ctc_prefix_beam_search':
            return self._beams.finalize(b)
        if mode != 'attention_rescoring':
            raise ValueError(f'unknown streaming decode mode {mode!r}')
        if not self.keep_encoder_out:
            raise ValueError('attention_rescoring decode needs '
                             'keep_encoder_out=True')
        with torch.inference_mode():
            enc = torch.cat(self._enc_chunks[b])[None]
            lens = torch.tensor([enc.shape[1]], dtype=torch.int32,
                                device=self.device)
            raw = self._beams.finalize_raw(b)
            return rs.attention_rescoring(
                self.model, pb._pack_results(*raw), enc, lens, raw,
                ctc_weight, reverse_weight, self.cat)[0]

    def text(self, b: int, **kwargs) -> str:
        res = self.decode(b, **kwargs)
        text, _ = self.asr.tokenizer.detokenize(res.tokens)
        return text
