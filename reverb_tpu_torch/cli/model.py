"""Streaming recognition: one stream, decoded as its audio arrives.

Counterpart of reverb_tpu/cli/model.py (`StreamingASR`), the runtime
surface of the reference (asr/wenet/cli/model.py: chunk encoder + beam
search + rescoring).  Audio goes in with `accept_waveform`; each time a
window of features is buffered, the chunk encoder
(models/encoder.ConformerEncoder.forward_chunk, static-shape att/cnn
rings) runs once and the hop's CTC log-probs advance the hop-resumable
decoders (decode/streaming_beam.py: one K2 launch a hop).  `decode()`
reads the current hypothesis at any time.

Everything runs on the ReverbASR's device (the card unless the caller asked
for the CPU) in the model's compute dtype: the fbank of the new samples, the
encoder, the beam.  Unlike the JAX class, the samples and feature frames
that no later window needs are dropped as the stream advances, so memory
follows the window, not the stream (the encoder output is kept for
attention_rescoring).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from reverb_tpu_torch.decode import prefix_beam as pb
from reverb_tpu_torch.decode import rescoring as rs
from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.decode.streaming_beam import (IncrementalBeam,
                                                    IncrementalGreedy)
from reverb_tpu_torch.frontend.fbank import compute_fbank, num_frames
from reverb_tpu_torch.models.ctc import ctc_logprobs
from reverb_tpu_torch.models.encoder import init_stream_caches

# right context + 1 of each subsampling: raw frames of a one-frame window
CONTEXT = {1: 1, 4: 7, 6: 11, 8: 15}


class StreamingASR:
    """Chunk-incremental recognizer over a loaded ReverbASR."""

    def __init__(self, reverb_model, decoding_chunk_size: int = 16,
                 num_left_chunks: int = 16, verbatimicity: float = 1.0,
                 beam_size: int = 10):
        self.asr = reverb_model
        self.model = reverb_model.model
        self.cfg = self.model.cfg
        self.device = reverb_model.device
        self.fbank_cfg = reverb_model.fbank
        self.sub = self.cfg.encoder.subsampling_rate
        self.chunk = int(decoding_chunk_size)
        self.window = (self.chunk - 1) * self.sub + CONTEXT[self.sub]
        self.stride = self.sub * self.chunk
        self.cache_t = self.chunk * int(num_left_chunks)
        self.cat = torch.tensor([verbatimicity, 1.0 - verbatimicity],
                                dtype=torch.float32, device=self.device)
        self.beam_size = int(beam_size)
        self.reset()

    def reset(self):
        self.att_cache, self.cnn_cache = init_stream_caches(
            self.cfg.encoder, self.cache_t, 1, self.cfg.compute_dtype,
            self.device)
        self._pcm = np.zeros((0,), np.float32)      # int16-scale samples
        self._pcm_start = 0                         # sample index of _pcm[0]
        self._feat = torch.zeros((0, self.fbank_cfg.num_mel_bins),
                                 dtype=torch.float32, device=self.device)
        self._feat_start = 0                        # frame index of _feat[0]
        self._n_feats = 0                           # frames computed
        self._consumed = 0                          # first frame still needed
        self._offset = 0                            # encoder frames out
        self._enc_chunks: List[torch.Tensor] = []
        self._inc_beam = IncrementalBeam(self.beam_size, self.cfg.blank_id,
                                         device=self.device)
        self._inc_greedy = IncrementalGreedy(self.cfg.blank_id)

    # ------------------------------ input ------------------------------

    def accept_waveform(self, samples: np.ndarray, sample_rate: int = 16000):
        """samples: float32 in [-1, 1) (any length)."""
        if sample_rate != self.fbank_cfg.sample_rate:
            raise ValueError(f'sample rate {sample_rate}, the model takes '
                             f'{self.fbank_cfg.sample_rate}')
        self._pcm = np.concatenate(
            [self._pcm, np.asarray(samples, np.float32) * (1 << 15)])
        self._advance()

    def _advance(self):
        cfg = self.fbank_cfg
        # the fbank frames the buffered samples now complete; a frame reads
        # only its own window, so the tail from the next frame's first
        # sample is enough, and the samples before it are dropped
        start = self._n_feats * cfg.window_shift - self._pcm_start
        n_new = num_frames(len(self._pcm) - start, cfg)
        if n_new > 0:
            wave = torch.from_numpy(self._pcm[start:]).to(self.device)
            self._feat = torch.cat(
                [self._feat, compute_fbank(wave, cfg, n_frames=n_new)])
            self._n_feats += n_new
            drop = self._n_feats * cfg.window_shift - self._pcm_start
            self._pcm = self._pcm[drop:]
            self._pcm_start += drop
        ran = False
        with torch.inference_mode():
            while self._n_feats - self._consumed >= self.window:
                s = self._consumed - self._feat_start
                win = self._feat[s:s + self.window][None].to(
                    self.cfg.compute_dtype)
                ys, self.att_cache, self.cnn_cache = \
                    self.model.encoder.forward_chunk(
                        win, self._offset, self.att_cache, self.cnn_cache,
                        self.cat if self.cfg.lsl_enc else None)
                self._enc_chunks.append(ys[0])
                self._offset += ys.shape[1]
                self._consumed += self.stride
                # advance the incremental decoders over this hop's frames
                lp = ctc_logprobs(self.model.ctc, ys, 0.0, self.cfg.blank_id)
                self._inc_beam.accept(lp[0])
                self._inc_greedy.accept(lp[0].argmax(-1))
                ran = True
        if ran:
            # frames before the next window's first one are not read again
            drop = self._consumed - self._feat_start
            self._feat = self._feat[drop:]
            self._feat_start = self._consumed

    # ------------------------------ output ------------------------------

    def decode(self, mode: str = 'ctc_prefix_beam_search',
               beam_size: Optional[int] = None, ctc_weight: float = 0.1,
               reverse_weight: float = 0.0) -> DecodeResult:
        """The current hypothesis.  Greedy and the prefix beam read the
        carried decoders; attention_rescoring rescores the carried beam's
        nbest against the whole encoder output.  A beam_size other than the
        stream's decodes the stream's CTC log-probs from scratch (the
        dense prefix beam: kernels K2 and K3)."""
        if not self._enc_chunks:
            return DecodeResult(tokens=[])
        if mode == 'ctc_greedy_search':
            return self._inc_greedy.result()
        from_scratch = beam_size is not None and beam_size != self.beam_size
        if mode == 'ctc_prefix_beam_search' and not from_scratch:
            return self._inc_beam.finalize()
        if mode not in ('ctc_prefix_beam_search', 'attention_rescoring'):
            raise ValueError(f'unknown streaming decode mode {mode!r}')
        with torch.inference_mode():
            enc = torch.cat(self._enc_chunks)[None]
            lens = torch.tensor([enc.shape[1]], dtype=torch.int32,
                                device=self.device)
            if from_scratch:
                ctc_probs = ctc_logprobs(self.model.ctc, enc, 0.0,
                                         self.cfg.blank_id)
                prefix, raw = pb.ctc_prefix_beam_search_raw(
                    ctc_probs, lens, beam_size, self.cfg.blank_id)
                if mode == 'ctc_prefix_beam_search':
                    return prefix[0]
            else:
                raw = self._inc_beam.finalize_raw()
                prefix = pb._pack_results(*raw)
            return rs.attention_rescoring(self.model, prefix, enc, lens, raw,
                                          ctc_weight, reverse_weight,
                                          self.cat)[0]

    def text(self, **kwargs) -> str:
        res = self.decode(**kwargs)
        text, _ = self.asr.tokenizer.detokenize(res.tokens)
        return text
