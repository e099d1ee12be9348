"""Hop-resumable CTC decoding for streaming serving.

Counterpart of reverb_tpu/decode/streaming_beam.py (`_apply_emit`,
`IncrementalBeam`, `_beam_finalize`, `IncrementalGreedy`).  A stream is
decoded hop by hop without going back to its first frame:

  - `BeamBank` carries B independent prefix beams (one per stream) and
    their materialized (K, L) prefix and time buffers on the device.  A hop
    is ONE launch of kernel K2 (ops/beam_scan.beam_scan_forward) over the
    hop's per-frame top-k, resumed from the carried beam state; the hop's
    backpointer records are then folded into the buffers frame by frame
    (`_apply_emit`, PyTorch ops on the device — the forward image of the
    backtrace K3 does after a whole-utterance scan, so K3 never runs here).
    A stream that is not ready this hop gets frames marked invalid: K2
    leaves its state as it was and its records fold as the identity, which
    is what the JAX pool's `keep` mask does.
  - `IncrementalBeam` is one stream's bank (B = 1) with the JAX class's
    API; `finalize` costs O(K·L): order the carried totals, slice the
    buffers.
  - `IncrementalGreedy` carries the previous frame's argmax across hops so
    the collapse (drop blanks and repeats) seams correctly.

Both equal the batch searches over the concatenated stream
(tests/test_torch_streaming.py).  The buffers grow as in the JAX package: a
host upper bound on the longest prefix grows by T_hop a hop, and only when
it nears the buffer length is the device's true maximum read.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from reverb_tpu_torch.decode.prefix_beam import (EMIT_KEYS, STATE_KEYS,
                                                 _init_state, _log_add,
                                                 _pack_results)
from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.ops.topk import topk_lastdim
from reverb_tpu_torch.utils.common import resolve_device


def _fold_indices(em, K: int, L: int):
    """The hop's records (T, B, K) → per-frame indices of the fold: the
    parent row of each prefix row; the (bank·K + beam) source row of each
    row of the two time banks, s rows first, then ns; the write positions
    of the prefix and of the ns bank (−1 → L, the spill column).  Source
    beams are clamped to [0, K), as the JAX package's gathers clamp."""
    def beam(n):
        return em[n].to(torch.int64).clamp(0, K - 1)

    def pos(n):
        p = em[n].to(torch.int64)
        return torch.where((p >= 0) & (p < L), p, torch.full_like(p, L))
    src = torch.cat([beam('s_src_beam') + K * em['s_src_is_ns'].to(torch.int64),
                     beam('ns_src_beam')
                     + K * em['ns_src_is_ns'].to(torch.int64)], -1)
    return beam('pfx_parent'), src, pos('pfx_wpos'), pos('ns_wpos')


def _apply_emit(pfx, banks, parent, src, pfx_pos, ns_pos, tok, wval):
    """Fold one frame's records into the buffers (reverb_tpu/decode/
    streaming_beam.py:_apply_emit).  pfx (B, K, L+1) tokens and banks
    (B, 2K, L+1) times (the s bank's K rows, then the ns bank's), column L
    a spill column for dropped writes; parent, pfx_pos, ns_pos, tok (B, K);
    src (B, 2K); wval (B,).  A prefix row is its parent's row plus at most
    one token; a time row is one old (beam, bank) row plus, in the ns bank,
    at most one time."""
    B, K, L1 = pfx.shape
    pfx = torch.gather(pfx, 1, parent[:, :, None].expand(B, K, L1))
    pfx.scatter_(2, pfx_pos[:, :, None], tok[:, :, None].to(pfx.dtype))
    banks = torch.gather(banks, 1, src[:, :, None].expand(B, 2 * K, L1))
    banks[:, K:].scatter_(2, ns_pos[:, :, None],
                          wval[:, None, None].expand(B, K, 1).to(banks.dtype))
    return pfx, banks


class BeamBank:
    """B hop-resumable CTC prefix beams of width K on one device (default
    cuda; raises without a card)."""

    def __init__(self, n_streams: int, beam_size: int, blank_id: int = 0,
                 init_len: int = 512, device='cuda'):
        self.B = int(n_streams)
        self.K = int(beam_size)
        self.blank_id = int(blank_id)
        self.init_len = int(init_len)
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        B, K, dev = self.B, self.K, self.device
        self.L = self.init_len
        self.state = _init_state(B, K, dev)
        self.pfx = torch.zeros((B, K, self.L + 1), dtype=torch.int32,
                               device=dev)
        self.banks = torch.zeros((B, 2 * K, self.L + 1), dtype=torch.int32,
                                 device=dev)
        self.offsets = np.zeros((B,), np.int64)   # frames accepted so far
        # host upper bound on each stream's longest prefix: it grows by
        # T_hop a hop and is reset to the device's true maximum only when
        # it nears L, so a hop reads nothing back on the common path
        self._plen_ub = np.zeros((B,), np.int64)
        self._plen_dev = None

    def reset_slot(self, b: int):
        """Stream b back to the empty prefix; the other streams untouched."""
        one = _init_state(1, self.K, self.device)
        with torch.inference_mode():
            for n in STATE_KEYS:
                self.state[n][b] = one[n][0]
            self.pfx[b] = 0
            self.banks[b] = 0
        self.offsets[b] = 0
        self._plen_ub[b] = 0

    def _grow(self, new_len: int):
        """Widen the buffers to new_len (+ the spill column, zeroed)."""
        pad = new_len - self.L
        self.pfx = torch.nn.functional.pad(self.pfx[:, :, :self.L],
                                           (0, pad + 1))
        self.banks = torch.nn.functional.pad(self.banks[:, :, :self.L],
                                             (0, pad + 1))
        self.L = new_len

    def hop(self, ctc_probs, ready=None):
        """Advance the ready streams by one hop of (B, T_hop, V) log-probs
        (per frame: top-K tokens, ties to the lower index, then one K2
        launch resumed from the carried state, then the fold).  `ready`
        (B,) bool, default all: a stream that is not ready keeps its state
        and buffers and does not advance its frame offset."""
        from reverb_tpu_torch.ops.beam_scan import beam_scan_forward
        B, K, dev = self.B, self.K, self.device
        T = int(ctc_probs.shape[1])
        ready = (np.ones((B,), bool) if ready is None
                 else np.asarray(ready, bool))
        if T == 0 or not ready.any():
            return
        if (self._plen_ub[ready] + T).max() >= self.L:
            # the bound is pessimistic (one token a frame): read the true
            # maximum before paying for a growth
            if self._plen_dev is not None:
                self._plen_ub = np.minimum(
                    self._plen_ub, self._plen_dev.cpu().numpy())
            need = int((self._plen_ub[ready] + T).max())
            if need >= self.L:
                self._grow(max(self.L * 2, need + 1))
        topk_logp, topk_idx = topk_lastdim(ctc_probs.to(torch.float32), K)
        offs = torch.from_numpy(self.offsets.astype(np.int32)).to(dev)
        ts = (offs[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=dev)[None]).contiguous()
        valid = torch.from_numpy(ready).to(dev)[:, None].expand(
            B, T).contiguous()
        final, em = beam_scan_forward(
            topk_logp.contiguous(), topk_idx.to(torch.int32).contiguous(),
            ts, valid, torch.zeros((B, T), dtype=torch.float32, device=dev),
            torch.zeros((B, T), dtype=torch.bool, device=dev), K,
            self.blank_id, self.state)
        parent, src, pfx_pos, ns_pos = _fold_indices(em, K, self.L)
        tok = em['pfx_tok']
        wval = em['wval']
        pfx, banks = self.pfx, self.banks
        for t in range(T):
            pfx, banks = _apply_emit(pfx, banks, parent[t], src[t],
                                     pfx_pos[t], ns_pos[t], tok[t], wval[t])
        self.pfx, self.banks = pfx, banks
        self.state = {n: final[n] for n in STATE_KEYS}
        self._plen_dev = final['plen'].amax(1)
        self.offsets[ready] += T
        self._plen_ub[ready] += T

    def finalize_raw(self, b: int):
        """Stream b's beam as the device tuple of a batch search, B = 1:
        (prefixes (1, K, L), plens (1, K), scores (1, K), times (1, K, L)),
        rows ordered by score, ties to the lower row
        (reverb_tpu/decode/streaming_beam.py:_beam_finalize)."""
        K, L = self.K, self.L
        st = {n: self.state[n][b] for n in STATE_KEYS}
        total = _log_add(st['s'], st['ns'])
        order = torch.argsort(-total, stable=True)
        sel_ns = (~(st['v_s'] > st['v_ns']))[order]
        prefixes = self.pfx[b, order, :L]
        times = torch.where(sel_ns[:, None], self.banks[b, K + order, :L],
                            self.banks[b, order, :L])
        return (prefixes[None], st['plen'][order][None], total[order][None],
                times[None])

    def finalize(self, b: int) -> DecodeResult:
        return _pack_results(*self.finalize_raw(b))[0]


class IncrementalBeam:
    """Hop-resumable CTC prefix beam over one stream.

    accept(ctc_probs_chunk): O(hop) — one K2 launch, the beam carried.
    finalize(): O(K·L) — the current nbest as a DecodeResult.
    The bank lives on `device` (default cuda; raises without a card)."""

    def __init__(self, beam_size: int, blank_id: int = 0,
                 init_len: int = 512, device='cuda'):
        self.bank = BeamBank(1, beam_size, blank_id, init_len, device)
        self.K = self.bank.K
        self.blank_id = self.bank.blank_id

    def reset(self):
        self.bank.reset()

    @property
    def offset(self) -> int:
        return int(self.bank.offsets[0])

    @property
    def L(self) -> int:
        return self.bank.L

    def accept(self, ctc_probs_chunk) -> None:
        """ctc_probs_chunk: (T_hop, V) log-probs on the bank's device."""
        self.bank.hop(ctc_probs_chunk[None])

    def finalize_raw(self):
        return self.bank.finalize_raw(0)

    def finalize(self) -> DecodeResult:
        return self.bank.finalize(0)


class IncrementalGreedy:
    """Hop-resumable CTC greedy collapse (drop blanks and repeats), seamed
    across hop boundaries by the previous frame's argmax."""

    def __init__(self, blank_id: int = 0):
        self.blank_id = int(blank_id)
        self.reset()

    def reset(self):
        self.tokens: List[int] = []
        self.times: List[int] = []
        self._prev = -1
        self.offset = 0

    def accept(self, top1_chunk) -> None:
        """top1_chunk: (T_hop,) per-frame argmax ids (host or device)."""
        ids = (top1_chunk.cpu().numpy() if torch.is_tensor(top1_chunk)
               else np.asarray(top1_chunk))
        prev = np.concatenate([[self._prev], ids[:-1]])
        keep = (ids != self.blank_id) & (ids != prev)
        tpos = np.nonzero(keep)[0]
        self.tokens.extend(int(t) for t in ids[tpos])
        self.times.extend(int(self.offset + p) for p in tpos)
        if len(ids):
            self._prev = int(ids[-1])
        self.offset += len(ids)

    def result(self) -> DecodeResult:
        return DecodeResult(tokens=list(self.tokens), times=list(self.times))
