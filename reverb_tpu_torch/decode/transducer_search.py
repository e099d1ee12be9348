"""ESPnet-style transducer search algorithms (default/TSD/ALSD/NSC/mAES).

Counterpart of reverb_tpu/decode/transducer_search.py (`Hyp`,
`_PredCache`, `_FrameLogp`, `_merge`, `_topk`, `_prefix_search` and the
five algorithms of `_ALGOS`, dispatched by `beam_search_transducer`):

  - default: Graves 2012 breadth-first beam with prefix recombination
  - tsd:  time-synchronous decoding, ≤ max_sym_exp symbols per frame
  - alsd: alignment-length synchronous decoding, U_max = u_max_ratio·T
  - nsc:  N-step constrained beam search with prefix-alpha recombination
  - maes: modified adaptive expansion search

The hypothesis sets and their bookkeeping stay on the host, in the JAX
package's code order (Python's stable sorts on the same keys, so tied
hypotheses come out in the same order).  The prediction network and the
joint run on the model's device: `_PredCache.prefetch` evaluates every
missing prefix of a wave in one padded `Predictor` call, and each wave's
joint is one batched call whose log-probs come back to the host once.
`search_type='tsd'` runs the batched device TSD
(decode/transducer_device.py); 'tsd_host' keeps the host loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.models.transducer import Joint, Predictor


@dataclasses.dataclass
class Hyp:
    score: float
    ys: Tuple[int, ...]                 # label prefix, no blanks


class _PredCache:
    """Predictor outputs memoized by label prefix; all missing prefixes of
    a wave in one padded batched call."""

    def __init__(self, predictor: Predictor, blank: int, device):
        self.predictor = predictor
        self.blank = blank
        self.device = device
        self.cache: Dict[Tuple[int, ...], np.ndarray] = {}

    @torch.no_grad()
    def prefetch(self, prefixes: List[Tuple[int, ...]]):
        todo = sorted({p for p in prefixes if p not in self.cache}, key=len)
        if not todo:
            return
        U = max(len(p) for p in todo) + 1
        ys = np.full((len(todo), U), self.blank, np.int64)
        for i, p in enumerate(todo):
            ys[i, 1:1 + len(p)] = p
        out = self.predictor(torch.from_numpy(ys).to(self.device))
        out = out.float().cpu().numpy()
        for i, p in enumerate(todo):
            self.cache[p] = out[i, len(p)]

    def get(self, prefix: Tuple[int, ...]) -> np.ndarray:
        if prefix not in self.cache:
            self.prefetch([prefix])
        return self.cache[prefix]


@torch.no_grad()
def _joint_logp(joint: Joint, enc_rows: np.ndarray, preds: np.ndarray,
                device):
    """Batched joint log-probs: enc_rows (D,) or (N, D) × preds (N, E) →
    (N, V) on the host (one call for N hypotheses; ALSD's sit at different
    frames, so their encoder rows ride along)."""
    enc = torch.from_numpy(np.ascontiguousarray(enc_rows)).to(device)
    if enc.dim() == 1:
        enc = enc[None]
    logits = joint(enc, torch.from_numpy(preds).to(device))
    return torch.log_softmax(logits.float(), -1).cpu().numpy()


class _FrameLogp:
    """Per-frame joint log-prob memo over label prefixes, filled in
    batched waves: `ensure` evaluates every missing prefix of the wave in
    one predictor prefetch and one joint call."""

    def __init__(self, joint: Joint, cache: _PredCache, enc_t: np.ndarray):
        self.joint, self.cache, self.enc_t = joint, cache, enc_t
        self.memo: Dict[Tuple[int, ...], np.ndarray] = {}

    def ensure(self, prefixes: List[Tuple[int, ...]]):
        todo = [p for p in dict.fromkeys(prefixes) if p not in self.memo]
        if not todo:
            return
        self.cache.prefetch(todo)
        preds = np.stack([self.cache.get(p) for p in todo])
        logp = _joint_logp(self.joint, self.enc_t, preds, self.cache.device)
        for i, p in enumerate(todo):
            self.memo[p] = logp[i]

    def get(self, prefix: Tuple[int, ...]) -> np.ndarray:
        if prefix not in self.memo:
            self.ensure([prefix])
        return self.memo[prefix]


def _merge(hyps: List[Hyp]) -> List[Hyp]:
    """Recombine identical prefixes with log-add."""
    merged: Dict[Tuple[int, ...], float] = {}
    for h in hyps:
        merged[h.ys] = float(np.logaddexp(merged[h.ys], h.score)) \
            if h.ys in merged else h.score
    return [Hyp(score=s, ys=y) for y, s in merged.items()]


def _topk(hyps: List[Hyp], k: int) -> List[Hyp]:
    return sorted(hyps, key=lambda h: -h.score)[:k]


def _best_first(hyps: List[Hyp]) -> List[Hyp]:
    return sorted(hyps, key=lambda h: -h.score / max(len(h.ys), 1))


def _wave_logp(joint, cache: _PredCache, hyps: List[Hyp], enc_t):
    cache.prefetch([h.ys for h in hyps])
    preds = np.stack([cache.get(h.ys) for h in hyps])
    return _joint_logp(joint, enc_t, preds, cache.device)


def _prefix_search(hyps: List[Hyp], cache: _PredCache, joint: Joint,
                   enc_t: np.ndarray, prefix_alpha: int) -> List[Hyp]:
    """Fold the mass of a shorter hypothesis into each hypothesis it
    prefixes (length gap ≤ prefix_alpha) by chaining label emissions along
    frame t; every prefix any chain touches in one batched joint call."""
    out = [Hyp(h.score, h.ys) for h in hyps]
    pairs = []
    need: List[Tuple[int, ...]] = []
    for hj in out:
        for hi in out:
            ln_i, ln_j = len(hi.ys), len(hj.ys)
            if not (ln_i < ln_j <= ln_i + prefix_alpha
                    and hj.ys[:ln_i] == hi.ys):
                continue
            pairs.append((hj, hi))
            need.append(hi.ys)
            need.extend(hj.ys[:k] for k in range(ln_i + 1, ln_j))
    if not pairs:
        return out
    flp = _FrameLogp(joint, cache, enc_t)
    flp.ensure(need)
    for hj, hi in pairs:
        ln_i, ln_j = len(hi.ys), len(hj.ys)
        curr = hi.score + flp.get(hi.ys)[hj.ys[ln_i]]
        for k in range(ln_i + 1, ln_j):
            curr += flp.get(hj.ys[:k])[hj.ys[k]]
        hj.score = float(np.logaddexp(hj.score, curr))
    return out


def default_beam_search(predictor, joint, enc: np.ndarray, blank: int,
                        vocab_size: int, device, beam_size: int = 4,
                        score_norm: bool = True,
                        max_expansions_per_frame: int = 0) -> List[Hyp]:
    """Graves 2012 on one utterance; max_expansions_per_frame (default
    40·beam) bounds the loop on a joint whose labels beat blank."""
    cache = _PredCache(predictor, blank, device)
    beam_k = min(beam_size, vocab_size - 1)
    cap = max_expansions_per_frame or 40 * beam_size
    kept = [Hyp(score=0.0, ys=())]
    for t in range(enc.shape[0]):
        hyps = _merge(kept)
        kept = []
        flp = _FrameLogp(joint, cache, enc[t])
        for _ in range(cap):
            max_hyp = max(hyps, key=lambda h: h.score)
            hyps.remove(max_hyp)
            if max_hyp.ys not in flp.memo:
                # every queued hypothesis is a likely pop this frame: one
                # joint call for all of them
                flp.ensure([max_hyp.ys] + [h.ys for h in hyps])
            logp = flp.get(max_hyp.ys)
            kept.append(Hyp(max_hyp.score + float(logp[blank]), max_hyp.ys))
            order = np.argsort(logp)[::-1]
            added = 0
            for u in order:
                if u == blank:
                    continue
                hyps.append(Hyp(max_hyp.score + float(logp[u]),
                                max_hyp.ys + (int(u),)))
                added += 1
                if added >= beam_k:
                    break
            kept = _merge(kept)
            if len(kept) >= beam_size:
                kept_best = _topk(kept, beam_size)
                if max(h.score for h in hyps) < kept_best[-1].score:
                    break
        kept = _topk(kept, beam_size)
    if score_norm:
        return _best_first(kept)
    return _topk(kept, beam_size)


def time_sync_decoding(predictor, joint, enc: np.ndarray, blank: int,
                       vocab_size: int, device, beam_size: int = 4,
                       max_sym_exp: int = 2) -> List[Hyp]:
    """TSD: at each frame at most max_sym_exp label expansions before the
    frame is consumed."""
    cache = _PredCache(predictor, blank, device)
    B = [Hyp(score=0.0, ys=())]
    for t in range(enc.shape[0]):
        A: Dict[Tuple[int, ...], float] = {}
        C = B
        for v in range(max_sym_exp):
            logp = _wave_logp(joint, cache, C, enc[t])           # (N, V)
            D: List[Hyp] = []
            for n, h in enumerate(C):
                s = h.score + float(logp[n, blank])
                A[h.ys] = float(np.logaddexp(A[h.ys], s)) if h.ys in A else s
                if v < max_sym_exp - 1:
                    for u in np.argsort(logp[n])[::-1][:beam_size + 1]:
                        if u == blank:
                            continue
                        D.append(Hyp(h.score + float(logp[n, u]),
                                     h.ys + (int(u),)))
            C = _topk(_merge(D), beam_size)
            if not C:
                break
        B = _topk([Hyp(s, y) for y, s in A.items()], beam_size)
    return _best_first(B)


def align_length_sync_decoding(predictor, joint, enc: np.ndarray,
                               blank: int, vocab_size: int, device,
                               beam_size: int = 4,
                               u_max_ratio: float = 0.5) -> List[Hyp]:
    """ALSD: hypotheses synchronized by alignment length n = t + u."""
    T = enc.shape[0]
    u_max = max(1, int(u_max_ratio * T))
    cache = _PredCache(predictor, blank, device)
    B = [Hyp(score=0.0, ys=())]
    final: List[Hyp] = []
    for n in range(T + u_max):
        A: List[Hyp] = []
        batch = [(h, n - len(h.ys)) for h in B if 0 <= n - len(h.ys) < T]
        if not batch:
            break
        cache.prefetch([h.ys for h, _ in batch])
        enc_rows = np.stack([enc[t] for _, t in batch])
        preds = np.stack([cache.get(h.ys) for h, _ in batch])
        logp_all = _joint_logp(joint, enc_rows, preds, device)
        for (h, t), logp in zip(batch, logp_all):
            nh = Hyp(h.score + float(logp[blank]), h.ys)
            A.append(nh)
            if t == T - 1:
                final.append(nh)
            if len(h.ys) < u_max:
                for u in np.argsort(logp)[::-1][:beam_size + 1]:
                    if u == blank:
                        continue
                    A.append(Hyp(h.score + float(logp[u]),
                                 h.ys + (int(u),)))
        B = _topk(_merge(A), beam_size)
    final = _merge(final) or B
    return _best_first(final)


def nsc_beam_search(predictor, joint, enc: np.ndarray, blank: int,
                    vocab_size: int, device, beam_size: int = 4,
                    nstep: int = 2, prefix_alpha: int = 2) -> List[Hyp]:
    """N-step constrained search: per frame, prefix-alpha recombination,
    then at most nstep constrained label expansions."""
    cache = _PredCache(predictor, blank, device)
    beam_k = min(beam_size, vocab_size - 1)
    B = [Hyp(score=0.0, ys=())]
    for t in range(enc.shape[0]):
        B = _prefix_search(sorted(B, key=lambda h: len(h.ys)), cache,
                           joint, enc[t], prefix_alpha)
        S: Dict[Tuple[int, ...], float] = {}
        C = B
        for v in range(nstep):
            logp = _wave_logp(joint, cache, C, enc[t])
            D: List[Hyp] = []
            for n, h in enumerate(C):
                s = h.score + float(logp[n, blank])
                S[h.ys] = float(np.logaddexp(S[h.ys], s)) if h.ys in S else s
                if v < nstep - 1:
                    for u in np.argsort(logp[n])[::-1][:beam_k + 1]:
                        if u == blank:
                            continue
                        D.append(Hyp(h.score + float(logp[n, u]),
                                     h.ys + (int(u),)))
            C = _topk(_merge(D), beam_size)
            if not C:
                break
        B = _topk([Hyp(s, y) for y, s in S.items()], beam_size)
    return _best_first(B)


def modified_adaptive_expansion_search(predictor, joint, enc: np.ndarray,
                                       blank: int, vocab_size: int, device,
                                       beam_size: int = 4,
                                       expansion_gamma: float = 2.3,
                                       expansion_beta: int = 2,
                                       nstep: int = 2) -> List[Hyp]:
    """mAES: like NSC, but each step keeps only the candidates within
    expansion_gamma of the step's best, at most beam_size +
    expansion_beta of them."""
    cache = _PredCache(predictor, blank, device)
    k_exp = beam_size + expansion_beta
    B = [Hyp(score=0.0, ys=())]
    for t in range(enc.shape[0]):
        S: Dict[Tuple[int, ...], float] = {}
        C = B
        for v in range(nstep):
            logp = _wave_logp(joint, cache, C, enc[t])
            cand: List[Tuple[float, Hyp, int]] = []
            for n, h in enumerate(C):
                for u in np.argsort(logp[n])[::-1][:k_exp]:
                    cand.append((h.score + float(logp[n, u]), h, int(u)))
            if not cand:
                break
            best = max(c[0] for c in cand)
            cand = [c for c in cand if c[0] >= best - expansion_gamma]
            cand = sorted(cand, key=lambda c: -c[0])[:k_exp]
            D: List[Hyp] = []
            for s, h, u in cand:
                if u == blank:
                    S[h.ys] = float(np.logaddexp(S[h.ys], s)) \
                        if h.ys in S else s
                elif v < nstep - 1:
                    D.append(Hyp(s, h.ys + (u,)))
            C = _topk(_merge(D), beam_size)
            if not C:
                break
        if not S:       # all expansions were labels on the last step
            # (and with none left either, the beam the frame started
            # from: the JAX package's beam empties there, and its next
            # frame fails on the empty wave)
            S = {h.ys: h.score for h in (C or B)}
        B = _topk([Hyp(s, y) for y, s in S.items()], beam_size)
    return _best_first(B)


_ALGOS = {
    'default': default_beam_search,
    'tsd': time_sync_decoding,
    'alsd': align_length_sync_decoding,
    'nsc': nsc_beam_search,
    'maes': modified_adaptive_expansion_search,
}


def beam_search_transducer(predictor: Predictor, joint: Joint, encoder_out,
                           encoder_lens, search_type: str = 'default',
                           beam_size: int = 4, nbest: int = 1,
                           **kwargs) -> List[List[DecodeResult]]:
    """The batch dispatcher: nbest DecodeResults per utterance of
    encoder_out (B, T, D) on the model's device.  'tsd' is the batched
    device search (decode/transducer_device.py), 'tsd_host' the host
    loop; an unknown search type raises ValueError."""
    if search_type == 'tsd_host':
        search_type, kwargs = 'tsd', dict(kwargs, _host=True)
    if search_type not in _ALGOS:
        raise ValueError(f'unknown transducer search {search_type!r}; '
                         f'choose from {sorted(_ALGOS)} (+ tsd_host)')
    cfg = predictor.cfg
    lens = np.asarray(torch.as_tensor(encoder_lens).cpu())
    if search_type == 'tsd' and not kwargs.pop('_host', False):
        from reverb_tpu_torch.decode.transducer_device import tsd_device_host
        hyp_lists = tsd_device_host(
            predictor, joint, encoder_out, torch.as_tensor(lens),
            beam_size=beam_size, max_sym_exp=kwargs.get('max_sym_exp', 2))
        return [[DecodeResult(tokens=list(y), score=s)
                 for y, s in hyps[:nbest]] for hyps in hyp_lists]
    algo = _ALGOS[search_type]
    enc = encoder_out.float().cpu().numpy()
    out: List[List[DecodeResult]] = []
    for b in range(enc.shape[0]):
        hyps = algo(predictor, joint, enc[b, :int(lens[b])], cfg.blank_id,
                    cfg.vocab_size, encoder_out.device, beam_size=beam_size,
                    **kwargs)
        out.append([DecodeResult(tokens=list(h.ys), score=h.score)
                    for h in hyps[:nbest]])
    return out
