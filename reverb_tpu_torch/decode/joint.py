"""Joint time-synchronous CTC+attention one-pass decoding: the dispatcher,
the host loop of lexicon-constrained runs, and the lexicon reader.

Counterpart of reverb_tpu/decode/joint.py (`TimeSyncBeamSearch`,
`load_lexicon`, `joint_decoding`).  Without a lexicon the search runs
batched on the device (decode/joint_device.py).  With one, the per-frame
CTC DP and the beam bookkeeping run on the host over dict-keyed prefixes,
as in the reference, because the lexicon filter is string logic; each new
prefix's attention scores come from one incremental decoder step
(`TransformerDecoder.forward_step`) on its parent's k‖v cache, memoized so
each prefix is scored once.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from reverb_tpu_torch.decode.results import DecodeResult

NEG = float('-inf')


def _log_add(vals):
    m = max(vals)
    if m == NEG:
        return NEG
    return m + math.log(sum(math.exp(v - m) for v in vals))


class CacheItem(NamedTuple):
    state: torch.Tensor   # decoder k‖v cache (n_layers, 1, max_len, 2D)
    scores: np.ndarray    # (V,) log-probs of the NEXT token after the prefix
    log_sum: float        # cumulative att log-prob of the prefix (post-sos)


class TimeSyncBeamSearch:
    def __init__(self, model, beam_size: int = 4, ctc_weight: float = 0.5,
                 length_bonus: float = 0.5, pre_beam_ratio: float = 2.0,
                 blank: int = 0, blank_threshold: float = 1.0,
                 words: Optional[Dict[str, int]] = None,
                 word_prefixes: Optional[Dict[str, int]] = None,
                 tok_to_str: Optional[Dict[int, str]] = None,
                 max_len: int = 512):
        self.model = model
        self.cfg = model.cfg
        self.dec = model.decoder.left_decoder
        self.beam_size = beam_size
        self.pre_beam_size = int(pre_beam_ratio * beam_size)
        self.ctc_weight = ctc_weight
        self.decoder_weight = 1.0 - ctc_weight
        self.penalty = length_bonus
        self.blank = blank
        self.blank_threshold = math.log(blank_threshold) if \
            blank_threshold < 1.0 else 0.0
        self.words = words or {}
        self.word_prefixes = word_prefixes or {}
        self.tok_to_str = tok_to_str or {}
        self.max_len = max_len

    # ------------------------------ decoder ------------------------------

    def _decoder_step(self, tokens: List[int], state):
        """Score the next token distribution after `tokens` (incl. sos):
        the decoder at position len − 1 on a copy of the parent's cache."""
        dev = self._enc.device
        logp, new_state = self.dec.forward_step(
            torch.tensor([tokens[-1]], device=dev),
            torch.tensor([len(tokens) - 1], device=dev), state.clone(),
            self._mem_kv, self._mask, 1, self._cat)
        return logp[0].cpu().numpy(), new_state

    def _cached_score(self, h: List[int]) -> float:
        """Memoized prefix scoring: the prefix's own log-prob plus its last
        token's under the parent."""
        root = h[:-1]
        key = str(root)
        if key not in self.cache:
            parent = self.cache[str(root[:-1])]
            scores, state = self._decoder_step(root, parent.state)
            log_sum = parent.log_sum + float(parent.scores[root[-1]])
            self.cache[key] = CacheItem(state, scores, log_sum)
        item = self.cache[key]
        return item.log_sum + float(item.scores[h[-1]])

    # ------------------------------ search ------------------------------

    def __call__(self, encoder_out, ctc_probs, cat_embs=None):
        """encoder_out (1, T, D) tensor; ctc_probs (T, V) log-probs
        (numpy).  Returns [(hyp, score, starts, ends, conf)], best first."""
        with torch.inference_mode():
            return self._search(encoder_out, np.asarray(ctc_probs), cat_embs)

    def _search(self, encoder_out, ctc_probs, cat_embs):
        self._enc = encoder_out
        self._mem_kv = self.dec.cross_kv(encoder_out)
        self._mask = torch.ones((1, 1, encoder_out.shape[1]), dtype=torch.bool,
                                device=encoder_out.device)
        self._cat = cat_embs
        sos = self.cfg.sos
        init_state = self.dec.init_cache(1, self.max_len, encoder_out.dtype,
                                         encoder_out.device)
        scores0, state0 = self._decoder_step([sos], init_state)
        self.cache = {str([sos]): CacheItem(state0, scores0, 0.0)}

        hyps = [[sos]]
        ctc_dp = {str([sos]): (NEG, 0.0)}     # (p_nb, p_b)
        times = {str([sos]): ([0], [0])}
        confs = {str([sos]): [(NEG, NEG)]}
        scores: Dict[str, float] = {}
        for t in range(ctc_probs.shape[0]):
            ctc_dp, hyps, scores = self._time_step(
                t, ctc_probs[t], ctc_dp, hyps, times, confs, scores)

        results = []
        for h in hyps:
            conf = [max(c[0], c[1]) for c in confs[str(h)]]
            results.append((h, scores.get(str(h), 0.0),
                            times[str(h)][0], times[str(h)][1], conf))
        return results

    def _time_step(self, t, p_ctc, ctc_dp, hyps, times, confs, scores):
        best = int(np.argmax(p_ctc))
        if best == self.blank and self.blank_threshold < 0 and \
                p_ctc[best] >= self.blank_threshold:
            return ctc_dp, hyps, scores
        pre_thresh = np.sort(p_ctc)[-min(self.pre_beam_size, p_ctc.shape[0])]
        cands = [int(c) for c in np.nonzero(p_ctc >= pre_thresh)[0]]
        if not cands:
            cands = [best]

        new_hyps: List[List[int]] = []
        dp_next: Dict[str, Tuple[float, float]] = {}
        for hyp in hyps:
            hk = str(hyp)
            p_prev = _log_add(list(ctc_dp[hk]))
            for c in cands:
                pc = float(p_ctc[c])
                if c == self.blank:
                    p_nb, p_b = dp_next.get(hk, (NEG, NEG))
                    dp_next[hk] = (p_nb, _log_add([p_b, pc + p_prev]))
                    if hyp not in new_hyps:
                        new_hyps.append(hyp)
                    continue
                l_plus = hyp + [c]
                lk = str(l_plus)
                p_nb, p_b = dp_next.get(lk, (NEG, NEG))
                if lk not in times:
                    times[lk] = (times[hk][0] + [t], times[hk][1] + [t + 1])
                else:
                    times[lk][1][-1] = t + 1
                if lk not in confs:
                    confs[lk] = confs[hk] + [(NEG, NEG)]
                confs[lk][-1] = (max(confs[lk][-1][0], pc), confs[lk][-1][1])
                if c == hyp[-1]:
                    p_nb_prev, p_b_prev = ctc_dp.get(hk, (NEG, NEG))
                    p_nb = _log_add([p_nb, pc + p_b_prev])
                    # the repeated-token path updates hyp's dp/times/confs
                    # but, as in the reference, does not re-add hyp to the
                    # beam: only the blank branch keeps a hypothesis alive
                    p_nb_l, p_b_l = dp_next.get(hk, (NEG, NEG))
                    dp_next[hk] = (_log_add([p_nb_l, pc + p_nb_prev]), p_b_l)
                    times[hk][1][-1] = t + 1
                    confs[hk][-1] = (max(confs[hk][-1][0], pc),
                                     confs[hk][-1][1])
                else:
                    p_nb = _log_add([p_nb, pc + p_prev])
                if l_plus not in hyps and lk in ctc_dp:
                    # resurrect scores from a previously-pruned prefix
                    p_b = _log_add([p_b, float(p_ctc[self.blank])
                                    + _log_add(list(ctc_dp[lk]))])
                    p_nb = _log_add([p_nb, pc + ctc_dp[lk][0]])
                dp_next[lk] = (p_nb, p_b)
                if l_plus not in new_hyps:
                    new_hyps.append(l_plus)

        good = self._lexicon_filter(new_hyps) if self.words else new_hyps
        if not good:
            good = new_hyps
        key_to_hyp = {str(h): h for h in good}
        scores = {}
        for h in good:
            hk = str(h)
            score = self.ctc_weight * _log_add(list(dp_next[hk]))
            if len(h) > 1 and self.decoder_weight > 0:
                score += self._cached_score(h) * self.decoder_weight
                root_item = self.cache[str(h[:-1])]
                confs[hk][-1] = (confs[hk][-1][0],
                                 float(root_item.scores[h[-1]]))
            score += self.penalty * (len(h) - 1)
            scores[hk] = score
        order = sorted(scores, key=scores.get, reverse=True)[:self.beam_size]
        hyps = [key_to_hyp[k] for k in order]
        return dp_next, hyps, scores

    def _lexicon_filter(self, hyps: List[List[int]]) -> List[List[int]]:
        """Keep prefixes whose last (partial) word is in the lexicon."""
        out = []
        start_char = '▁'
        for hyp in hyps:
            if len(hyp) == 1:
                out.append(hyp)
                continue
            last_tok = self.tok_to_str.get(hyp[-1], '')
            if last_tok.startswith(start_char):
                if len(hyp) == 2:
                    out.append(hyp)
                    continue
                start = 2
            else:
                start = 1
            last_word = ''
            for i in range(start, len(hyp)):
                sub = self.tok_to_str.get(hyp[-i], '')
                last_word = sub + last_word
                if sub.startswith(start_char):
                    break
            if last_tok.startswith(start_char):
                prev_tok = self.tok_to_str.get(hyp[-2], '')
                if prev_tok.endswith('-') or last_word in self.words:
                    out.append(hyp)
            elif last_word in self.word_prefixes:
                out.append(hyp)
        return out


@functools.lru_cache(maxsize=4)
def load_lexicon(lexicon_path: Optional[str], token_path: Optional[str]):
    """(words, word_prefixes, tok_to_str) from model_conf paths: lexicon
    lines 'word sw1 sw2 ...' give words[word] = 1 and every cumulative
    subword concatenation as a valid prefix; token file lines 'token id'
    give tok_to_str[id] = token."""
    words: Dict[str, int] = {}
    word_prefixes: Dict[str, int] = {}
    if lexicon_path:
        with open(lexicon_path) as f:
            for line in f:
                p = line.strip().split()
                if not p:
                    continue
                words[p[0]] = 1
                ws = ''
                for sw in p[1:]:
                    ws = ws + sw
                    word_prefixes[ws] = 1
    tok_to_str: Dict[int, str] = {}
    if token_path:
        with open(token_path) as f:
            for line in f:
                s = line.strip().split()
                if len(s) >= 2:
                    tok_to_str[int(s[1])] = s[0]
    return words, word_prefixes, tok_to_str


def joint_decoding(model, encoder_outs, encoder_lens, ctc_probs,
                   ctc_weight: float = 0.5, beam_size: int = 4,
                   pre_beam_ratio: float = 1.5, length_bonus: float = 0.5,
                   cat_embs=None, words=None, word_prefixes=None,
                   tok_to_str=None, blank_threshold: float = 1.0,
                   device: bool = True) -> List[DecodeResult]:
    """Per-utterance time-sync search: the batched device search, or the
    host loop when a lexicon constrains it (or `device` is False)."""
    cfg = model.cfg
    if words is None and (cfg.lexicon_path or cfg.token_path):
        words, word_prefixes, tok_to_str = load_lexicon(cfg.lexicon_path,
                                                        cfg.token_path)
    if device and not words:
        from reverb_tpu_torch.decode.joint_device import joint_decoding_device
        return joint_decoding_device(
            model, encoder_outs, encoder_lens, ctc_probs,
            ctc_weight=ctc_weight, beam_size=beam_size,
            pre_beam_ratio=pre_beam_ratio, length_bonus=length_bonus,
            blank_threshold=blank_threshold, cat_embs=cat_embs)
    lens = torch.as_tensor(encoder_lens).cpu().numpy()
    probs = ctc_probs.to(torch.float32).cpu().numpy()
    results = []
    for b in range(encoder_outs.shape[0]):
        T = int(lens[b])
        bs = TimeSyncBeamSearch(
            model, beam_size=beam_size, ctc_weight=ctc_weight,
            length_bonus=length_bonus, pre_beam_ratio=pre_beam_ratio,
            blank=cfg.blank_id, words=words, word_prefixes=word_prefixes,
            tok_to_str=tok_to_str, max_len=max(T + 2, 16))
        h, score, starts, _, conf = bs(encoder_outs[b:b + 1, :T],
                                       probs[b, :T], cat_embs=cat_embs)[0]
        results.append(DecodeResult(
            tokens=h[1:], score=float(score), times=starts[1:],
            tokens_confidence=[math.exp(c) if c > NEG else 0.0
                               for c in conf[1:]]))
    return results
