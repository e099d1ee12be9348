"""HLG (lexicon/grammar-constrained) CTC decoding without k2.

The port's own copy of reverb_tpu/decode/hlg.py: the numpy `Fst` (OpenFST
text format, weights negated to log-probs), `lexicon_graph` (L∘G as a word
trie with a unigram word loop) and the host token-passing Viterbi beam
`_decode_utt` over (graph state, last emitted token), with `hlg_onebest`
and `hlg_rescore` on the port's decoder
(tot = am + lm_scale·lm + decoder_scale·att + r_decoder_scale·r_att).
The CTC log-probs come to the host in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reverb_tpu_torch.decode.results import DecodeResult

EPS = 0  # OpenFST epsilon input label; token arcs carry token_id + 1


@dataclasses.dataclass
class Fst:
    """Minimal weighted FST: arcs[src] = [(dst, ilabel, olabel, weight)].

    Weights are log-probs (higher = better), i.e. negated tropical weights
    relative to OpenFST text files (the loader negates).
    """
    arcs: Dict[int, List[Tuple[int, int, int, float]]]
    final: Dict[int, float]
    start: int = 0

    @staticmethod
    def from_text(text: str) -> 'Fst':
        arcs: Dict[int, List[Tuple[int, int, int, float]]] = {}
        final: Dict[int, float] = {}
        start = None
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                s, d, i, o = (int(parts[0]), int(parts[1]), int(parts[2]),
                              int(parts[3]))
                w = -float(parts[4]) if len(parts) > 4 else 0.0
                arcs.setdefault(s, []).append((d, i, o, w))
                if start is None:
                    start = s
            else:
                s = int(parts[0])
                w = -float(parts[1]) if len(parts) > 1 else 0.0
                final[s] = w
                if start is None:
                    start = s
        return Fst(arcs=arcs, final=final, start=start or 0)

    @staticmethod
    def load(path: str) -> 'Fst':
        with open(path) as f:
            return Fst.from_text(f.read())


def lexicon_graph(lexicon: Dict[str, Sequence[int]],
                  word_scores: Optional[Dict[str, float]] = None,
                  word_ids: Optional[Dict[str, int]] = None) -> Fst:
    """Build L∘G directly: a token trie per word, word olabel on the last
    token arc, epsilon back-arc to the root (unigram word-loop grammar).

    lexicon: word → token-id sequence.  word_scores: log-prob grammar scores
    (default 0).  Returns an Fst whose input labels are token_id + 1.
    """
    word_scores = word_scores or {}
    if word_ids is None:
        word_ids = {w: i + 1 for i, w in enumerate(sorted(lexicon))}
    arcs: Dict[int, List[Tuple[int, int, int, float]]] = {0: []}
    nxt = 1
    trie: Dict[Tuple[int, int], int] = {}
    for word, toks in lexicon.items():
        assert len(toks) > 0, word
        state = 0
        for j, t in enumerate(toks):
            last = j == len(toks) - 1
            ilab = int(t) + 1
            if last:
                arcs.setdefault(state, []).append(
                    (0, ilab, word_ids[word],
                     float(word_scores.get(word, 0.0))))
            else:
                key = (state, ilab)
                if key not in trie:
                    trie[key] = nxt
                    arcs.setdefault(state, []).append((nxt, ilab, EPS, 0.0))
                    arcs.setdefault(nxt, [])
                    nxt += 1
                state = trie[key]
    return Fst(arcs=arcs, final={0: 0.0}, start=0)


@dataclasses.dataclass
class _Tok:
    """One token-passing hypothesis."""
    score: float            # am + lm
    am: float
    lm: float
    state: int              # graph state
    last: int               # last emitted CTC token (-1 = blank/none)
    tokens: Tuple[int, ...]  # emitted CTC tokens (dedup'd, no blank)
    words: Tuple[int, ...]   # emitted word olabels
    times: Tuple[int, ...]   # emission frames


def _eps_closure(tok: _Tok, graph: Fst, out: Dict, k: int) -> None:
    """Follow epsilon-input arcs (emit olabels, add graph weights).

    out maps (state, last) → up to k best _Toks with distinct token
    histories (per-state k-best keeps alternatives alive through blank
    stretches — the lattice property Viterbi alone loses)."""
    stack = [tok]
    while stack:
        t = stack.pop()
        key = (t.state, t.last)
        lst = out.setdefault(key, [])
        dup = next((i for i, o in enumerate(lst) if o.tokens == t.tokens
                    and o.words == t.words), None)
        if dup is not None:
            if lst[dup].score >= t.score:
                continue
            lst.pop(dup)
        elif len(lst) >= k and lst[-1].score >= t.score:
            continue
        lst.append(t)
        lst.sort(key=lambda o: -o.score)
        del lst[k:]
        for (dst, il, ol, w) in graph.arcs.get(t.state, ()):  # noqa: B007
            if il == EPS:
                stack.append(_Tok(t.score + w, t.am, t.lm + w, dst, t.last,
                                  t.tokens,
                                  t.words + ((ol,) if ol != EPS else ()),
                                  t.times))


def _decode_utt(logp: np.ndarray, graph: Fst, blank_id: int,
                beam: float, max_active: int, nbest: int) -> List[_Tok]:
    """Frame-synchronous token-passing beam over (graph state, last token)."""
    T, V = logp.shape
    k = max(1, nbest)
    active: Dict[Tuple[int, int], List[_Tok]] = {}
    _eps_closure(_Tok(0.0, 0.0, 0.0, graph.start, -1, (), (), ()), graph,
                 active, k)
    for t in range(T):
        frame = logp[t]
        nxt: Dict[Tuple[int, int], List[_Tok]] = {}

        def offer(tok: _Tok):
            _eps_closure(tok, graph, nxt, k)

        for tok in (x for lst in active.values() for x in lst):
            # blank: stay in graph state, reset last
            offer(_Tok(tok.score + frame[blank_id], tok.am + frame[blank_id],
                       tok.lm, tok.state, -1, tok.tokens, tok.words,
                       tok.times))
            # repeat of last non-blank token: no graph move
            if tok.last >= 0:
                offer(_Tok(tok.score + frame[tok.last],
                           tok.am + frame[tok.last], tok.lm, tok.state,
                           tok.last, tok.tokens, tok.words, tok.times))
            # advance a token arc (CTC: a new emission; same token twice in a
            # row requires an intervening blank, enforced by il != last+1)
            for (dst, il, ol, w) in graph.arcs.get(tok.state, ()):
                if il == EPS:
                    continue
                u = il - 1
                if u == tok.last:
                    continue   # same-token repeat handled above (no re-entry)
                offer(_Tok(tok.score + frame[u] + w, tok.am + frame[u],
                           tok.lm + w, dst, u, tok.tokens + (u,),
                           tok.words + ((ol,) if ol != EPS else ()),
                           tok.times + (t,)))
        if not nxt:
            break
        flat = [x for lst in nxt.values() for x in lst]
        best = max(tok.score for tok in flat)
        pruned = [tok for tok in flat if tok.score >= best - beam]
        pruned.sort(key=lambda tok: -tok.score)
        active = {}
        for tok in pruned[:max_active * k]:
            active.setdefault((tok.state, tok.last), []).append(tok)

    finals = []
    for tok in (x for lst in active.values() for x in lst):
        if tok.state in graph.final:
            w = graph.final[tok.state]
            finals.append(dataclasses.replace(tok, score=tok.score + w,
                                              lm=tok.lm + w))
    if not finals:                      # no reachable final: best-effort
        finals = list(active.values())
    finals.sort(key=lambda tok: -tok.score)
    # dedup identical word sequences (Viterbi already dedups state-wise)
    seen, out = set(), []
    for tok in finals:
        if tok.words in seen:
            continue
        seen.add(tok.words)
        out.append(tok)
        if len(out) >= nbest:
            break
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def hlg_onebest(ctc_probs, ctc_lens, graph: Fst, blank_id: int = 0,
                beam: float = 16.0, max_active: int = 200
                ) -> List[DecodeResult]:
    """One-best under the graph.  DecodeResult.tokens holds WORD ids; the
    CTC token ids and their emission frames ride in .nbest/.times."""
    ctc_probs, ctc_lens = _host(ctc_probs), _host(ctc_lens)
    out = []
    for b in range(ctc_probs.shape[0]):
        best = _decode_utt(ctc_probs[b, :int(ctc_lens[b])], graph, blank_id,
                           beam, max_active, nbest=1)[0]
        out.append(DecodeResult(tokens=list(best.words), score=best.score,
                                times=list(best.times),
                                nbest=[list(best.tokens)]))
    return out


def hlg_rescore(model, ctc_probs, ctc_lens, encoder_out, encoder_lens,
                graph: Fst, blank_id: int = 0, lm_scale: float = 0.0,
                decoder_scale: float = 0.0, r_decoder_scale: float = 0.0,
                beam: float = 16.0, max_active: int = 200, nbest: int = 10,
                cat_embs=None) -> List[DecodeResult]:
    """N-best under the graph, rescored by the attention decoder; the
    argmax of tot over the n-best."""
    from reverb_tpu_torch.decode.rescoring import score_hyps_with_decoder
    ctc_probs, ctc_lens = _host(ctc_probs), _host(ctc_lens)
    encoder_lens = torch.as_tensor(encoder_lens)
    out = []
    for b in range(ctc_probs.shape[0]):
        cands = _decode_utt(ctc_probs[b, :int(ctc_lens[b])], graph, blank_id,
                            beam, max_active, nbest=nbest)
        att, r_att = score_hyps_with_decoder(
            model, [list(c.tokens) for c in cands], encoder_out[b:b + 1],
            encoder_lens[b:b + 1], cat_embs=cat_embs)
        tots = [c.am + lm_scale * c.lm + decoder_scale * att[i]
                + r_decoder_scale * r_att[i] for i, c in enumerate(cands)]
        i = int(np.argmax(tots))
        out.append(DecodeResult(tokens=list(cands[i].words),
                                score=float(tots[i]),
                                times=list(cands[i].times),
                                nbest=[list(c.tokens) for c in cands]))
    return out
