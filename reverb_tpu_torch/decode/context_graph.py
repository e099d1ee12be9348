"""Context biasing via an Aho-Corasick trie with fail arcs.

The port's copy of reverb_tpu/decode/context_graph.py (reference
asr/wenet/utils/context_graph.py): context phrases are tokenized into a trie;
during search each emitted token advances a per-hypothesis graph state
earning `context_score` per matched token, with fail-arc fallback and a
`finalize` backoff for partial matches.

Integration is in-beam (decode/prefix_beam.py): the prefix-beam scan (the
biased kernel K2b on the card, ops/beam_scan.py) carries a per-beam trie
state and cumulative bonus, using the dense (S, V) goto/score tables of
`device_tables()`, so biased phrases earn their +context_score per token
inside the beam and survive pruning.  `rescore_nbest` re-ranks an nbest
afterwards instead.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple


class ContextState:
    __slots__ = ('id', 'token', 'token_score', 'node_score',
                 'output_score', 'is_end', 'next', 'fail', 'output')

    def __init__(self, sid: int, token: int, token_score: float,
                 node_score: float, output_score: float, is_end: bool):
        self.id = sid
        self.token = token
        self.token_score = token_score
        self.node_score = node_score
        self.output_score = output_score
        self.is_end = is_end
        self.next: Dict[int, 'ContextState'] = {}
        self.fail: Optional['ContextState'] = None
        self.output: Optional['ContextState'] = None


class ContextGraph:
    def __init__(self, context_list_path: Optional[str] = None,
                 symbol_table: Optional[Dict[str, int]] = None,
                 bpe_model: Optional[str] = None,
                 context_score: float = 6.0,
                 context_list: Optional[List[str]] = None,
                 tokenizer=None):
        self.context_score = context_score
        self.num_nodes = 0
        self.root = ContextState(0, -1, 0.0, 0.0, 0.0, False)
        self.root.fail = self.root
        token_ids = self._tokenize(context_list_path, context_list,
                                   symbol_table, bpe_model, tokenizer)
        self.build(token_ids)

    def _tokenize(self, path, context_list, symbol_table, bpe_model,
                  tokenizer) -> List[List[int]]:
        """context_graph.py:24-57: phrases → token id lists."""
        phrases = list(context_list or [])
        if path:
            with open(path, encoding='utf8') as f:
                phrases += [ln.strip() for ln in f if ln.strip()]
        out = []
        for phrase in phrases:
            if tokenizer is not None:
                _, ids = tokenizer.tokenize(phrase)
            elif bpe_model is not None:
                from reverb_tpu_torch.text.sentencepiece_model import \
                    SentencePieceModel
                sp = SentencePieceModel(bpe_model)
                pieces = sp.encode(phrase, out_type=str)
                ids = [symbol_table[p] for p in pieces if p in symbol_table]
            else:
                assert symbol_table is not None
                ids = [symbol_table[ch] for ch in phrase.replace(' ', '▁')
                       if ch in symbol_table]
            if ids:
                out.append(ids)
        return out

    def build(self, token_ids: List[List[int]]):
        """Trie + BFS fail/output arcs — exact behavioral mirror of the
        reference build (context_graph.py:144-207), including its quirks:
        a node's `is_end`/`output_score` are fixed at CREATION time (a
        later-inserted shorter phrase ending on an existing interior node
        earns no completion bonus), and each node's `output_score`
        accumulates its output chain's score."""
        for ids in token_ids:
            node = self.root
            for i, tok in enumerate(ids):
                if tok not in node.next:
                    self.num_nodes += 1
                    is_end = i == len(ids) - 1
                    node_score = node.node_score + self.context_score
                    node.next[tok] = ContextState(
                        self.num_nodes, tok, self.context_score, node_score,
                        node_score if is_end else 0.0, is_end)
                node = node.next[tok]
        # fail + output arcs (BFS)
        queue = deque()
        for tok, node in self.root.next.items():
            node.fail = self.root
            queue.append(node)
        while queue:
            cur = queue.popleft()
            for tok, node in cur.next.items():
                fail = cur.fail
                if tok in fail.next:
                    fail = fail.next[tok]
                else:
                    fail = fail.fail
                    while tok not in fail.next:
                        fail = fail.fail
                        if fail.token == -1:
                            break
                    if tok in fail.next:
                        fail = fail.next[tok]
                node.fail = fail
                output = node.fail
                while not output.is_end:
                    output = output.fail
                    if output.token == -1:
                        output = None
                        break
                node.output = output
                node.output_score += 0 if output is None \
                    else output.output_score
                queue.append(node)

    def forward_one_step(self, state: ContextState, token: int
                         ) -> Tuple[float, ContextState]:
        """Returns (score delta, next state) — context_graph.py:209-246."""
        if token in state.next:
            node = state.next[token]
            score = node.token_score
        else:
            node = state.fail
            while token not in node.next:
                node = node.fail
                if node.token == -1:
                    break
            if token in node.next:
                node = node.next[token]
            score = node.node_score - state.node_score
        return score + node.output_score, node

    def finalize(self, state: ContextState) -> Tuple[float, ContextState]:
        """Implicit fail arc to root at sequence end: −node_score, always
        (context_graph.py:248-264)."""
        return -state.node_score, self.root

    # ----------------------- device tables -----------------------

    def device_tables(self, vocab_size: int):
        """Dense (S, V) goto/score tables for the in-beam device search.

        next_tab[s, u]  = Aho-Corasick goto(s, u) (child or fail-resolved)
        score_tab[s, u] = forward_one_step(s, u) score
                        = node_score[goto] − node_score[s]
                          + output_score[goto]   (identical on both branches:
                          a matched child's node_score − parent's == its
                          token_score)
        node_score[s]   : finalize backoff is −node_score[s].
        """
        import numpy as np
        S = self.num_nodes + 1
        nodes = [None] * S
        stack = [self.root]
        while stack:
            n = stack.pop()
            nodes[n.id] = n
            stack.extend(n.next.values())
        node_score = np.array([n.node_score for n in nodes], np.float32)
        out_score = np.array([n.output_score for n in nodes], np.float32)
        next_tab = np.zeros((S, vocab_size), np.int32)
        # BFS order guarantees fail(s) rows are filled before s
        order = deque([self.root])
        seen = []
        while order:
            n = order.popleft()
            seen.append(n)
            order.extend(n.next.values())
        for n in seen:
            if n is not self.root:
                next_tab[n.id] = next_tab[n.fail.id]
            for tok, child in n.next.items():
                if tok < vocab_size:
                    next_tab[n.id, tok] = child.id
        score_tab = (node_score[next_tab] - node_score[:, None]
                     + out_score[next_tab]).astype(np.float32)
        return next_tab, score_tab, node_score

    # ----------------------- nbest integration -----------------------

    def score_sequence(self, tokens: List[int]) -> float:
        state = self.root
        total = 0.0
        for tok in tokens:
            delta, state = self.forward_one_step(state, tok)
            total += delta
        backoff, _ = self.finalize(state)
        return total + backoff

    def rescore_nbest(self, results):
        """Re-rank each DecodeResult's nbest by adding context scores."""
        from reverb_tpu_torch.decode.results import DecodeResult
        out = []
        for res in results:
            if not res.nbest:
                out.append(res)
                continue
            scored = []
            for i, hyp in enumerate(res.nbest):
                bonus = self.score_sequence(hyp)
                scored.append((res.nbest_scores[i] + bonus, i))
            scored.sort(reverse=True)
            order = [i for _, i in scored]
            out.append(DecodeResult(
                tokens=res.nbest[order[0]],
                score=scored[0][0],
                times=res.nbest_times[order[0]] if res.nbest_times else None,
                nbest=[res.nbest[i] for i in order],
                nbest_scores=[s for s, _ in scored],
                nbest_times=[res.nbest_times[i] for i in order]
                if res.nbest_times else None))
        return out
