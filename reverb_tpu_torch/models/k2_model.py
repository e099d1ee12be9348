"""The LF-MMI k2_model: an asr_model whose CTC term is the LF-MMI loss,
scored without k2 or icefall.

Counterpart of reverb_tpu/models/k2_model.py (`LfmmiResources`,
`lfmmi_ctc_loss_fn`, `MAX_BIGRAM_TOKENS`):
  - numerator = the CTC alignment sum of the transcript (the per-utterance
    CTC loss, optax's value also where no alignment exists:
    models/ctc.py:ctc_per_seq);
  - denominator = the forward score of the frame log-probs through a
    token-LM graph (ops/fsa.py): the bigram CTC-topology graph when
    `lfmmi_dir/bigram.txt` holds LM scores (small token sets), else the
    dense unigram recursion, which scales to a BPE vocabulary;
  - loss = Σ_b (den_b − num_b) / B.

`lfmmi_dir` holds tokens.txt ("symbol id"; the `<sos/eos>` row is
recorded and left out of the LM with the blank), optionally words.txt
("word id") and bigram.txt ("u v logprob" over token ids, natural log).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from reverb_tpu_torch.models.ctc import ctc_per_seq
from reverb_tpu_torch.ops import fsa
from reverb_tpu_torch.parallel import global_batch as gb

# above this many modelled tokens the O(K²)-arc bigram graph is refused
MAX_BIGRAM_TOKENS = 1024


class LfmmiResources:
    """The denominator graph and the symbol tables of an lfmmi_dir, on the
    host; `den_score_fn(device)` puts the graph on a device."""

    def __init__(self, lfmmi_dir: str, vocab_size: int, blank_id: int = 0):
        self.lfmmi_dir = lfmmi_dir
        self.vocab_size = vocab_size
        self.blank_id = blank_id
        self.sos_eos_id: Optional[int] = None
        self.token_table: Dict[str, int] = {}
        self.word_table: Dict[int, str] = {}
        tok_path = os.path.join(lfmmi_dir, 'tokens.txt')
        if os.path.exists(tok_path):
            with open(tok_path) as f:
                for line in f:
                    arr = line.strip().split()
                    if len(arr) != 2:
                        continue
                    self.token_table[arr[0]] = int(arr[1])
                    if arr[0] == '<sos/eos>':
                        self.sos_eos_id = int(arr[1])
        word_path = os.path.join(lfmmi_dir, 'words.txt')
        if os.path.exists(word_path):
            with open(word_path) as f:
                for line in f:
                    arr = line.strip().split()
                    if len(arr) == 2:
                        self.word_table[int(arr[1])] = arr[0]
        excluded = {blank_id}
        if self.sos_eos_id is not None:
            excluded.add(self.sos_eos_id)
        self.lm_tokens = np.array(
            [t for t in range(vocab_size) if t not in excluded], np.int32)
        self.bigram: Optional[np.ndarray] = None
        big_path = os.path.join(lfmmi_dir, 'bigram.txt')
        if os.path.exists(big_path):
            K = len(self.lm_tokens)
            if K > MAX_BIGRAM_TOKENS:
                raise ValueError(
                    f'bigram denominator graph needs O(K²) arcs; K={K} > '
                    f'{MAX_BIGRAM_TOKENS}. Use a phone/char token set or '
                    f'drop bigram.txt for the dense unigram denominator.')
            row = {int(t): i for i, t in enumerate(self.lm_tokens)}
            big = np.full((K, K), -np.log(K), np.float32)
            with open(big_path) as f:
                for line in f:
                    arr = line.strip().split()
                    if len(arr) != 3:
                        continue
                    u, v, lp = int(arr[0]), int(arr[1]), float(arr[2])
                    if u in row and v in row:
                        big[row[u], row[v]] = lp
            self.bigram = big
            self.arcs = fsa.bigram_den_arcs(big, blank_id,
                                            tokens=self.lm_tokens)
        else:
            uni = np.full((vocab_size,), fsa.NEG_INF, np.float32)
            uni[self.lm_tokens] = -np.log(len(self.lm_tokens))
            self.unigram = uni

    def den_score_fn(self, device):
        """(logp (B, T, V), t_len (B,)) → the denominator scores (B,)."""
        blank = self.blank_id
        if self.bigram is not None:
            src, dst, lab, wgt, S, fin = self.arcs
            src, dst, lab = (torch.as_tensor(a, dtype=torch.int64,
                                             device=device)
                             for a in (src, dst, lab))
            wgt, fin = (torch.as_tensor(a, device=device) for a in (wgt, fin))

            def score(logp, t_len):
                return fsa.fsa_forward_score(logp, t_len, src, dst, lab, wgt,
                                             S, fin)
        else:
            uni = torch.as_tensor(self.unigram, device=device)

            def score(logp, t_len):
                return fsa.dense_unigram_den_score(logp, t_len, uni, blank)
        return score


def lfmmi_ctc_loss_fn(resources: LfmmiResources):
    """The `ctc_loss_fn` of `compute_loss` (models/asr_model.py): (ctc
    head, encoder_out, encoder_out_lens, text, text_lens) → Σ(den − num)/B
    in place of the CTC loss."""
    scorers = {}

    def loss_fn(ctc, encoder_out, encoder_out_lens, text, text_lens):
        dev = encoder_out.device
        if dev not in scorers:
            scorers[dev] = resources.den_score_fn(dev)
        logits = ctc.ctc_lo(encoder_out)
        # f32 (JAX's), or wider for a wider model
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        B = logits.shape[0]
        L = text.shape[1]
        labels = torch.where(
            torch.arange(L, device=dev)[None, :] < text_lens[:, None], text,
            torch.zeros_like(text)).to(torch.int64)
        logp = torch.log_softmax(logits, -1)
        num_nll = ctc_per_seq(logp, encoder_out_lens, labels, text_lens,
                              resources.blank_id)
        den = scorers[dev](logp, encoder_out_lens)
        return (den + num_nll).sum() / gb.total(B)

    return loss_fn
