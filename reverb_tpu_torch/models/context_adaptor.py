"""Context adaptor: the deep-biasing module of training.

Counterpart of reverb_tpu/models/context_adaptor.py (`ContextAdaptorConfig`,
`init_context_adaptor`, `encode_cv`, `combine_layers`,
`context_adaptor_forward`).  The context phrases are encoded by a stacked
bidirectional LSTM (the final hidden state of each direction, with a
learned blank term prepended); the encoder's layer mix
0.5·L[-1] + 0.25·L[-9] + 0.25·L[-15] cross-attends to them with one head,
and frames whose attention argmax picks the blank term get no bias.  The
result is added to the encoder output (`asr_model.compute_loss`).

The LSTM keeps the JAX tree's parameters as they are, {w_ih, w_hh, b} with
one bias (nn.LSTM's two biases would each take an Adam step and count twice
in the clip norm), so the adaptor's state-dict keys are the tree's
(`context_adaptor.lstm.{i}.{fwd,bwd}.{w_ih,w_hh,b}`).  The backward
direction reverses only each phrase's valid tokens (packed-sequence
semantics).  No kernel: the phrase encoder and the one-head attention are
plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch
from torch import nn

from reverb_tpu_torch.models.attention import MultiHeadedAttention
from reverb_tpu_torch.models.modules import Embedding
from reverb_tpu_torch.utils.common import reverse_sequence


@dataclasses.dataclass(frozen=True)
class ContextAdaptorConfig:
    vocab_size: int = 5000
    output_size: int = 512
    embedding_dim: int = 128
    num_layers: int = 2
    attention_heads: int = 1


class LSTMLayer(nn.Module):
    """One LSTM direction, batch first, with the JAX package's parameters
    (reverb_tpu/diar/models.py:init_lstm, lstm_forward): gates i, f, g, o;
    weights uniform in ±1/sqrt(hidden), the bias zero."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.w_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))

    def reset_parameters(self, g):
        bound = 1.0 / math.sqrt(self.w_hh.shape[1])
        with torch.no_grad():
            self.w_ih.uniform_(-bound, bound, generator=g)
            self.w_hh.uniform_(-bound, bound, generator=g)
            self.b.zero_()

    def forward(self, x):
        """x (B, T, D) → every step's hidden state (B, T, H), from zeros."""
        B, T, _ = x.shape
        H = self.w_hh.shape[1]
        xw = x @ self.w_ih.t() + self.b
        h = x.new_zeros((B, H))
        c = x.new_zeros((B, H))
        out = []
        for t in range(T):
            i, f, gg, o = (xw[:, t] + h @ self.w_hh.t()).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, 1) if out else x.new_zeros((B, 0, H))


def combine_layers(layer_outs: List[torch.Tensor]) -> torch.Tensor:
    """0.5·L[-1] + 0.25·L[-9] + 0.25·L[-15]; shallow encoders take
    L[n // 2 − 1] and L[0] in place of the missing layers."""
    n = len(layer_outs)
    a = layer_outs[-1]
    b = layer_outs[-9] if n >= 9 else layer_outs[max(n // 2 - 1, 0)]
    c = layer_outs[-15] if n >= 15 else layer_outs[0]
    return 0.5 * a + 0.25 * b + 0.25 * c


class ContextAdaptor(nn.Module):
    def __init__(self, cfg: ContextAdaptorConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.output_size // 2
        self.embed = Embedding(cfg.vocab_size + 1, cfg.embedding_dim)
        dims = [cfg.embedding_dim] + [2 * h] * (cfg.num_layers - 1)
        self.lstm = nn.ModuleList(
            nn.ModuleDict({'fwd': LSTMLayer(d, h), 'bwd': LSTMLayer(d, h)})
            for d in dims)
        self.attention = MultiHeadedAttention(cfg.attention_heads,
                                              cfg.output_size)

    def encode_cv(self, cv, cv_lengths):
        """Context phrases cv (N, L) int + lengths (N,) → (1, N + 1, D)
        phrase embeddings, the blank term (token vocab_size) first."""
        N, L = cv.shape
        dev = self.embed.weight.device
        blank = torch.zeros((1, L), dtype=torch.int64, device=dev)
        blank[0, 0] = self.cfg.vocab_size
        ids = torch.cat([blank, cv.to(dev, torch.int64)], 0)
        lengths = torch.cat([torch.ones((1,), dtype=torch.int64, device=dev),
                             cv_lengths.to(dev, torch.int64)])
        x = self.embed(ids)                              # (N+1, L, E)
        valid = (torch.arange(L, device=dev)[None, :]
                 < lengths[:, None])[:, :, None]
        for layer in self.lstm:
            xm = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                                   device=dev))
            fwd = layer['fwd'](xm)
            bwd = reverse_sequence(
                layer['bwd'](reverse_sequence(xm, lengths, 0.0)), lengths,
                0.0)
            x = torch.cat([fwd, bwd], -1)
        h = x.shape[-1] // 2
        idx = torch.clamp(lengths - 1, min=0)
        last_fwd = torch.gather(
            x[..., :h], 1, idx[:, None, None].expand(-1, 1, h))[:, 0]
        last_bwd = x[:, 0, h:]       # the backward direction ends at 0
        return torch.cat([last_fwd, last_bwd], -1)[None]

    def forward(self, encoder_layer_outs: List[torch.Tensor], cv_emb):
        """(every encoder layer's output (B, T, D), phrase embeddings
        (1, N + 1, D)) → the bias (B, T, D) to add to the encoder output,
        zero on frames whose attention argmax is the blank term.  It is
        computed in the phrase embeddings' dtype (f32) and returned in the
        encoder's."""
        q = combine_layers(encoder_layer_outs)
        B = q.shape[0]
        kv = cv_emb.expand(B, -1, -1)
        out, attn = self.attention.forward_shared_kv_grouped(
            q.to(kv.dtype), self.attention.cross_kv(kv), None, 1,
            return_weights=True)
        picks_blank = torch.argmax(attn[:, 0], dim=-1) == 0    # (B, T)
        out = torch.where(picks_blank[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
        return out.to(q.dtype)
