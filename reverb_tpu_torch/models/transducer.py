"""Transducer (RNN-T) model family: predictors, joint, exact loss, greedy
and prefix-beam search.

Counterpart of reverb_tpu/models/transducer.py (`TransducerConfig`,
`init_predictor` / `predictor_forward` / `predictor_init_state` /
`predictor_step`, `init_joint` / `joint_forward`, `rnnt_loss`,
`transducer_loss`, `transducer_greedy_device`,
`transducer_greedy_search`, `transducer_beam_search`).  Parameter names
are the JAX tree's (`predictor.embed`, `predictor.projection`,
`predictor.conv`, `predictor.norm`, `joint.{enc_ffn,pred_ffn,ffn_out}`),
except the rnn predictor's LSTM: it is `nn.LSTM` (diar/models.py:LSTM,
the gate order i, f, g, o of the JAX lstm_forward), whose
`weight_ih_l{k}`, `weight_hh_l{k}` and `bias_ih_l{k}` hold the JAX
layer's w_ih, w_hh and b, with `bias_hh_l{k}` zero and frozen
(convert.py maps the keys both ways).

`rnnt_loss` is the exact loss over the full (T, U+1) lattice, as the JAX
package's; JAX scans over frames with a log-semiring associative scan
over U inside each, the port loops over U with a log-cumulative-sum over
frames inside each: alpha[t, u] = Bc[t] + logcumsumexp_s(in[s] − Bc[s])
with Bc the exclusive cumulative blank log-prob along t and in[s] =
alpha[s, u−1] + emit[s, u−1] — the same recursion unrolled the other
way, U+1 vectorised steps instead of T.  None of it is a Pallas kernel
in JAX: plain torch ops here.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.decode.results import DecodeResult
from reverb_tpu_torch.diar.models import LSTM
from reverb_tpu_torch.models.asr_model import ASRModel
from reverb_tpu_torch.models.modules import (ACTIVATIONS, Conv1d, Embedding,
                                             LayerNorm, Linear)
from reverb_tpu_torch.parallel import global_batch as gb

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    vocab_size: int = 1000
    blank_id: int = 0
    encoder_output_size: int = 256
    predictor: str = 'rnn'            # rnn | embedding | conv
    predictor_embed_size: int = 256
    predictor_hidden_size: int = 256
    predictor_layers: int = 2
    predictor_kernel: int = 3         # conv/embedding context
    join_dim: int = 512
    joint_activation: str = 'tanh'


# ------------------------------ predictors ------------------------------

class Predictor(nn.Module):
    """Label-sequence network: 'rnn' (embedding → LSTM stack →
    projection), 'conv' (embedding → causal depthwise conv → LayerNorm) or
    'embedding' (embedding → LayerNorm)."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.predictor_embed_size
        self.embed = Embedding(cfg.vocab_size, E)
        if cfg.predictor == 'rnn':
            self.rnn = LSTM(E, cfg.predictor_hidden_size,
                            num_layers=cfg.predictor_layers,
                            batch_first=True)
            self.projection = Linear(cfg.predictor_hidden_size, E)
        elif cfg.predictor == 'conv':
            self.conv = Conv1d(E, E, cfg.predictor_kernel, groups=E)
            self.norm = LayerNorm(E)
        elif cfg.predictor == 'embedding':
            self.norm = LayerNorm(E)
        else:
            raise ValueError(cfg.predictor)

    def forward(self, ys_in):
        """ys_in (B, U) with blank prepended → (B, U, E)."""
        x = self.embed(ys_in.clamp(min=0).to(torch.int64))
        if self.cfg.predictor == 'rnn':
            return self.projection(self.rnn(x)[0])
        if self.cfg.predictor == 'conv':
            xc = F.pad(x, (0, 0, self.cfg.predictor_kernel - 1, 0))
            return self.norm(self.conv.depthwise(xc, 0))
        return self.norm(x)

    def init_state(self, batch: int, device):
        """Streaming state of `step`: per LSTM layer (h, c), or the last
        predictor_kernel tokens (-1 = before the start: the forward's zero
        left padding)."""
        cfg = self.cfg
        if cfg.predictor == 'rnn':
            H = cfg.predictor_hidden_size
            return [(torch.zeros(batch, H, device=device),
                     torch.zeros(batch, H, device=device))
                    for _ in range(cfg.predictor_layers)]
        return torch.full((batch, cfg.predictor_kernel), -1,
                          dtype=torch.int64, device=device)

    def step(self, token, state):
        """One token per row: token (B,) → ((B, E), new state)."""
        cfg = self.cfg
        if cfg.predictor == 'rnn':
            h_in = self.embed(token.clamp(min=0).to(torch.int64))
            new_state = []
            for k, (h, c) in enumerate(state):
                r = self.rnn
                gates = (F.linear(h_in, getattr(r, f'weight_ih_l{k}'),
                                  getattr(r, f'bias_ih_l{k}')
                                  + getattr(r, f'bias_hh_l{k}'))
                         + h @ getattr(r, f'weight_hh_l{k}').t())
                i, f, g, o = gates.chunk(4, -1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                new_state.append((h, c))
                h_in = h
            return self.projection(h_in), new_state
        hist = torch.cat([state[:, 1:], token.to(torch.int64)[:, None]], 1)
        emb = self.embed(hist.clamp(min=0))                    # (B, k, E)
        emb = torch.where((hist >= 0)[..., None], emb,
                          torch.zeros((), dtype=emb.dtype, device=emb.device))
        if cfg.predictor == 'conv':
            w = self.conv.weight[:, 0, :]                      # (E, k)
            out = (emb.transpose(1, 2) * w[None]).sum(2) + self.conv.bias
            return self.norm(out), hist
        return self.norm(emb[:, -1]), hist


def where_state(keep, new, old):
    """Row-wise `new` where keep (B,) else `old`, for a predictor state."""
    if isinstance(new, list):
        k = keep[:, None]
        return [(torch.where(k, hn, ho), torch.where(k, cn, co))
                for (hn, cn), (ho, co) in zip(new, old)]
    return torch.where(keep[:, None], new, old)


# ------------------------------ joint ------------------------------

class Joint(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.act = ACTIVATIONS[cfg.joint_activation]
        self.enc_ffn = Linear(cfg.encoder_output_size, cfg.join_dim)
        self.pred_ffn = Linear(cfg.predictor_embed_size, cfg.join_dim)
        self.ffn_out = Linear(cfg.join_dim, cfg.vocab_size)

    def forward(self, enc, pred):
        """enc (..., D), pred (..., E) broadcastable → logits (..., V)."""
        return self.ffn_out(self.act(self.enc_ffn(enc) + self.pred_ffn(pred)))


# ------------------------------ RNN-T loss ------------------------------

def rnnt_loss(logits, logit_lens, labels, label_lens, blank_id: int = 0):
    """Exact transducer loss: logits (B, T, U+1, V) joint outputs, labels
    (B, U), lengths per sequence → per-sequence negative log-likelihood
    (B,) in f32.  The log-softmax over V is taken in f32; lattice cells
    past a row's label length hold NEG_INF, as in the JAX package (they
    never feed a cell at or below the length)."""
    logp = torch.log_softmax(logits.to(torch.float32), -1)
    B, T, U1, V = logp.shape
    U = U1 - 1
    blank = logp[..., blank_id]                               # (B, T, U+1)
    lab = labels.to(torch.int64).clamp(min=0)[:, None, :, None].expand(
        B, T, U, 1)
    emit = torch.gather(logp[:, :, :U], 3, lab)[..., 0]       # (B, T, U)
    # Bc[t, u]: the blank log-probs of frames before t at label position u
    bc = torch.cumsum(blank, 1) - blank
    alpha = bc[:, :, 0]
    cols = [alpha]
    for u in range(1, U1):
        b = bc[:, :, u]
        alpha = b + torch.logcumsumexp(alpha + emit[:, :, u - 1] - b, 1)
        cols.append(alpha)
    valid_u = (torch.arange(U1, device=logp.device)[None, :]
               <= label_lens.to(logp.device)[:, None])         # (B, U+1)
    alphas = torch.where(valid_u[:, None, :], torch.stack(cols, 2),
                         torch.full((), NEG_INF, device=logp.device))
    rows = torch.arange(B, device=logp.device)
    t_last = (logit_lens.to(logp.device).to(torch.int64) - 1).clamp(min=0)
    u_last = label_lens.to(logp.device).to(torch.int64)
    return -(alphas[rows, t_last, u_last] + blank[rows, t_last, u_last])


def transducer_loss(predictor: Predictor, joint: Joint, encoder_out,
                    encoder_lens, labels, label_lens, blank_id: int = 0):
    """The joint over the full (T, U+1) lattice and its exact loss, the
    mean over the batch (reverb_tpu/models/transducer.py:
    transducer_loss), the global batch's under a data shard
    (parallel/global_batch.py)."""
    B = labels.shape[0]
    blank_col = torch.full((B, 1), blank_id, dtype=labels.dtype,
                           device=labels.device)
    ys_in = torch.cat([blank_col, labels.clamp(min=0)], 1)
    pred = predictor(ys_in)                                   # (B, U+1, E)
    logits = joint(encoder_out[:, :, None, :], pred[:, None, :, :])
    return gb.mean(rnnt_loss(logits, encoder_lens, labels.clamp(min=0),
                             label_lens, blank_id))


class TransducerModel(ASRModel):
    """The conformer ASRModel (encoder, decoder, CTC head) plus a
    predictor and a joint, and for the bidirectional transducer a second
    pair (`predictor_r`, `joint_r`) scoring the time-reversed stream
    (reverb_tpu/models/registry.py:_transducer_bundle).  `loss_weights`:
    {'t': rnnt, 'ctc': ctc, 'r': the R2L share of the rnnt term}."""

    def __init__(self, cfg, tcfg: TransducerConfig, bidirectional: bool,
                 with_cmvn: bool = False, loss_weights=None):
        super().__init__(cfg, with_cmvn)
        self.tcfg = tcfg
        self.loss_weights = loss_weights or {'t': 0.75, 'ctc': 0.25,
                                             'r': 0.3}
        self.predictor = Predictor(tcfg)
        self.joint = Joint(tcfg)
        if bidirectional:
            self.predictor_r = Predictor(tcfg)
            self.joint_r = Joint(tcfg)


# ------------------------------ search ------------------------------

@torch.no_grad()
def transducer_greedy_device(predictor: Predictor, joint: Joint,
                             encoder_out, encoder_lens, blank_id: int = 0,
                             n_steps: int = 2):
    """Batched greedy search: a loop over frames, up to n_steps symbols a
    frame, every row in lockstep.  Returns tokens (B, T·n_steps), blank
    where nothing was emitted."""
    B, T, _ = encoder_out.shape
    dev = encoder_out.device
    lens = encoder_lens.to(dev)
    tok = torch.full((B,), blank_id, dtype=torch.int64, device=dev)
    pred, state = predictor.step(tok, predictor.init_state(B, dev))
    out = []
    for t in range(T):
        for _ in range(n_steps):
            logits = joint(encoder_out[:, t], pred)
            nxt = torch.argmax(logits, -1)
            valid = (nxt != blank_id) & (t < lens)
            new_pred, new_state = predictor.step(nxt, state)
            pred = torch.where(valid[:, None], new_pred, pred)
            state = where_state(valid, new_state, state)
            out.append(torch.where(valid, nxt, tok))
    return torch.stack(out, 1)


def transducer_greedy_search(predictor: Predictor, joint: Joint,
                             encoder_out, encoder_lens,
                             blank_id: int = 0) -> List[DecodeResult]:
    toks = transducer_greedy_device(predictor, joint, encoder_out,
                                    torch.as_tensor(encoder_lens),
                                    blank_id).cpu().numpy()
    return [DecodeResult(tokens=[int(t) for t in row if t != blank_id])
            for row in toks]


@torch.no_grad()
def transducer_beam_search(predictor: Predictor, joint: Joint, encoder_out,
                           encoder_lens, blank_id: int = 0,
                           beam_size: int = 4) -> List[DecodeResult]:
    """Host prefix beam over frames (reverb_tpu/models/transducer.py:
    transducer_beam_search): the predictor of each new prefix and the
    joint of each (frame, hypothesis) run on the model's device, the beam
    bookkeeping on the host."""
    dev = encoder_out.device
    results = []
    for b in range(encoder_out.shape[0]):
        T = int(encoder_lens[b])
        beams = [((), 0.0)]
        pred_cache = {}

        def pred_of(prefix):
            if prefix not in pred_cache:
                ys = torch.tensor([[blank_id] + list(prefix)], device=dev)
                pred_cache[prefix] = predictor(ys)[0, -1]
            return pred_cache[prefix]

        for t in range(T):
            cand = {}
            for prefix, score in beams:
                logits = joint(encoder_out[b, t], pred_of(prefix))
                logp = torch.log_softmax(logits, -1).cpu().numpy()
                cand[prefix] = np.logaddexp(cand.get(prefix, -np.inf),
                                            score + logp[blank_id])
                for u in np.argsort(logp)[-beam_size:]:
                    if u == blank_id:
                        continue
                    key = prefix + (int(u),)
                    cand[key] = np.logaddexp(cand.get(key, -np.inf),
                                             score + logp[u])
            beams = sorted(cand.items(), key=lambda kv: -kv[1])[:beam_size]
        results.append(DecodeResult(tokens=list(beams[0][0]),
                                    score=float(beams[0][1])))
    return results
