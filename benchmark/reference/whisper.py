"""Plain PyTorch reference of Whisper's training step, in float32.

OpenAI Whisper (Radford et al. 2022, github.com/openai/whisper,
model.py): log-mel → conv1d(k3) + GELU → conv1d(k3, stride 2) + GELU →
the fixed sinusoid table → pre-LN blocks (self-attention, MLP 4d with exact
GELU) → ln_post; the decoder adds a learned positional table to the token
embedding, runs pre-LN blocks with causal self-attention and
cross-attention, then ln and the tied output projection.  Key projections
have no bias.  The loss is the mean next-token NLL over the target
positions; the step is Adam (optax's arithmetic: bias-corrected moments,
eps outside the root) after clipping the global gradient norm, at the
warmup schedule's rate.  Parameter names follow the serving tree's keys
(`encoder.blocks.{i}.self_attn.linear_q.weight`, ...), so one seeded
weight spec feeds both sides.

Nothing here imports the program; every matmul runs in float32 unless the
caller turns TF32 on (the control).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark import weights as W


class _Linear(nn.Module):
    def __init__(self, i: int, o: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class _Conv1d(nn.Module):
    def __init__(self, i: int, o: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i, k))
        self.bias = nn.Parameter(torch.empty(o))


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.h = heads
        self.linear_q = _Linear(d, d)
        self.linear_k = _Linear(d, d, bias=False)
        self.linear_v = _Linear(d, d)
        self.linear_out = _Linear(d, d)

    def forward(self, x, kv, causal: bool):
        B, Tq, D = x.shape
        Tk = kv.shape[1]
        dk = D // self.h

        def heads(t, T):
            return t.reshape(B, T, self.h, dk).transpose(1, 2)
        q = heads(self.linear_q(x), Tq)
        k = heads(self.linear_k(kv), Tk)
        v = heads(self.linear_v(kv), Tk)
        s = q @ k.transpose(-1, -2) / math.sqrt(dk)
        if causal:
            keep = torch.ones((Tq, Tk), dtype=torch.bool,
                              device=x.device).tril()
            s = s.masked_fill(~keep, -1e9)
        ctx = torch.softmax(s, -1) @ v
        return self.linear_out(ctx.transpose(1, 2).reshape(B, Tq, D))


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.w_1 = _Linear(d, 4 * d)
        self.w_2 = _Linear(4 * d, d)

    def forward(self, x):
        return self.w_2(F.gelu(self.w_1(x)))


class _Block(nn.Module):
    def __init__(self, d: int, heads: int, cross: bool):
        super().__init__()
        self.self_attn = _Attention(d, heads)
        self.norm1 = _LayerNorm(d)
        self.mlp = _MLP(d)
        self.norm_mlp = _LayerNorm(d)
        self.cross = cross
        if cross:
            self.cross_attn = _Attention(d, heads)
            self.norm2 = _LayerNorm(d)

    def forward(self, x, audio=None):
        xn = self.norm1(x)
        x = x + self.self_attn(xn, xn, causal=self.cross)
        if self.cross:
            x = x + self.cross_attn(self.norm2(x), audio, causal=False)
        return x + self.mlp(self.norm_mlp(x))


class _Encoder(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        d = c['d_model']
        self.conv1 = _Conv1d(c['num_mel_bins'], d, 3)
        self.conv2 = _Conv1d(d, d, 3)
        self.positional_embedding = nn.Parameter(
            torch.empty(c['max_source_positions'], d))
        self.blocks = nn.ModuleList(
            _Block(d, c['encoder_attention_heads'], False)
            for _ in range(c['encoder_layers']))
        self.ln_post = _LayerNorm(d)

    def forward(self, mel):
        x = mel.transpose(1, 2)
        x = F.gelu(F.conv1d(x, self.conv1.weight, self.conv1.bias, padding=1))
        x = F.gelu(F.conv1d(x, self.conv2.weight, self.conv2.bias, stride=2,
                            padding=1))
        x = x.transpose(1, 2)
        x = x + self.positional_embedding[:x.shape[1]]
        for blk in self.blocks:
            x = blk(x)
        return self.ln_post(x)


class _Embedding(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))


class _Decoder(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        d = c['d_model']
        self.token_embedding = _Embedding(c['vocab_size'], d)
        self.positional_embedding = nn.Parameter(
            torch.empty(c['max_target_positions'], d))
        self.blocks = nn.ModuleList(
            _Block(d, c['decoder_attention_heads'], True)
            for _ in range(c['decoder_layers']))
        self.ln = _LayerNorm(d)

    def forward(self, tokens, audio):
        L = tokens.shape[1]
        x = self.token_embedding.weight[tokens] + self.positional_embedding[:L]
        for blk in self.blocks:
            x = blk(x, audio)
        return self.ln(x) @ self.token_embedding.weight.t()


class Whisper(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        if c['encoder_ffn_dim'] != 4 * c['d_model'] or \
                c['decoder_ffn_dim'] != 4 * c['d_model']:
            raise ValueError('the reference MLP is 4·d_model wide')
        self.encoder = _Encoder(c)
        self.decoder = _Decoder(c)


def _kind(name: str) -> str:
    if name == 'encoder.positional_embedding':
        return 'sinusoid'
    if name == 'decoder.positional_embedding':
        return 'small'
    if name.endswith('token_embedding.weight'):
        return 'embed'
    leaf = name.rsplit('.', 2)
    if leaf[-2].startswith(('norm', 'ln')):
        return 'ones' if leaf[-1] == 'weight' else 'small'
    return 'small' if name.endswith('.bias') else 'fan_in'


def spec(c: Dict) -> W.Spec:
    """The seeded weight spec of the configuration: every parameter, in
    the module's order, with its init kind."""
    with torch.device('meta'):
        m = Whisper(c)
    return [(n, tuple(p.shape), _kind(n)) for n, p in m.named_parameters()]


def build(c: Dict, seed: int, device) -> Whisper:
    with torch.device('meta'):
        m = Whisper(c)
    m = m.to_empty(device=device)
    with torch.no_grad():
        params = dict(m.named_parameters())
        for name, t in W.leaves(spec(c), seed, device):
            params[name].copy_(t)
    return m


def loss_rows(model: Whisper, mel, target, target_lengths, total: int):
    """Σ over the rows' valid positions of the next-token NLL, / `total`
    (the whole batch's count of valid positions)."""
    tokens = torch.where(target == -1, torch.zeros_like(target), target)
    ys_in, ys_out = tokens[:, :-1], tokens[:, 1:]
    valid = (torch.arange(ys_out.shape[1], device=target.device)[None, :]
             < (target_lengths - 1)[:, None])
    logits = model.decoder(ys_in, model.encoder(mel))
    nll = -torch.log_softmax(logits, -1).gather(-1, ys_out[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / total


def warmup_lr(lr: float, warmup: int, count: int) -> float:
    s = float(max(count + 1, 1))
    return lr * warmup ** 0.5 * min(s ** -0.5, s * warmup ** -1.5)


def train_steps(c: Dict, train: Dict, seed: int, batches: List[Dict],
                device) -> Dict:
    """Len(batches) steps of Adam after the global-norm clip from the
    seeded weights; the batch's loss and gradient are taken one row at a
    time so that the activations fit beside the model.
    Returns {losses, grad_norms (first step, clipped, per leaf),
    change_norms (per leaf, after the last step)}."""
    model = build(c, seed, device)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = train['b1'], train['b2'], train['eps']
    losses, grad_norms = [], None
    for count, batch in enumerate(batches):
        for p in params:
            p.grad = None
        B = batch['feats'].shape[0]
        total = int((batch['target_lengths'] - 1).sum())
        loss = 0.0
        for r in range(B):
            part = loss_rows(model, batch['feats'][r:r + 1],
                             batch['target'][r:r + 1],
                             batch['target_lengths'][r:r + 1], total)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = [p.grad for p in params]
            norm = float(torch.linalg.vector_norm(
                torch.stack([g.norm() for g in grads])))
            scale = 1.0
            if norm >= train['grad_clip']:
                scale = float(np.float32(train['grad_clip'])
                              / np.float32(norm))
            grads = [g * scale for g in grads]
            if count == 0:
                grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
            n = count + 1
            lr = warmup_lr(train['lr'], train['warmup_steps'], count)
            c1 = float(np.float32(1.0) - np.float32(b1) ** np.int32(n))
            c2 = float(np.float32(1.0) - np.float32(b2) ** np.int32(n))
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.sub_(lr * (m / c1) / ((v / c2).sqrt() + eps))
            del grads
    for p in params:
        p.grad = None
    del mu, nu
    change = {}
    with torch.no_grad():
        own = dict(zip(names, params))
        for name, p0 in W.leaves(spec(c), seed, device):
            change[name] = float((own[name] - p0).norm())
    return {'losses': losses, 'grad_norms': grad_norms,
            'change_norms': change}
