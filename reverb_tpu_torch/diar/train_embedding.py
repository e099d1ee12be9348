"""Speaker-embedding training: additive-margin cosine softmax (AM-softmax)
over L2-normalized embeddings and class weights.

Counterpart of reverb_tpu/diar/train_embedding.py (`embedding_loss`,
`train_embedding`).  logits = s·(ê·Ŵᵀ − m·onehot(y)); the classifier head
is train-time only and discarded.  A randomly initialized x-vector TDNN
maps every input to nearly one direction, so the clustering merges every
speaker; a brief discriminative pass separates them.  The net trains in
place in full f32 (`models.f32_math`); at 512 channels its four
LayerNorms run kernel K5 forward and K6 backward on the card.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reverb_tpu_torch.diar.models import f32_math
from reverb_tpu_torch.diar.train_segmentation import clipped_step
from reverb_tpu_torch.train.trainer import Adam


def embedding_loss(net, head, feats, lens, labels, scale: float = 10.0,
                   margin: float = 0.0, forward: Optional[Callable] = None):
    """feats (B, T, F) + lens (B,) + int labels (B,) with the head (S, E)
    → (AM-softmax CE, {ce, acc}).  `forward(feats, lens)` replaces
    `net(feats, lens)` (L2-normalized (B, E))."""
    emb = (forward or net)(feats, lens)
    w = head / (torch.linalg.norm(head, dim=-1, keepdim=True) + 1e-8)
    cos = emb @ w.T
    labels = labels.to(torch.int64)
    if margin:
        cos = cos - margin * F.one_hot(labels, cos.shape[-1]).to(cos.dtype)
    logits = scale * cos
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(
        torch.float32))
    return ce, {'ce': ce, 'acc': acc}


class _WithHead(nn.Module):
    """The net and its classifier head, as one tree for the optimizer
    (the JAX package's {'emb': params, 'head': ...})."""

    def __init__(self, net, head):
        super().__init__()
        self.emb = net
        self.head = nn.Parameter(head)


def train_embedding(net, n_speakers: int,
                    train_batches: Callable[[], Iterable],
                    lr: float = 1e-3, max_epochs: int = 10,
                    grad_clip: float = 5.0, scale: float = 10.0,
                    seed: int = 0, forward: Optional[Callable] = None,
                    margin: float = 0.0,
                    head: Optional[torch.Tensor] = None):
    """Train `net` in place on train_batches() → (feats (B, T, F), lens
    (B,), labels (B,)) tensors on its device, with Adam after
    optax.clip_by_global_norm(grad_clip) over the net and the head.  The
    head (n_speakers, E) is N(0, 0.1²) from a generator seeded with
    `seed` on the net's device, or the given `head`.  Returns the net, in
    eval mode with gradients off."""
    dev = next(net.parameters()).device
    if head is None:
        head = torch.randn((n_speakers, net.cfg.embed_dim), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seed)) * 0.1
    state = _WithHead(net, head.to(dev, torch.float32).clone())
    state.train().requires_grad_(True)
    opt = Adam(state, lambda count: lr,
               {n: True for n, _ in state.named_parameters()})
    with f32_math():
        for epoch in range(max_epochs):
            losses, accs = [], []
            for feats, lens, labels in train_batches():
                loss, aux = embedding_loss(net, state.head, feats, lens,
                                           labels, scale, margin, forward)
                clipped_step(opt, loss, grad_clip)
                losses.append(float(loss.detach()))
                accs.append(float(aux['acc']))
            logging.info('emb epoch %d ce %.4f acc %.3f', epoch,
                         np.mean(losses), np.mean(accs))
    return net.eval().requires_grad_(False)
