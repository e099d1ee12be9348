"""Fine-tuning a segmentation net: the powerset cross-entropy plus a voice
activity BCE, Adam with global-norm clipping, CV and early stopping.

Counterpart of reverb_tpu/diar/train_segmentation.py (`segmentation_loss`,
`train_segmentation`; the reference's diarization/train_pyannote3.0.py:
42-88).  The net is the port's native `SegmentationNet` or, through
`forward=`, any callable of the wave such as a `PyanNet`
(diar/pyannet.py), trained in place in full f32 (`models.f32_math`).

The JAX package's LSTM has one bias `b` where nn.LSTM has `bias_ih` and
`bias_hh` (diar/convert.py puts b in bias_ih, bias_hh zero): `bias_hh`
stays frozen at zero, so the update and the gradient norm see one bias, as
in JAX.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from reverb_tpu_torch.diar.models import f32_math
from reverb_tpu_torch.train.trainer import Adam


def segmentation_loss(net, wave, labels, vad_weight: float = 0.5,
                      forward: Optional[Callable] = None):
    """wave (B, S) + labels (B, T', C) one-hot powerset classes → (CE +
    vad_weight · VAD BCE, {ce, vad_bce}).  `forward(wave)` replaces
    `net(wave)` (log-probabilities (B, T', C))."""
    logp = (forward or net)(wave)
    T = min(logp.shape[1], labels.shape[1])
    logp, labels = logp[:, :T], labels[:, :T].to(logp.dtype)
    ce = -torch.mean(torch.sum(labels * logp, dim=-1))
    # speech: any non-empty powerset class (class 0 is silence)
    speech_prob = 1.0 - torch.exp(logp[..., 0])
    speech_label = 1.0 - labels[..., 0]
    bce = -torch.mean(speech_label * torch.log(speech_prob + 1e-8)
                      + (1 - speech_label) * torch.log(1 - speech_prob
                                                       + 1e-8))
    return ce + vad_weight * bce, {'ce': ce, 'vad_bce': bce}


def trainable_names(net) -> Dict[str, bool]:
    """{parameter name: trains?}: all but nn.LSTM's `bias_hh` (see the
    module docstring)."""
    return {n: '.bias_hh_' not in n and not n.startswith('bias_hh_')
            for n, _ in net.named_parameters()}


def clipped_step(opt: Adam, loss, grad_clip: float) -> float:
    """Backward of `loss`, then one Adam update of the trainable
    parameters with optax.clip_by_global_norm(grad_clip) semantics (scale
    by clip/‖g‖ when ‖g‖ ≥ clip).  Returns ‖g‖."""
    for p in opt.params:
        p.grad = None
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in opt.params]
    norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [grads[i] for i in opt.train_idx]))))
    scale = 1.0 if norm < grad_clip else float(
        np.float32(grad_clip) / np.float32(norm))
    opt.step(grads, scale)
    for p in opt.params:
        p.grad = None
    return norm


def train_segmentation(net, train_batches: Callable[[], Iterable],
                       cv_batches: Optional[Callable[[], Iterable]] = None,
                       lr: float = 1e-4, max_epochs: int = 20,
                       patience: int = 10, grad_clip: float = 0.5,
                       forward: Optional[Callable] = None):
    """Train `net` in place on train_batches() → (wave (B, S), labels (B,
    T', C)) tensors on its device; after each epoch the CV loss (else the
    mean training loss) decides the best epoch, whose weights the net
    holds at the end; patience epochs without a gain stop early.  Returns
    the net, in eval mode with gradients off."""
    mask = trainable_names(net)
    net.train()
    for n, p in net.named_parameters():
        p.requires_grad_(mask[n])
    opt = Adam(net, lambda count: lr, mask)
    best_loss, bad_epochs = float('inf'), 0
    best = {k: v.detach().clone() for k, v in net.state_dict().items()}
    with f32_math():
        for epoch in range(max_epochs):
            losses = []
            for wave, labels in train_batches():
                loss, _ = segmentation_loss(net, wave, labels,
                                            forward=forward)
                clipped_step(opt, loss, grad_clip)
                losses.append(float(loss.detach()))
            cv = None
            if cv_batches is not None:
                with torch.no_grad():
                    cv_losses = [float(segmentation_loss(
                        net, w, lab, forward=forward)[0])
                        for w, lab in cv_batches()]
                cv = float(np.mean(cv_losses)) if cv_losses else None
            logging.info('seg epoch %d train %.4f cv %s', epoch,
                         np.mean(losses), cv)
            metric = cv if cv is not None else float(np.mean(losses))
            if metric < best_loss - 1e-5:
                best_loss, bad_epochs = metric, 0
                best = {k: v.detach().clone()
                        for k, v in net.state_dict().items()}
            else:
                bad_epochs += 1
                if bad_epochs >= patience:
                    logging.info('early stopping at epoch %d', epoch)
                    break
    net.load_state_dict(best)
    return net.eval().requires_grad_(False)
