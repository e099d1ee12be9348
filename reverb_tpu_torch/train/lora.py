"""LoRA fine-tuning: rank-r adapters on the attention projections.

Counterpart of reverb_tpu/train/lora.py (`inject_lora`, `merge_lora`,
`lora_trainable_mask`).  An adapter lives in the `Linear` it adapts
(models/modules.py): `lora_A` (rank, in) drawn N(0, 1/rank²), `lora_B`
(out, rank) zero, so a fresh adapter leaves the layer's output as it was,
and the scale alpha/rank; the layer computes x Wᵀ + s·(x Aᵀ) Bᵀ + b.  The
three tensors are state-dict entries under the JAX tree's names
(`….linear_q.lora_A`, `lora_B`, `lora_scale`), so convert.py carries them
both ways (`lora_modules` gives a model built from a state dict its
adapters first).  `merge_lora` folds W + s·B A into the weight for
serving; `lora_trainable_mask` leaves only the adapters trainable
(`requires_grad`, which the trainer's freeze rules honour).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from reverb_tpu_torch.models.modules import Linear

DEFAULT_TARGETS = ('linear_q', 'linear_k', 'linear_v', 'linear_out')


def inject_lora(model: nn.Module, generator: torch.Generator,
                rank: int = 8, alpha: int = 8,
                targets: Sequence[str] = DEFAULT_TARGETS) -> nn.Module:
    """Add an adapter to every Linear named in `targets` that has none, its
    A drawn from `generator` (in module order)."""
    for name, m in model.named_modules():
        if not isinstance(m, Linear) or m.lora_A is not None \
                or m.weight is None or name.rsplit('.', 1)[-1] not in targets:
            continue
        m.add_lora(rank)
        with torch.no_grad():
            m.lora_A.normal_(generator=generator).mul_(1.0 / rank)
            m.lora_B.zero_()
            m.lora_scale.fill_(alpha / rank)
    return model


def lora_modules(model: nn.Module, state_dict: Dict) -> nn.Module:
    """Give each Linear whose `lora_A` the state dict holds an (empty)
    adapter of its rank, so the state dict then loads strictly."""
    for name, m in model.named_modules():
        key = f'{name}.lora_A'
        if isinstance(m, Linear) and key in state_dict:
            m.add_lora(int(state_dict[key].shape[0]))
    return model


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold every adapter into its weight, W + (B A)·s, and drop it."""
    for m in model.modules():
        if isinstance(m, Linear) and m.lora_A is not None:
            delta = (m.lora_B @ m.lora_A) * m.lora_scale
            m.weight.copy_(m.weight + delta)
            m.drop_lora()
    return model


def lora_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Only the adapters train: requires_grad on lora_A / lora_B, off on
    every other parameter.  Returns {parameter name: trains?}."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = name.rsplit('.', 1)[-1] in ('lora_A', 'lora_B')
        p.requires_grad_(out[name])
    return out
