"""Sequence utilities (counterpart of reverb_tpu/utils/common.py)."""

from __future__ import annotations

import torch

IGNORE_ID = -1


def reverse_sequence(ys_pad, ys_lens, pad_value: int = IGNORE_ID):
    """Reverse each row's first `len` elements of (B, L) ys_pad; positions
    >= len get pad_value."""
    B, L = ys_pad.shape
    idx = torch.arange(L, device=ys_pad.device)[None, :]
    seq_mask = idx < ys_lens[:, None]
    gather = torch.where(seq_mask, ys_lens[:, None] - 1 - idx,
                         torch.zeros_like(idx))
    rev = torch.gather(ys_pad, 1, gather.to(torch.int64))
    return torch.where(seq_mask, rev, torch.full_like(rev, pad_value))
