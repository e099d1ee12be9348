"""Exact last-dim top-k with the reference's tie order.

Counterpart of reverb_tpu/ops/topk.py (`topk_lastdim`): values descending,
ties to the lowest index, exactly as `jax.lax.top_k`.  `torch.topk` does
not promise that order, so this is a stable descending sort.  The CTC head
(top-k over V) and the beam's second prune (top-K over K·(K2+1)
candidates) both use it.
"""

from __future__ import annotations

import torch


def topk_lastdim(x, k: int):
    """(values, indices) of the k largest along the last dim."""
    res = torch.sort(x, dim=-1, descending=True, stable=True)
    return res.values[..., :k], res.indices[..., :k]
