"""CTC greedy search, batched on the device.

Counterpart of reverb_tpu/decode/greedy.py (`ctc_greedy_search`,
`ctc_greedy_from_top1`): per-frame argmax (the first maximal index, as
`jnp.argmax`), frames past the length forced to blank, then each run's
first non-blank frame kept.  Only the ragged extraction runs on the host.
"""

from __future__ import annotations

from typing import List

import torch

from reverb_tpu_torch.decode.results import DecodeResult


def ctc_greedy_from_top1(top1, ctc_lens, blank_id: int = 0
                         ) -> List[DecodeResult]:
    """Greedy results from per-frame argmax indices (B, T): the k = 1
    column of `models.ctc.ctc_topk_logprobs`, or the argmax of the dense
    table."""
    B, T = top1.shape
    dev = top1.device
    pad = (torch.arange(T, device=dev)[None, :]
           >= torch.as_tensor(ctc_lens, device=dev)[:, None])
    t1 = torch.where(pad, torch.full_like(top1, blank_id), top1)
    prev = torch.cat([torch.full((B, 1), -1, dtype=t1.dtype, device=dev),
                      t1[:, :-1]], 1)
    keep = (t1 != blank_id) & (t1 != prev)
    t1, keep = t1.cpu().numpy(), keep.cpu().numpy()
    results = []
    for b in range(B):
        times = keep[b].nonzero()[0]
        results.append(DecodeResult(tokens=t1[b][times].tolist(),
                                    times=times.tolist()))
    return results


def ctc_greedy_search(ctc_probs, ctc_lens, blank_id: int = 0
                      ) -> List[DecodeResult]:
    """Greedy results from the dense (B, T, V) log-prob table."""
    return ctc_greedy_from_top1(torch.argmax(ctc_probs, dim=2), ctc_lens,
                                blank_id)
