"""DecodeResult: host-side decode output container.

The port's own copy of reverb_tpu/decode/results.py (parity:
asr/wenet/transformer/search.py:29-58).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class DecodeResult:
    tokens: List[int]
    score: float = 0.0
    confidence: float = 0.0
    tokens_confidence: Optional[List[float]] = None
    times: Optional[List[int]] = None
    nbest: Optional[List[List[int]]] = None
    nbest_scores: Optional[List[float]] = None
    nbest_times: Optional[List[List[int]]] = None
