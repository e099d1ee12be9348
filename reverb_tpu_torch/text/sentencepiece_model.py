"""Pure-python SentencePiece model reader + encoder (the port's own copy of
reverb_tpu/text/sentencepiece_model.py).

The image has no sentencepiece C++ library, so we parse the `.model`
protobuf (ModelProto) with a minimal wire-format reader and implement both
encoding algorithms:
  * unigram: Viterbi segmentation over piece log-probs
  * BPE: iterative best-scoring adjacent merge (score = -merge rank)

Normalization approximates SentencePiece's default NMT-NFKC: NFKC +
whitespace collapse + '▁' (U+2581) space marker with add_dummy_prefix.
Reference usage: asr/wenet/text/rev_bpe_tokenizer.py:35-39 (spm load/encode).
"""

from __future__ import annotations

import functools
import unicodedata
from typing import Dict, List, Tuple

SPACE = '▁'  # '▁'

# ModelProto field numbers (public sentencepiece_model.proto):
#   1: repeated SentencePiece pieces {1: piece (string), 2: score (float),
#                                     3: type (enum)}
#   2: TrainerSpec {3: model_type enum UNIGRAM=1 BPE=2 WORD=3 CHAR=4}
#   3: NormalizerSpec {1: name, ...}
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _BYTE, _UNUSED = 1, 2, 3, 6, 4, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_message(buf: bytes):
    """Generic protobuf parse → dict field_no → list of raw values."""
    fields: Dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_no, wire = tag >> 3, tag & 7
        if wire == 0:      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:    # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:    # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field_no, []).append(val)
    return fields


class SentencePieceModel:
    def __init__(self, path: str):
        import struct
        with open(path, 'rb') as f:
            raw = f.read()
        top = _parse_message(raw)
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        for pb in top.get(1, []):
            f_ = _parse_message(pb)
            piece = f_.get(1, [b''])[0].decode('utf-8')
            score = struct.unpack('<f', f_.get(2, [b'\x00' * 4])[0])[0]
            ptype = f_.get(3, [_NORMAL])[0]
            if isinstance(ptype, bytes):
                ptype = _NORMAL
            self.pieces.append(piece)
            self.scores.append(score)
            self.types.append(int(ptype))
        self.model_type = 1  # unigram default
        if 2 in top:
            trainer = _parse_message(top[2][0])
            if 3 in trainer:
                self.model_type = int(trainer[3][0])
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = next((i for i, t in enumerate(self.types)
                            if t == _UNKNOWN), 0)
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)
        if self.model_type == 2:
            # BPE: score encodes merge priority (higher = earlier merge)
            self._bpe_ranks = {p: -s for p, s in zip(self.pieces, self.scores)}

    # ------------------------------ normalize ------------------------------

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize('NFKC', text)
        text = ' '.join(text.split())  # collapse whitespace
        if not text:
            return ''
        text = ' ' + text              # add_dummy_prefix
        return text.replace(' ', SPACE)

    # ------------------------------ encode ------------------------------

    def encode(self, text: str, out_type=str):
        norm = self.normalize(text)
        if not norm:
            return []
        if self.model_type == 2:
            ids = self._encode_bpe(norm)
        else:
            ids = self._encode_unigram(norm)
        if out_type is str:
            return [self.pieces[i] for i in ids]
        return ids

    def _encode_unigram(self, norm: str) -> List[int]:
        """Viterbi over piece scores; unknown chars → unk."""
        n = len(norm)
        best = [float('-inf')] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores) - 10.0 if self.scores else -100.0
        for i in range(n):
            if best[i] == float('-inf'):
                continue
            matched = False
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                pid = self.piece_to_id.get(norm[i:j])
                if pid is None:
                    continue
                t = self.types[pid]
                if t in (_CONTROL, _UNUSED):
                    continue
                matched = True
                sc = best[i] + self.scores[pid]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, pid)
            if not matched or best[i + 1] == float('-inf'):
                sc = best[i] + unk_penalty
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            ids.append(pid)
            j = i
        return ids[::-1]

    def _encode_bpe(self, norm: str) -> List[int]:
        """Greedy best-rank adjacent merges (sentencepiece BPE semantics)."""
        symbols = list(norm)
        ranks = self._bpe_ranks
        while len(symbols) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                r = ranks.get(merged)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_i < 0:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i]
                                          + symbols[best_i + 1]]
        ids = []
        for s in symbols:
            pid = self.piece_to_id.get(s)
            if pid is None:
                # fall back to per-char, then unk
                for ch in s:
                    ids.append(self.piece_to_id.get(ch, self.unk_id))
            else:
                ids.append(pid)
        return ids

    def decode_pieces(self, pieces: List[str]) -> str:
        return ''.join(pieces).replace(SPACE, ' ').strip()
