"""Paraformer (FunASR) tokenizer: CJK-char + seg-dict word segmentation.

The port's own copy of reverb_tpu/text/paraformer_tokenizer.py (reference
asr/wenet/text/paraformer_tokenizer.py + tokenize_utils.py:22-55), on the
port's `CharTokenizer`.

Tokenization: split text on CJK characters — each CJK char is one token;
non-CJK runs are looked up word-by-word in the seg dict (word → space-joined
subwords, '@@' marks a non-final subword); OOV words fall back to '<unk>'.
Detokenization merges '@@' pieces and inserts spaces only between latin
words (none between CJK chars).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Union

from reverb_tpu_torch.text.tokenizer import CharTokenizer

_CJK = re.compile(r'([一-鿿])')


def read_seg_dict(path) -> Dict[str, str]:
    table: Dict[str, str] = {}
    with open(path, encoding='utf8') as f:
        for line in f:
            arr = line.strip().split('\t')
            if len(arr) == 2:
                table[arr[0]] = arr[1]
    return table


def tokenize_by_seg_dict(seg_dict: Dict[str, str], txt: str) -> List[str]:
    out: List[str] = []
    for piece in (w for w in _CJK.split(txt) if w.strip()):
        if _CJK.fullmatch(piece):
            out.append(piece)
            continue
        for word in piece.strip().split():
            if word in seg_dict:
                out.extend(seg_dict[word].split())
            else:
                out.append('<unk>')
    return out


def _is_cjk(tok: str) -> bool:
    return bool(_CJK.fullmatch(tok))


def beautify_result(tokens: List[str]) -> str:
    """Merge '@@' pieces, space latin words apart, no space between CJK
    characters; '<sos>', '<eos>', '<blank>' and '<unk>' are dropped."""
    words: List[str] = []
    partial = ''
    for tok in tokens:
        if tok in ('<sos>', '<eos>', '<blank>', '<unk>'):
            continue
        if _is_cjk(tok):
            if partial:
                words.append(partial)
                partial = ''
            words.append(tok)
        elif tok.endswith('@@'):
            partial += tok[:-2]
        else:
            words.append(partial + tok)
            partial = ''
    if partial:
        words.append(partial)
    # a space between two latin words and at every latin/CJK switch
    out = ''
    prev_latin = False
    for w in words:
        latin = not _is_cjk(w)
        if out and (latin or latin != prev_latin):
            out += ' '
        out += w
        prev_latin = latin
    return out.strip()


class ParaformerTokenizer(CharTokenizer):
    def __init__(self, symbol_table: Union[str, Dict],
                 seg_dict: Optional[Union[str, Dict]] = None,
                 split_with_space: bool = False, connect_symbol: str = '',
                 unk: str = '<unk>'):
        super().__init__(symbol_table, None, split_with_space,
                         connect_symbol, unk)
        if seg_dict is not None and not isinstance(seg_dict, dict):
            seg_dict = read_seg_dict(seg_dict)
        self.seg_dict = seg_dict

    def text2tokens(self, line: str) -> List[str]:
        if self.seg_dict is None:
            raise ValueError('the paraformer tokenizer needs a seg_dict')
        return tokenize_by_seg_dict(self.seg_dict, line.strip())

    def tokens2text(self, tokens: List[str]) -> str:
        return beautify_result(tokens)
