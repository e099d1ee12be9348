"""Tokenizer interfaces + char/bpe tokenizers + registry (the port's own
copy of reverb_tpu/text/tokenizer.py, for char, bpe, rev_bpe, paraformer,
and whisper and hugging_face through text/whisper_tokenizer.py).

Parity targets:
  - BaseTokenizer (tokenize = text2tokens→tokens2ids; detokenize = inverse)
      asr/wenet/text/base_tokenizer.py
  - CharTokenizer (symbol-table driven)    asr/wenet/text/char_tokenizer.py
  - init_tokenizer dispatch by configs['tokenizer']
      asr/wenet/utils/init_tokenizer.py:26-62
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple, Union


def read_symbol_table(path) -> Dict[str, int]:
    """`<token> <id>` per line (utils/file_utils.py:18-34)."""
    table = {}
    with open(path, encoding='utf8') as f:
        for line in f:
            arr = line.strip().split()
            if len(arr) >= 2:
                table[arr[0]] = int(arr[1])
    return table


def read_non_lang_symbols(path) -> List[str]:
    if path is None:
        return []
    with open(path, encoding='utf8') as f:
        return [ln.strip() for ln in f if ln.strip()]


class BaseTokenizer:
    def tokenize(self, line: str) -> Tuple[List[str], List[int]]:
        tokens = self.text2tokens(line)
        return tokens, self.tokens2ids(tokens)

    def detokenize(self, ids: List[int]) -> Tuple[str, List[str]]:
        tokens = self.ids2tokens(ids)
        return self.tokens2text(tokens), tokens

    def text2tokens(self, line: str) -> List[str]:
        raise NotImplementedError

    def tokens2text(self, tokens: List[str]) -> str:
        raise NotImplementedError

    def tokens2ids(self, tokens: List[str]) -> List[int]:
        raise NotImplementedError

    def ids2tokens(self, ids: List[int]) -> List[str]:
        raise NotImplementedError

    def vocab_size(self) -> int:
        raise NotImplementedError

    @property
    def symbol_table(self) -> Dict[str, int]:
        raise NotImplementedError


class CharTokenizer(BaseTokenizer):
    def __init__(self, symbol_table: Union[str, Dict],
                 non_lang_syms: Optional[Union[str, List]] = None,
                 split_with_space: bool = False, connect_symbol: str = '',
                 unk: str = '<unk>'):
        if isinstance(symbol_table, dict):
            self._symbol_table = dict(symbol_table)
        else:
            self._symbol_table = read_symbol_table(symbol_table)
        if isinstance(non_lang_syms, list):
            self.non_lang_syms = non_lang_syms
        else:
            self.non_lang_syms = read_non_lang_symbols(non_lang_syms)
        self.split_with_space = split_with_space
        self.connect_symbol = connect_symbol
        self.unk = unk
        self._id2sym = {v: k for k, v in self._symbol_table.items()}
        self._nls_pattern = None
        if self.non_lang_syms:
            self._nls_pattern = re.compile(
                '(' + '|'.join(re.escape(s) for s in self.non_lang_syms) + ')')

    def text2tokens(self, line: str) -> List[str]:
        line = line.strip()
        parts = self._nls_pattern.split(line) if self._nls_pattern else [line]
        tokens: List[str] = []
        for part in parts:
            if not part:
                continue
            if part in self.non_lang_syms:
                tokens.append(part)
            elif self.split_with_space:
                tokens.extend(w for w in part.split() if w)
            else:
                tokens.extend(ch for ch in part if ch != ' ')
        return tokens

    def tokens2text(self, tokens: List[str]) -> str:
        return self.connect_symbol.join(tokens)

    def tokens2ids(self, tokens: List[str]) -> List[int]:
        unk_id = self._symbol_table.get(self.unk, 0)
        return [self._symbol_table.get(t, unk_id) for t in tokens]

    def ids2tokens(self, ids: List[int]) -> List[str]:
        return [self._id2sym[i] for i in ids]

    def vocab_size(self) -> int:
        return len(self._symbol_table)

    @property
    def symbol_table(self) -> Dict[str, int]:
        return self._symbol_table


class BpeTokenizer(CharTokenizer):
    """SentencePiece-backed BPE tokenizer (asr/wenet/text/bpe_tokenizer.py)."""

    def __init__(self, bpe_model, symbol_table,
                 non_lang_syms=None, split_with_space: bool = False,
                 connect_symbol: str = '', unk: str = '<unk>'):
        super().__init__(symbol_table, non_lang_syms, split_with_space,
                         connect_symbol, unk)
        self._model_path = bpe_model
        self._sp = None

    def _build_sp(self):
        if self._sp is None:
            from reverb_tpu_torch.text.sentencepiece_model import \
                SentencePieceModel
            self._sp = SentencePieceModel(self._model_path)
        return self._sp

    def text2tokens(self, line: str) -> List[str]:
        return self._build_sp().encode(line.strip(), out_type=str)

    def tokens2text(self, tokens: List[str]) -> str:
        return ''.join(tokens).replace('▁', ' ').strip()


def init_tokenizer(configs) -> BaseTokenizer:
    """Dispatch on configs['tokenizer'] (utils/init_tokenizer.py:26-62)."""
    kind = configs.get('tokenizer', 'char')
    conf = configs.get('tokenizer_conf', {}) or {}
    if kind == 'char':
        return CharTokenizer(
            conf['symbol_table_path'],
            conf.get('non_lang_syms_path'),
            split_with_space=conf.get('split_with_space', False))
    if kind == 'bpe':
        return BpeTokenizer(
            conf['bpe_path'], conf['symbol_table_path'],
            conf.get('non_lang_syms_path'),
            split_with_space=conf.get('split_with_space', False))
    if kind == 'rev_bpe':
        from reverb_tpu_torch.text.rev_bpe import RevBpeTokenizer
        return RevBpeTokenizer(
            conf['bpe_path'], conf['symbol_table_path'],
            conf.get('non_lang_syms_path'), full_config=conf)
    if kind == 'paraformer':
        from reverb_tpu_torch.text.paraformer_tokenizer import \
            ParaformerTokenizer
        return ParaformerTokenizer(conf['symbol_table_path'],
                                   conf.get('seg_dict_path'))
    if kind == 'whisper':
        from reverb_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
        return WhisperTokenizer(
            multilingual=conf.get('is_multilingual', False),
            num_languages=conf.get('num_languages', 99))
    if kind == 'hugging_face':
        from reverb_tpu_torch.text.whisper_tokenizer import \
            HuggingFaceTokenizer
        return HuggingFaceTokenizer(conf['model'])
    raise ValueError(f"unknown tokenizer type {kind!r}")
