"""Reverb's production tokenizer (the port's own copy of
reverb_tpu/text/rev_bpe.py).

Parity: asr/wenet/text/rev_bpe_tokenizer.py:10-83 — sentencepiece BPE with
`<sw>` removal, `<unk>`→`<unknown>` rewrite, lazy model build (so DataLoader
worker processes don't share C++ state — here the parser is pure python but
lazy build is kept for pickling friendliness), and '▁'-joined detokenization.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from reverb_tpu_torch.text.tokenizer import CharTokenizer


class RevBpeTokenizer(CharTokenizer):
    def __init__(self, bpe_model, symbol_table,
                 non_lang_syms=None, split_with_space: bool = False,
                 connect_symbol: str = '', unk: str = '<unk>',
                 full_config: Optional[Dict] = None):
        super().__init__(symbol_table, non_lang_syms, split_with_space,
                         connect_symbol, unk)
        full_config = full_config or {}
        self.remove_sw = full_config.get('remove_sw', True)
        self.replace_unk_as_unknown = full_config.get(
            'replace_unk_as_unknown', True)
        self._model_path = bpe_model
        self._sp = None

    def _build_sp(self):
        if self._sp is None:
            from reverb_tpu_torch.text.sentencepiece_model import \
                SentencePieceModel
            self._sp = SentencePieceModel(self._model_path)
        return self._sp

    def text2tokens(self, line: str) -> List[str]:
        line = line.strip()
        if self.remove_sw:
            line = line.replace('<sw>', '').replace('  ', ' ').strip()
        if self.replace_unk_as_unknown:
            line = line.replace('<unk>', '<unknown>')
        return self._build_sp().encode(line, out_type=str)

    def tokens2text(self, tokens: List[str]) -> str:
        return self.connect_symbol.join(tokens).replace('▁', ' ').strip()
