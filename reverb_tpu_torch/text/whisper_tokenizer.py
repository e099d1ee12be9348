"""Whisper's tokenizer and any HuggingFace tokenizer, behind a gated import.

Counterpart of reverb_tpu/text/whisper_tokenizer.py: both wrap a
`transformers` tokenizer, which is imported, and built from the hub name
or a local directory, at first use (building the wrapper imports nothing).
Without `transformers` the first use raises ImportError.
"""

from __future__ import annotations

from typing import Dict, List

from reverb_tpu_torch.text.tokenizer import BaseTokenizer


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError('the whisper and hugging_face tokenizers need the '
                          'transformers package') from e
    return transformers


class _HFWrapped(BaseTokenizer):
    """The BaseTokenizer methods over a lazily built HF tokenizer."""

    _tok = None

    def _load(self):
        raise NotImplementedError

    def _build(self):
        if self._tok is None:
            self._tok = self._load()
        return self._tok

    def text2tokens(self, line: str) -> List[str]:
        return self._build().tokenize(line)

    def tokens2text(self, tokens: List[str]) -> str:
        return self._build().convert_tokens_to_string(tokens)

    def tokens2ids(self, tokens: List[str]) -> List[int]:
        return self._build().convert_tokens_to_ids(tokens)

    def ids2tokens(self, ids: List[int]) -> List[str]:
        return self._build().convert_ids_to_tokens(ids)

    def vocab_size(self) -> int:
        return len(self._build())

    @property
    def symbol_table(self) -> Dict[str, int]:
        return self._build().get_vocab()


class WhisperTokenizer(_HFWrapped):
    """`openai/whisper-tiny` (multilingual) or `openai/whisper-tiny.en`,
    with the language and task set."""

    def __init__(self, multilingual: bool = False, num_languages: int = 99,
                 language: str = 'en', task: str = 'transcribe'):
        self.multilingual = multilingual
        self.num_languages = num_languages
        self.language = language
        self.task = task

    def _load(self):
        name = ('openai/whisper-tiny' if self.multilingual
                else 'openai/whisper-tiny.en')
        return _transformers().WhisperTokenizer.from_pretrained(
            name, language=self.language, task=self.task)


class HuggingFaceTokenizer(_HFWrapped):
    """Any `transformers.AutoTokenizer` by name or path."""

    def __init__(self, model: str):
        self.model = model

    def _load(self):
        return _transformers().AutoTokenizer.from_pretrained(self.model)
