"""Hermetic text language identification (the port's copy of
reverb_tpu/text/langid.py).

Capability parity with the reference's `detect_language`
(asr/wenet/dataset/processor.py:95-105), which runs the `langid` package's
pretrained hashed-n-gram Naive Bayes model restricted to the configured
language set.  That model file cannot be shipped here, so this is a
dependency-free classifier with the same call contract
(`classify(text) -> (lang, score)`, `set_languages([...])` restriction):

  1. Script vote — Unicode-block character counts decide non-Latin
     languages outright (CJK/kana/hangul/cyrillic/arabic/hebrew/greek/
     thai/devanagari).  zh-vs-ja follows the reference's own workaround
     note (processor.py:97-101): kana present → ja, han-only → zh unless
     the restriction says otherwise.
  2. Latin-script languages — per-language function-word profiles (the
     closed-class words are the most frequent and most discriminative
     tokens; sentence-level accuracy of stopword voting is high and the
     reference itself restricts to a known language set precisely because
     open-vocabulary LID is unreliable).

Returns ('en', 0.0) for empty/undecidable input, matching the untagged-is-
English policy in rev_processor.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

_SCRIPTS = (
    ('ja', ((0x3040, 0x30FF),)),                       # hiragana+katakana
    ('ko', ((0xAC00, 0xD7AF), (0x1100, 0x11FF))),      # hangul
    ('zh', ((0x4E00, 0x9FFF), (0x3400, 0x4DBF))),      # han
    ('ru', ((0x0400, 0x04FF),)),                       # cyrillic
    ('ar', ((0x0600, 0x06FF), (0x0750, 0x077F))),
    ('he', ((0x0590, 0x05FF),)),
    ('el', ((0x0370, 0x03FF),)),
    ('th', ((0x0E00, 0x0E7F),)),
    ('hi', ((0x0900, 0x097F),)),                       # devanagari
)

# closed-class function words per Latin-script language (lowercase)
_STOPWORDS = {
    'en': {'the', 'and', 'of', 'to', 'in', 'is', 'that', 'it', 'was',
           'for', 'with', 'are', 'this', 'not', 'you', 'have', 'but',
           'they', 'his', 'her', 'what', 'there', 'were', 'been', 'their',
           'would', 'will', 'from', 'had', 'has', 'can', 'all', 'we'},
    'es': {'el', 'la', 'de', 'que', 'y', 'en', 'los', 'del', 'las', 'un',
           'por', 'con', 'una', 'su', 'para', 'es', 'al', 'lo', 'como',
           'más', 'pero', 'sus', 'le', 'ya', 'o', 'este', 'sí', 'porque',
           'muy', 'sin', 'sobre', 'también', 'hasta', 'hay', 'donde'},
    'fr': {'le', 'la', 'de', 'et', 'les', 'des', 'en', 'un', 'du', 'une',
           'que', 'est', 'dans', 'qui', 'par', 'pour', 'au', 'sur', 'ne',
           'se', 'pas', 'plus', 'pouvoir', 'avec', 'tout', 'fait', 'mais',
           'comme', 'ou', 'si', 'leur', 'y', 'dire', 'elle', 'avant',
           'été', 'aux', 'cette', 'ces', 'nous', 'vous', 'ils'},
    'de': {'der', 'die', 'und', 'in', 'den', 'von', 'zu', 'das', 'mit',
           'sich', 'des', 'auf', 'für', 'ist', 'im', 'dem', 'nicht', 'ein',
           'eine', 'als', 'auch', 'es', 'an', 'werden', 'aus', 'er', 'hat',
           'dass', 'sie', 'nach', 'wird', 'bei', 'einer', 'um', 'am',
           'sind', 'noch', 'wie', 'einem', 'über', 'einen', 'so', 'zum'},
    'it': {'il', 'di', 'che', 'e', 'la', 'per', 'un', 'in', 'una', 'del',
           'con', 'non', 'sono', 'da', 'si', 'le', 'dei', 'nel', 'alla',
           'più', 'come', 'anche', 'della', 'ma', 'lo', 'se', 'gli',
           'questo', 'questa', 'hanno', 'essere', 'delle', 'al', 'ha'},
    'pt': {'o', 'a', 'de', 'que', 'e', 'do', 'da', 'em', 'um', 'para',
           'é', 'com', 'não', 'uma', 'os', 'no', 'se', 'na', 'por',
           'mais', 'as', 'dos', 'como', 'mas', 'foi', 'ao', 'ele', 'das',
           'tem', 'à', 'seu', 'sua', 'ou', 'ser', 'quando', 'muito',
           'há', 'nos', 'já', 'está', 'eu', 'também', 'só', 'pelo'},
    'nl': {'de', 'het', 'een', 'van', 'en', 'in', 'is', 'dat', 'op',
           'te', 'zijn', 'met', 'voor', 'niet', 'aan', 'er', 'om', 'ook',
           'als', 'dan', 'maar', 'bij', 'of', 'uit', 'naar', 'door',
           'over', 'ze', 'wordt', 'nog', 'wel', 'geen', 'worden', 'deze'},
}

ALL_LANGS = tuple(sorted({s for s, _ in _SCRIPTS} | set(_STOPWORDS)))


class LanguageIdentifier:
    """Mirror of langid's restricted-set classifier interface."""

    def __init__(self, langs: Optional[Iterable[str]] = None):
        self._langs = tuple(langs) if langs else None

    def set_languages(self, langs: Optional[Iterable[str]]):
        self._langs = tuple(langs) if langs else None

    def _allowed(self, lang: str) -> bool:
        return self._langs is None or lang in self._langs

    def classify(self, text: str) -> Tuple[str, float]:
        if not text:
            return self._default(), 0.0
        # 1. script vote
        counts = {}
        total_alpha = 0
        for ch in text:
            o = ord(ch)
            if ch.isalpha():
                total_alpha += 1
            for lang, ranges in _SCRIPTS:
                if any(a <= o <= b for a, b in ranges):
                    counts[lang] = counts.get(lang, 0) + 1
                    break
        if counts and total_alpha:
            # kana presence marks Japanese even though han dominates mixed
            # text (the reference's zh/ja note)
            if counts.get('ja', 0) > 0 and self._allowed('ja'):
                kana_plus_han = counts.get('ja', 0) + counts.get('zh', 0)
                if kana_plus_han / total_alpha > 0.3:
                    return 'ja', kana_plus_han / total_alpha
            best = max(counts, key=counts.get)
            if counts[best] / total_alpha > 0.3:
                if best == 'zh' and not self._allowed('zh') \
                        and self._allowed('ja'):
                    return 'ja', counts[best] / total_alpha
                if self._allowed(best):
                    return best, counts[best] / total_alpha
        # 2. Latin-script stopword vote
        words = [w.strip('.,;:!?"\'()[]').lower() for w in text.split()]
        words = [w for w in words if w]
        if not words:
            return self._default(), 0.0
        scores = {}
        for lang, sw in _STOPWORDS.items():
            if not self._allowed(lang):
                continue
            scores[lang] = sum(1 for w in words if w in sw) / len(words)
        if scores:
            best = max(scores, key=scores.get)
            if scores[best] > 0:
                return best, scores[best]
        return self._default(), 0.0

    def _default(self) -> str:
        if self._langs:
            return self._langs[0]
        return 'en'


_default_identifier = LanguageIdentifier()


def classify(text: str, limited_langs: Optional[Iterable[str]] = None
             ) -> Tuple[str, float]:
    if limited_langs:
        return LanguageIdentifier(limited_langs).classify(text)
    return _default_identifier.classify(text)
