"""Long-form WER harness (a copy of reverb_tpu/eval/wer.py).

Parity targets (asr/wer_evaluation/):
  - scoring_commands.py:52-120 → `fstalign_commands`: emit one
    `fstalign wer --ref X.nlp --hyp X.ctm --json-log out.json
    [--ref-json norms] [--syn synonyms]` command per file (fstalign stays an
    external binary, off the serving path).
  - aggregate_scoring.py:26-114 → `WERAggregator`: micro-average
    insert/delete/sub counts across fstalign JSON logs.

Additions (no reference counterpart): a pure-python Levenshtein word aligner
(`align_words` / `score_pair`) that produces fstalign-shaped
{'wer': {'bestWER': {...}}} JSON, so WER regression tests run hermetically
when the fstalign binary is unavailable.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def fstalign_commands(fstalign: Path, ref: Path, hyp: Path, out: Path,
                      ref_norm: Optional[Path] = None,
                      synonyms_file: Optional[Path] = None) -> List[str]:
    """One alignment command per hypothesis CTM (directory or single file)."""
    ref, hyp, out = Path(ref), Path(hyp), Path(out)
    out.mkdir(parents=True, exist_ok=True)
    pairs = []
    if hyp.is_dir():
        for hyp_file in sorted(hyp.glob('**/*.ctm')):
            stem = hyp_file.stem
            norm = (Path(ref_norm) / f'{stem}.norm.json') if ref_norm else None
            pairs.append((ref / f'{stem}.nlp', hyp_file,
                          out / f'{stem}.log.json', norm))
    else:
        pairs.append((ref, hyp, out / f'{hyp.stem}.log.json',
                      Path(ref_norm) if ref_norm else None))
    cmds = []
    for ref_f, hyp_f, out_f, norm_f in pairs:
        cmd = [str(fstalign), 'wer', '--ref', str(ref_f), '--hyp', str(hyp_f),
               '--json-log', str(out_f)]
        if norm_f:
            cmd += ['--ref-json', str(norm_f)]
        if synonyms_file:
            cmd += ['--syn', str(synonyms_file)]
        cmds.append(' '.join(cmd))
    return cmds


@dataclass
class WERAggregator:
    """Micro-averaged WER across fstalign JSON logs
    (aggregate_scoring.py:26-114)."""
    insertion_count: int = 0
    deletion_count: int = 0
    substitution_count: int = 0
    correct_count: int = 0
    reference_count: int = 0

    def update(self, d: Dict):
        self.insertion_count += d['insertions']
        self.deletion_count += d['deletions']
        self.substitution_count += (d['numErrors'] - d['insertions']
                                    - d['deletions'])
        self.correct_count += (d['numWordsInReference'] - d['substitutions']
                               - d['deletions'])
        self.reference_count += d['numWordsInReference']

    @property
    def num_errors(self):
        return (self.insertion_count + self.deletion_count
                + self.substitution_count)

    def wer(self) -> float:
        assert self.reference_count > 0
        return self.num_errors / self.reference_count

    def summary(self) -> str:
        n = self.reference_count

        def fmt(title, num):
            return f'{title}:\t{num}/{n} = {num / n:3.2%}'
        return '\n'.join([
            fmt('TOTAL WER', self.num_errors),
            fmt('Insertion Rate', self.insertion_count),
            fmt('Deletion Rate', self.deletion_count),
            fmt('Substitution Rate', self.substitution_count)])

    def aggregate_dir(self, out_dir: Path) -> 'WERAggregator':
        for path in Path(out_dir).glob('*.json'):
            with open(path) as f:
                self.update(json.load(f)['wer']['bestWER'])
        return self


# ------------------------- built-in aligner -------------------------

def align_words(ref: List[str], hyp: List[str]
                ) -> Tuple[int, int, int, List[Tuple[str, str, str]]]:
    """Levenshtein word alignment → (ins, del, sub, ops).

    ops: list of (op, ref_word, hyp_word) with op ∈ {ok, sub, ins, del}.
    """
    R, H = len(ref), len(hyp)
    dist = [[0] * (H + 1) for _ in range(R + 1)]
    for i in range(1, R + 1):
        dist[i][0] = i
    for j in range(1, H + 1):
        dist[0][j] = j
    for i in range(1, R + 1):
        ri = ref[i - 1]
        row, prev = dist[i], dist[i - 1]
        for j in range(1, H + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            row[j] = min(sub, prev[j] + 1, row[j - 1] + 1)
    ops = []
    i, j = R, H
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                dist[i][j] == dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            ops.append(('ok' if ref[i - 1] == hyp[j - 1] else 'sub',
                        ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            ops.append(('del', ref[i - 1], ''))
            i -= 1
        else:
            ops.append(('ins', '', hyp[j - 1]))
            j -= 1
    ops.reverse()
    n_ins = sum(1 for o, _, _ in ops if o == 'ins')
    n_del = sum(1 for o, _, _ in ops if o == 'del')
    n_sub = sum(1 for o, _, _ in ops if o == 'sub')
    return n_ins, n_del, n_sub, ops


def _normalize(text: str) -> List[str]:
    return [w for w in text.lower().replace(',', ' ').replace('.', ' ')
            .replace('?', ' ').replace('!', ' ').split() if w]


def score_pair(ref_text: str, hyp_text: str) -> Dict:
    """fstalign-shaped WER record for one (ref, hyp) pair."""
    ref = _normalize(ref_text)
    hyp = _normalize(hyp_text)
    ins, dels, subs, _ = align_words(ref, hyp)
    return {'wer': {'bestWER': {
        'insertions': ins, 'deletions': dels, 'substitutions': subs,
        'numErrors': ins + dels + subs,
        'numWordsInReference': len(ref),
    }}}


def score_files(ref_path, hyp_path) -> Dict:
    with open(ref_path, encoding='utf8') as f:
        ref_text = f.read()
    with open(hyp_path, encoding='utf8') as f:
        hyp_text = f.read()
    if str(hyp_path).endswith('.ctm'):
        hyp_text = ' '.join(
            line.split()[4] for line in hyp_text.splitlines()
            if len(line.split()) >= 5)
    return score_pair(ref_text, hyp_text)
