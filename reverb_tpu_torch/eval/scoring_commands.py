"""One fstalign command per hypothesis CTM:
`python -m reverb_tpu_torch.eval.scoring_commands FSTALIGN REF HYP OUT`.

The port's copy of reverb_tpu/eval/scoring_commands.py (reference
asr/wer_evaluation/scoring_commands.py), over the port's eval/wer.py."""

from __future__ import annotations

import argparse
from pathlib import Path

from reverb_tpu_torch.eval.wer import fstalign_commands


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Generate fstalign commands for a test suite '
                    '(hyp CTMs vs ref NLPs).')
    p.add_argument('fstalign', type=Path)
    p.add_argument('ref', type=Path)
    p.add_argument('hyp', type=Path)
    p.add_argument('out', type=Path)
    p.add_argument('--ref-norm', type=Path, default=None)
    p.add_argument('--synonyms-file', type=Path, default=None)
    args = p.parse_args(argv)
    for cmd in fstalign_commands(args.fstalign, args.ref, args.hyp, args.out,
                                 args.ref_norm, args.synonyms_file):
        print(cmd)


if __name__ == '__main__':
    main()
