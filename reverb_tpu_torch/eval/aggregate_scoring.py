"""Micro-averaged WER across fstalign JSON logs:
`python -m reverb_tpu_torch.eval.aggregate_scoring OUT_DIR`.

The port's copy of reverb_tpu/eval/aggregate_scoring.py (reference
asr/wer_evaluation/aggregate_scoring.py), over the port's eval/wer.py."""

from __future__ import annotations

import argparse
from pathlib import Path

from reverb_tpu_torch.eval.wer import WERAggregator


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Aggregate WER over fstalign JSON outputs.')
    p.add_argument('fstalign_out', type=Path)
    args = p.parse_args(argv)
    agg = WERAggregator().aggregate_dir(args.fstalign_out)
    print(agg.summary())


if __name__ == '__main__':
    main()
