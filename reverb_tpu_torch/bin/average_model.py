"""Checkpoint averaging: `python -m reverb_tpu_torch.bin.average_model`.

Counterpart of reverb_tpu/bin/average_model.py (reference
asr/wenet/bin/average_model.py — the best/last N checkpoints, best-N by
cv_loss from the sidecar yamls — and average_model_fixed_list.py via
--models).  Works on the `.npz` files of either package, on the host.
"""

from __future__ import annotations

import argparse
import glob
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description='average model checkpoints')
    p.add_argument('--dst_model', required=True)
    p.add_argument('--src_path', default=None,
                   help='model dir containing *.npz + *.yaml')
    p.add_argument('--models', nargs='+', default=None,
                   help='explicit checkpoint list (average_model_fixed_list)')
    p.add_argument('--num', type=int, default=5)
    p.add_argument('--val_best', action='store_true',
                   help='pick best-N by cv_loss (else last-N by step)')
    p.add_argument('--min_epoch', type=int, default=0)
    p.add_argument('--max_epoch', type=int, default=10 ** 9)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from reverb_tpu_torch.train.checkpoint import (average_checkpoints,
                                                   find_best_checkpoints)
    from reverb_tpu_torch.utils.config import load_config
    if args.models:
        print(f'averaging {len(args.models)} checkpoints: {args.models}')
        average_checkpoints(args.models, args.dst_model)
        return
    assert args.src_path, 'need --src_path or --models'
    if args.val_best:
        paths = find_best_checkpoints(args.src_path, args.num)
    else:
        scored = []
        for y in glob.glob(os.path.join(args.src_path, '*.yaml')):
            info = load_config(y) or {}
            npz = y[:-5] + '.npz'
            ep = info.get('epoch', -1)
            if os.path.exists(npz) and args.min_epoch <= ep <= args.max_epoch:
                scored.append((info.get('step', 0), npz))
        scored.sort(reverse=True)
        paths = [p for _, p in scored[:args.num]]
    assert paths, f'no checkpoints found in {args.src_path}'
    print(f'averaging {len(paths)} checkpoints: {paths}')
    average_checkpoints(paths, args.dst_model)


if __name__ == '__main__':
    main()
