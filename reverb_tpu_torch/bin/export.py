"""Export the serving function set to disk (the port's `reverb-export`).

Counterpart of reverb_tpu/bin/export.py with the same flags, plus
`--device` (default cuda; no silent CPU fallback):

  - `--format pt2` (default; the counterpart of `stablehlo`): one
    `torch.export` program per subgraph (encoder_chunk / ctc_activation /
    attention_decoder) with its weights inside, `<name>.pt2`, and a
    manifest.json; load one with reverb_tpu_torch.export.aot.load_serialized;
  - `--format aot`: build the CUDA kernel library into `--output_dir` and
    run each subgraph once, so a serving process started with
    REVERB_KERNEL_DIR=<output_dir> compiles nothing (the counterpart of
    priming XLA's persistent cache).

    python -m reverb_tpu_torch.bin.export --config train.yaml \
        --checkpoint final.npz --output_dir exported/
"""

from __future__ import annotations

import argparse
import sys

FORMATS = ('pt2', 'aot')


def get_args(argv=None):
    p = argparse.ArgumentParser(description='export serving functions '
                                            '(PyTorch/CUDA port)')
    p.add_argument('--config', required=True, help='train/config yaml')
    p.add_argument('--checkpoint', required=True, help='.npz or .pt ckpt')
    p.add_argument('--output_dir', required=True)
    p.add_argument('--format', default='pt2',
                   help='pt2 (torch.export programs) or aot (a primed '
                        'kernel directory)')
    p.add_argument('--chunk_size', type=int, default=16,
                   help='decoding chunk (encoder frames)')
    p.add_argument('--num_left_chunks', type=int, default=16)
    p.add_argument('--batch_size', type=int, default=1)
    p.add_argument('--rescoring_nbest', type=int, default=10)
    p.add_argument('--max_hyp_len', type=int, default=64)
    p.add_argument('--device', default='cuda',
                   help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    args = p.parse_args(argv)
    if args.format not in FORMATS:
        hint = (' (stablehlo is the JAX package\'s artifact; the port writes '
                'torch.export programs: --format pt2)'
                if args.format == 'stablehlo' else '')
        p.error(f'--format {args.format!r} is not one of {FORMATS}{hint}')
    return args


def main(argv=None):
    args = get_args(argv)
    from reverb_tpu_torch.cli.reverb import ReverbASR
    from reverb_tpu_torch.export import aot

    asr = ReverbASR(args.config, args.checkpoint, device=args.device)
    kw = dict(chunk_size=args.chunk_size,
              num_left_chunks=args.num_left_chunks,
              batch_size=args.batch_size,
              rescoring_nbest=args.rescoring_nbest,
              max_hyp_len=args.max_hyp_len)
    if args.format == 'pt2':
        paths = aot.serialize_serving_functions(asr.model, args.output_dir,
                                                **kw)
        for name, path in sorted(paths.items()):
            print(f'exported {name} -> {path}')
    else:
        info = aot.prime_kernel_dir(asr.model, args.output_dir, **kw)
        for name in sorted(aot.NAMES):
            print(f'compiled {name} (cache primed in {args.output_dir})')
        print(f"window={info['window']} cache_t={info['cache_t']}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
