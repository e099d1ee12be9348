"""`reverb`-style console entry on PyTorch: transcribe one audio file, write
one CTM per mode (`result_dir/<mode>/<audio>.ctm`).

Counterpart of reverb_tpu/cli/recognize_wav.py with the same flags and
defaults, plus `--device` (default cuda; no silent CPU fallback).  Every
mode runs; the streaming flags go to `transcribe_modes` as in the JAX
package (`--decoding_chunk_size` reaches the encoder as a chunk mask on a
use_dynamic_chunk model, `--num_decoding_left_chunks` and
`--simulate_streaming` are accepted with no effect there), `--quantize
int8` serves the int8 model, and `--data_parallel N` serves with N model
replicas on cuda:0..N-1 (cli/reverb.py).
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

MODES = ['attention', 'ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'joint_decoding', 'onmt_attention_decoding']


def get_args(argv=None):
    parser = argparse.ArgumentParser(description='transcribe with reverb '
                                                 '(PyTorch/CUDA port)')
    parser.add_argument('--audio_file', required=True,
                        help='Audio to transcribe')
    parser.add_argument('--config', default=None, help='Path to config file')
    parser.add_argument('--checkpoint', default=None,
                        help='Path to Reverb model checkpoint')
    parser.add_argument('--model', default=None,
                        help='Path to directory containing config + ckpt')
    parser.add_argument('--gpu', type=int, default=-1,
                        help='accepted for CLI parity; use --device')
    parser.add_argument('--device', default='cuda',
                        help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    parser.add_argument('--tokenizer-symbols', help='Path to tk.units.txt')
    parser.add_argument('--bpe-path', help='Path to tk.model')
    parser.add_argument('--cmvn-path', help='Path to cmvn stats')
    parser.add_argument('--beam_size', type=int, default=10)
    parser.add_argument('--length_penalty', type=float, default=0.0)
    parser.add_argument('--blank_penalty', type=float, default=0.0)
    parser.add_argument('--result_dir', required=True)
    parser.add_argument('--batch_size', type=int, default=0,
                        help='chunks decoded in parallel '
                             '(0 = auto: batch all chunks, capped at 8)')
    parser.add_argument('--chunk_size', type=int, default=2051,
                        help='chunk size in 10ms frames')
    parser.add_argument('--modes', nargs='+', choices=MODES,
                        default=['attention_rescoring'])
    parser.add_argument('--ctc_weight', type=float, default=0.1)
    parser.add_argument('--decoding_chunk_size', type=int, default=-1)
    parser.add_argument('--num_decoding_left_chunks', type=int, default=-1)
    parser.add_argument('--simulate_streaming', action='store_true')
    parser.add_argument('--reverse_weight', type=float, default=0.0)
    parser.add_argument('--overwrite_cmvn', action='store_true')
    parser.add_argument('--verbatimicity', type=float, default=1.0,
                        help='0.0 = nonverbatim, 1.0 = verbatim (LSL input)')
    parser.add_argument('--timings_adjustment', type=float, default=230,
                        help='ms adjustment of word timings')
    parser.add_argument('--quantize', default='none',
                        choices=['none', 'int8'],
                        help='int8: post-training-quantized serving path')
    parser.add_argument('--compute_dtype', default='float32',
                        choices=['float32', 'bfloat16'])
    parser.add_argument('--data_parallel', type=int, default=0,
                        help='split each chunk batch over N model replicas '
                             'on cuda:0..N-1 (data-parallel serving; 0 = '
                             'one device)')
    parser.add_argument('--log_level', default='INFO')
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format='%(asctime)s %(filename)s %(levelname)s: %(message)s')
    from reverb_tpu_torch.cli.reverb import ReverbASR, load_model

    model_set = args.model is not None
    cfg_ckpt_set = args.checkpoint is not None and args.config is not None
    if model_set == cfg_ckpt_set:
        raise RuntimeError(
            'One of either --model or (--checkpoint and --config) must be set.')
    if model_set:
        model = load_model(args.model, compute_dtype=args.compute_dtype,
                           quantize=args.quantize, device=args.device,
                           data_parallel=args.data_parallel)
    else:
        model = ReverbASR(args.config, args.checkpoint,
                          cmvn_path=args.cmvn_path,
                          tokenizer_symbols=args.tokenizer_symbols,
                          bpe_path=args.bpe_path,
                          compute_dtype=args.compute_dtype,
                          quantize=args.quantize, device=args.device,
                          data_parallel=args.data_parallel)

    files = {}
    for mode in args.modes:
        dir_name = os.path.join(args.result_dir, mode)
        os.makedirs(dir_name, exist_ok=True)
        files[mode] = Path(dir_name) / Path(args.audio_file).with_suffix(
            '.ctm').name

    outputs = model.transcribe_modes(
        args.audio_file, modes=args.modes, format='ctm',
        verbatimicity=args.verbatimicity, chunk_size=args.chunk_size,
        batch_size=args.batch_size, beam_size=args.beam_size,
        decoding_chunk_size=args.decoding_chunk_size,
        num_decoding_left_chunks=args.num_decoding_left_chunks,
        ctc_weight=args.ctc_weight,
        simulate_streaming=args.simulate_streaming,
        reverse_weight=args.reverse_weight, blank_penalty=args.blank_penalty,
        length_penalty=args.length_penalty,
        timings_adjustment=args.timings_adjustment)
    for mode, out in zip(args.modes, outputs):
        with files[mode].open('w') as fp:
            fp.write(out)


if __name__ == '__main__':
    main()
