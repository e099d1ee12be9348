"""CTC forced alignment → Praat TextGrid:
`python -m reverb_tpu_torch.bin.alignment`.

Counterpart of reverb_tpu/bin/alignment.py (reference
asr/wenet/bin/alignment.py), with the same flags plus `--device` (default
cuda; raises without a card unless `--device cpu`): align each utterance's
reference transcript to its audio with the CTC Viterbi
(decode/ctc_utils.py) and write one `<key>.TextGrid` per utterance into
`--result_dir`, one interval of `--frame_rate` seconds at each token's
peak frame.
"""

from __future__ import annotations

import argparse
import logging
import os


def _write_textgrid(path, intervals, duration):
    """intervals: list of (start_s, end_s, label)."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', '',
             'xmin = 0', f'xmax = {duration}', 'tiers? <exists>', 'size = 1',
             'item []:', '    item [1]:', '        class = "IntervalTier"',
             '        name = "tokens"', '        xmin = 0',
             f'        xmax = {duration}',
             f'        intervals: size = {len(intervals)}']
    for i, (s, e, label) in enumerate(intervals, 1):
        lines += [f'        intervals [{i}]:', f'            xmin = {s}',
                  f'            xmax = {e}',
                  f'            text = "{label}"']
    with open(path, 'w', encoding='utf8') as f:
        f.write('\n'.join(lines) + '\n')


def get_args(argv=None):
    p = argparse.ArgumentParser(description='CTC forced alignment')
    p.add_argument('--config', required=True)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--data_type', default='raw', choices=['raw', 'shard'])
    p.add_argument('--input_file', required=True, help='data list to align')
    p.add_argument('--result_dir', required=True)
    p.add_argument('--frame_rate', type=float, default=0.04,
                   help='seconds per encoder frame (4x subsample × 10 ms)')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from reverb_tpu_torch.bin.recognize import (eval_dataset,
                                                load_model_for_eval)
    from reverb_tpu_torch.cli.reverb import get_blank_id
    from reverb_tpu_torch.decode.api import encode_and_ctc
    from reverb_tpu_torch.decode.ctc_utils import (force_align,
                                                   gen_ctc_peak_time)
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.utils.common import resolve_device
    from reverb_tpu_torch.utils.config import load_config

    configs = load_config(args.config)
    dev = resolve_device(args.device)
    tokenizer = init_tokenizer(configs)
    configs, blank_id = get_blank_id(configs, tokenizer.symbol_table)
    configs['output_dim'] = len(tokenizer.symbol_table)
    model = load_model_for_eval(configs, args.checkpoint, dev, False)
    ds = eval_dataset(configs, tokenizer, args.data_type, args.input_file, 1)
    os.makedirs(args.result_dir, exist_ok=True)

    cat = torch.tensor([1.0, 0.0], device=dev)
    for batch in ds:
        with torch.inference_mode():
            _, enc_lens, ctc_probs = encode_and_ctc(
                model, torch.from_numpy(batch['feats']).to(dev),
                torch.from_numpy(batch['feats_lengths']).to(dev), cat)
            T = int(enc_lens[0])
            y = batch['target'][0][:batch['target_lengths'][0]].tolist()
            ali = force_align(ctc_probs[0][:T], y, blank_id)
        tokens = tokenizer.ids2tokens(y)
        peaks = gen_ctc_peak_time(ali, blank_id)
        intervals = []
        for tok, t in zip(tokens, peaks):
            s = t * args.frame_rate
            intervals.append((round(s, 3), round(s + args.frame_rate, 3),
                              tok))
        key = batch['keys'][0]
        _write_textgrid(os.path.join(args.result_dir, f'{key}.TextGrid'),
                        intervals, T * args.frame_rate)
        logging.info('aligned %s (%d tokens)', key, len(tokens))


if __name__ == '__main__':
    main()
