"""Per-utterance loss scoring for data filtering:
`python -m reverb_tpu_torch.bin.get_loss`.

Counterpart of reverb_tpu/bin/get_loss.py (reference
asr/wenet/bin/get_loss.py): run the model over a data list and write
`key loss loss_att loss_ctc` per utterance (used to mine bad transcripts).
`--device` (default cuda; raises without a card unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import logging


def get_args(argv=None):
    p = argparse.ArgumentParser(description='score per-utterance losses')
    p.add_argument('--config', required=True)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--data_type', default='raw', choices=['raw', 'shard'])
    p.add_argument('--test_data', required=True)
    p.add_argument('--output', required=True)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from reverb_tpu_torch.bin.recognize import (load_model_for_eval,
                                                eval_dataset)
    from reverb_tpu_torch.cli.reverb import get_blank_id
    from reverb_tpu_torch.models.asr_model import compute_loss
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.train.executor import CV_SEED, _device_batch
    from reverb_tpu_torch.utils.common import resolve_device
    from reverb_tpu_torch.utils.config import load_config

    configs = load_config(args.config)
    dev = resolve_device(args.device)
    tokenizer = init_tokenizer(configs)
    configs, _ = get_blank_id(configs, tokenizer.symbol_table)
    configs['output_dim'] = len(tokenizer.symbol_table)
    model = load_model_for_eval(configs, args.checkpoint, dev, False)

    ds = eval_dataset(configs, tokenizer, args.data_type, args.test_data, 1)

    # a dynamic-chunk model draws each utterance's chunk from this
    # generator (no dropout): the executor's CV seed
    gen = torch.Generator(device=dev).manual_seed(CV_SEED)
    with open(args.output, 'w') as out, torch.no_grad():
        for batch in ds:
            m = compute_loss(model, _device_batch(batch, dev), None,
                             chunk_generator=gen)
            out.write(f"{batch['keys'][0]} {float(m['loss']):.4f} "
                      f"{float(m['loss_att']):.4f} "
                      f"{float(m['loss_ctc']):.4f}\n")


if __name__ == '__main__':
    main()
