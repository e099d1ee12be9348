"""Batch dataset decoding for WER: `python -m reverb_tpu_torch.bin.recognize`.

Counterpart of reverb_tpu/bin/recognize.py (reference
asr/wenet/bin/recognize.py:29-368): decode a raw/shard data list with one
or more modes (augmentation off, static batching, the data list's order)
and write one `text` file per mode under result_dir/<mode>/.  `--device`
(default cuda; raises without a card unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import logging
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description='batch recognize (PyTorch)')
    p.add_argument('--config', required=True, help='train/model config yaml')
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--data_type', default='raw', choices=['raw', 'shard'])
    p.add_argument('--test_data', required=True)
    p.add_argument('--result_dir', required=True)
    p.add_argument('--modes', nargs='+', default=['attention_rescoring'])
    p.add_argument('--batch_size', type=int, default=16)
    p.add_argument('--beam_size', type=int, default=10)
    p.add_argument('--ctc_weight', type=float, default=0.1)
    p.add_argument('--reverse_weight', type=float, default=0.0)
    p.add_argument('--blank_penalty', type=float, default=0.0)
    p.add_argument('--length_penalty', type=float, default=0.0)
    p.add_argument('--verbatimicity', type=float, default=1.0)
    p.add_argument('--override_config', action='append', default=[])
    # HLG decoding (reference recognize.py --hlg/--word/--*_scale flags)
    p.add_argument('--hlg', default='', help='HLG graph (OpenFST text)')
    p.add_argument('--word', default='', help='word symbol table path')
    p.add_argument('--lm_scale', type=float, default=0.0)
    p.add_argument('--decoder_scale', type=float, default=0.0)
    p.add_argument('--r_decoder_scale', type=float, default=0.0)
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    return p.parse_args(argv)


def load_model_for_eval(configs, checkpoint, dev, inject_cmvn: bool):
    """The checkpoint's model on `dev` in eval mode; with inject_cmvn the
    config's cmvn_file stats are added when the checkpoint has none."""
    from reverb_tpu_torch.convert import (load_flat_checkpoint,
                                          state_dict_from_jax)
    from reverb_tpu_torch.frontend.cmvn import load_cmvn
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    flat = load_flat_checkpoint(checkpoint)
    cmvn_conf = configs.get('cmvn_conf', {}) or {}
    if inject_cmvn and 'encoder.global_cmvn.mean' not in flat and \
            cmvn_conf.get('cmvn_file'):
        mean, istd = load_cmvn(cmvn_conf['cmvn_file'],
                               cmvn_conf.get('is_json_cmvn', True))
        flat['encoder.global_cmvn.mean'] = mean
        flat['encoder.global_cmvn.istd'] = istd
    return build_model(ModelConfig.from_config(configs), dev,
                       state_dict_from_jax(flat))


def eval_dataset(configs, tokenizer, data_type: str, data_list: str,
                 batch_size: int):
    """The test pipeline of recognize and get_loss (recognize.py:196-233):
    no augmentation, no shuffle or sort, one pass, static batches."""
    from reverb_tpu_torch.data.dataset import Dataset
    conf = dict(configs['dataset_conf'])
    for k in ('spec_aug', 'spec_sub', 'spec_trim', 'speed_perturb',
              'apply_telephony', 'apply_rir', 'shuffle', 'sort'):
        conf[k] = False
    conf['cycle'] = 1
    conf['batch_conf'] = {'batch_type': 'static', 'batch_size': batch_size}
    return Dataset(data_type, data_list, tokenizer, conf, partition=False)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    import numpy as np

    from reverb_tpu_torch.cli.reverb import get_blank_id
    from reverb_tpu_torch.decode.api import decode
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.utils.common import resolve_device
    from reverb_tpu_torch.utils.config import load_config, override_config

    configs = override_config(load_config(args.config), args.override_config)
    dev = resolve_device(args.device)
    tokenizer = init_tokenizer(configs)
    configs, _ = get_blank_id(configs, tokenizer.symbol_table)
    configs['output_dim'] = len(tokenizer.symbol_table)

    ds = eval_dataset(configs, tokenizer, args.data_type, args.test_data,
                      args.batch_size)
    model = load_model_for_eval(configs, args.checkpoint, dev, True)

    files = {}
    for mode in args.modes:
        d = os.path.join(args.result_dir, mode)
        os.makedirs(d, exist_ok=True)
        files[mode] = open(os.path.join(d, 'text'), 'w', encoding='utf8')

    cat_embs = np.asarray([args.verbatimicity, 1 - args.verbatimicity],
                          np.float32)
    hlg_graph, word_table = None, {}
    if any(m.startswith('hlg') for m in args.modes):
        from reverb_tpu_torch.decode.hlg import Fst
        hlg_graph = Fst.load(args.hlg)
        if args.word:
            with open(args.word, encoding='utf8') as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        word_table[int(parts[1])] = parts[0]
    n = 0
    try:
        for batch in ds:
            results = decode(
                model, args.modes, batch['feats'], batch['feats_lengths'],
                beam_size=args.beam_size, ctc_weight=args.ctc_weight,
                reverse_weight=args.reverse_weight,
                blank_penalty=args.blank_penalty,
                length_penalty=args.length_penalty, cat_embs=cat_embs,
                hlg_graph=hlg_graph, hlg_lm_scale=args.lm_scale,
                hlg_decoder_scale=args.decoder_scale,
                hlg_r_decoder_scale=args.r_decoder_scale)
            for mode in args.modes:
                for key, res in zip(batch['keys'], results[mode]):
                    if mode.startswith('hlg'):
                        # hlg results carry word ids (get_texts semantics)
                        text = ' '.join(word_table.get(w, str(w))
                                        for w in res.tokens)
                    else:
                        text, _ = tokenizer.detokenize(res.tokens)
                    files[mode].write(f'{key} {text}\n')
            n += len(batch['keys'])
            logging.info('decoded %d utterances', n)
    finally:
        for f in files.values():
            f.close()


if __name__ == '__main__':
    main()
