"""Declarative dataset construction from the dataset_conf schema (the port's
copy of reverb_tpu/data/dataset.py, with the same stage order).

Parity: asr/wenet/dataset/dataset.py:28-225 — source(raw|shard) → decode_wav
→ [speaker parse] → [deep-bias] → tokenize → filter → [special tokens] →
resample → [speed perturb] → [telephony] → [RIR] → fbank/log-mel →
[spec_aug/sub/trim] → lang/task → [cat-emb add/pass] → shuffle → sort →
batch(static|bucket|dynamic|distribute) → padded numpy batches.

`deep_bias_conf.deep_biasing` mines each utterance's context phrases and
distractors (data/deep_bias.py) and the batches carry them as `cv_list`.
`device_feats` leaves the fbank and SpecAugment to the train step
(frontend/device_feats.py): each sample carries a zero-width `feat` of its
frame count instead.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from reverb_tpu_torch.data import processor, rev_processor
from reverb_tpu_torch.data.pipeline import Pipeline, mystats
from reverb_tpu_torch.data.source import (line_source, parse_json,
                                          tar_shard_source)
from reverb_tpu_torch.frontend.fbank import FbankConfig, num_frames


def Dataset(data_type: str, data_list_file, tokenizer=None, conf=None,
            partition: bool = True, rank: int = 0, world_size: int = 1,
            seed: Optional[int] = None) -> Pipeline:
    assert conf is not None
    assert data_type in ('raw', 'shard')
    cycle = conf.get('cycle', 1)
    list_shuffle = conf.get('list_shuffle', True)
    list_shuffle_size = conf.get('list_shuffle_conf', {}).get(
        'shuffle_size', 2 ** 30)

    if data_type == 'raw':
        ds = line_source(data_list_file, partition, list_shuffle,
                         list_shuffle_size, cycle, rank, world_size, seed)
        ds = ds.map(parse_json)
    else:
        ds = tar_shard_source(data_list_file, partition, list_shuffle,
                              list_shuffle_size, cycle, rank, world_size,
                              seed)
    # num_workers ≙ DataLoader workers (train_utils.py:301-349): thread-pool
    # audio decode
    num_workers = int(conf.get('num_workers', 0) or 0)
    if num_workers > 1:
        def _decode_or_none(sample):
            try:
                return processor.decode_wav(sample)
            except Exception:                              # noqa: BLE001
                mystats['map_error'] += 1
                return None
        ds = ds.map_parallel(_decode_or_none, workers=num_workers)
        ds = ds.filter(lambda s: s is not None)
    else:
        ds = ds.map_ignore_error(processor.decode_wav)

    speaker_conf = conf.get('speaker_conf')
    if speaker_conf is not None:
        from reverb_tpu_torch.text.tokenizer import read_symbol_table
        table = read_symbol_table(speaker_conf['speaker_table_path'])

        def parse_speaker(sample):
            sample['speaker'] = table.get(str(sample.get('speaker', '')), -1)
            return sample
        ds = ds.map(parse_speaker)

    deep_bias_conf = conf.get('deep_bias_conf', {}) or {}
    if deep_bias_conf.get('deep_biasing', False):
        from reverb_tpu_torch.data.deep_bias import (get_rare_words,
                                                     rare_utt_filter,
                                                     tokenize_cv_list)
        rare_words = get_rare_words(deep_bias_conf)
        ds = ds.map(partial(rare_utt_filter, rare_words=rare_words,
                            conf=deep_bias_conf))
        # an utterance with no rare word is dropped (the JAX package hands
        # it on as None, and the next stage fails on it)
        ds = ds.filter(lambda s: s is not None)
        ds = ds.map(partial(tokenize_cv_list, tokenizer=tokenizer))

    if conf.get('speaker_switch_conf'):
        ssc = conf['speaker_switch_conf']
        ds = Pipeline(lambda d=ds: iter(
            rev_processor.generate_speaker_switch_utterances(d, ssc)))

    if tokenizer is not None:
        ds = ds.map(partial(processor.tokenize, tokenizer=tokenizer))

    ds = ds.filter(partial(processor.filter, **conf.get('filter_conf', {})))

    if conf.get('handle_special_token', False):
        handler = rev_processor.SpecialTokensHandler(
            conf.get('handle_special_token_conf', {}))
        ds = ds.map(handler.transform)
        ds = ds.filter(handler.filter)
        if tokenizer is not None:   # retokenize after text rewrites
            ds = ds.map(partial(processor.tokenize, tokenizer=tokenizer))

    if conf.get('filter_yeah_okay', False):
        ds = ds.filter(rev_processor.filter_long_yeah_okay)

    # ---- per-sample feature block: composed into ONE stage and run on the
    # worker pool.  Every op here is per-sample and stateless (augmentation
    # RNG draws are worker-order nondeterministic, exactly like the
    # reference's DataLoader workers, train_utils.py:301-349).
    feat_fns = [partial(processor.resample, **conf.get('resample_conf', {}))]

    if conf.get('speed_perturb', False):
        feat_fns.append(partial(processor.speed_perturb,
                                **conf.get('speed_perturb_conf', {})))
    if conf.get('apply_telephony', False) and 'apply_telephony_conf' in conf:
        feat_fns.append(partial(rev_processor.apply_telephony,
                                **conf['apply_telephony_conf']))
    if conf.get('apply_rir', False) and 'apply_rir_conf' in conf:
        engine = rev_processor.RIREngine(conf['apply_rir_conf'])
        feat_fns.append(engine.apply_rir)

    feats_type = conf.get('feats_type', 'fbank')
    device_feats = bool(conf.get('device_feats', False))
    if device_feats:
        # fbank and SpecAugment run in the train step on the device
        # (frontend/device_feats.py); the host only needs frame counts for
        # sort/filter/batch, carried by a zero-width feat, and the PCM that
        # processor.padding already packs
        if feats_type != 'fbank':
            raise ValueError('device_feats requires feats_type: fbank')
        if conf.get('spec_sub', False) or conf.get('spec_trim', False):
            raise ValueError('device_feats supports spec_aug only; '
                             'spec_sub/spec_trim need host features')
        fb = conf.get('fbank_conf', {}) or {}
        # the post-resample rate, so the stub's frame count is the device
        # fbank's at any rate
        rs = conf.get('resample_conf', {}) or {}
        fc = FbankConfig(sample_rate=int(rs.get('resample_rate', 16000)),
                         frame_length_ms=fb.get('frame_length', 25),
                         frame_shift_ms=fb.get('frame_shift', 10))

        def _frames_stub(sample):
            n = num_frames(sample['wav'].shape[1], fc)
            sample['feat'] = np.zeros((n, 0), np.float32)
            return sample
        feat_fns.append(_frames_stub)
    elif feats_type == 'fbank':
        feat_fns.append(partial(processor.compute_fbank,
                                **conf.get('fbank_conf', {})))
    elif feats_type == 'mfcc':
        feat_fns.append(partial(processor.compute_mfcc,
                                **conf.get('mfcc_conf', {})))
    elif feats_type == 'log_mel_spectrogram':
        feat_fns.append(partial(processor.compute_log_mel_spectrogram,
                                **conf.get('log_mel_spectrogram_conf', {})))
    else:
        raise ValueError(f'unsupported feats_type {feats_type!r}')

    if conf.get('spec_aug', True) and not device_feats:
        feat_fns.append(partial(processor.spec_aug,
                                **conf.get('spec_aug_conf', {})))
    if conf.get('spec_sub', False):
        feat_fns.append(partial(processor.spec_sub,
                                **conf.get('spec_sub_conf', {})))
    if conf.get('spec_trim', False):
        feat_fns.append(partial(processor.spec_trim,
                                **conf.get('spec_trim_conf', {})))

    lang_conf = conf.get('language_conf', {'limited_langs': ['en']})
    feat_fns.append(partial(processor.detect_language, **lang_conf))
    feat_fns.append(processor.detect_task)

    cat_emb_conf = conf.get('cat_emb_conf', {})
    if conf.get('add_cat_emb', False):
        feat_fns.append(partial(rev_processor.add_one_hot, **cat_emb_conf))
    pass_cat_emb = conf.get('pass_cat_emb', False)
    if pass_cat_emb:
        feat_fns.append(partial(rev_processor.pass_one_hot, **cat_emb_conf))

    def _feature_block(sample, fns=tuple(feat_fns)):
        for f in fns:
            sample = f(sample)
        return sample

    if num_workers > 1:
        ds = ds.map_parallel(_feature_block, workers=num_workers)
    else:
        ds = ds.map(_feature_block)

    if conf.get('shuffle', True):
        ds = ds.shuffle(conf.get('shuffle_conf', {}).get('shuffle_size',
                                                         10000), seed=seed)
    if conf.get('sort', True):
        ds = ds.sort(conf.get('sort_conf', {}).get('sort_size', 500),
                     key_func=processor.sort_by_feats)

    batch_conf = conf.get('batch_conf', {}) or {}
    batch_type = batch_conf.get('batch_type', 'static')
    pad_mult = batch_conf.get('pad_len_multiple', 0)
    wrapper = partial(processor.padding, pass_cat_emb=pass_cat_emb,
                      deep_biasing_conf=deep_bias_conf,
                      pad_len_multiple=pad_mult)
    if batch_type == 'static':
        ds = ds.batch(batch_conf.get('batch_size', 16), wrapper_class=wrapper)
    elif batch_type == 'bucket':
        ds = ds.bucket_by_sequence_length(
            processor.feats_length_fn, batch_conf['bucket_boundaries'],
            batch_conf['bucket_batch_sizes'], wrapper_class=wrapper)
    elif batch_type == 'distribute':
        ds = ds.distribute_batch(
            processor.DynamicBatchWindow(
                batch_conf.get('max_frames_in_batch', 12000)),
            wrapper_class=wrapper,
            one_utt_per_job=batch_conf.get('distrib_one_utt_per_job', True),
            max_words_per_epoch=batch_conf.get(
                'distrib_max_word_count_per_epoch', -1),
            max_words_per_batch=batch_conf.get(
                'distrib_max_word_count_per_batch', -1))
    else:
        ds = ds.dynamic_batch(
            processor.DynamicBatchWindow(
                batch_conf.get('max_frames_in_batch', 12000)),
            wrapper_class=wrapper)
    return ds
