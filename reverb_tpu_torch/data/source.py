"""Data sources: raw jsonl lists and tar/zip shard archives (the port's copy
of reverb_tpu/data/source.py).

Parity targets (asr/wenet/dataset/datapipes.py):
  - TextLineDataPipe + WenetRawDatasetSource (:442-470, 767-790)
  - tar shard readers (:628-700, 701-766) — shard = tar of {key.wav, key.txt,
    key.<field>} entry groups
  - ZipsDataPipe (:541-627)
  - ShardDataPipe rank×worker partitioning (:416-439)
  - cycle + stage-1 list shuffle (dataset.py:46-54)
"""

from __future__ import annotations

import io
import json
import random
import tarfile
import zipfile
from typing import Iterator, Optional

from reverb_tpu_torch.data.pipeline import Pipeline, mystats


def _read_lines(path):
    with open(path, encoding='utf8') as f:
        for line in f:
            line = line.strip()
            if line:
                yield line


def _partition(items, rank: int, world_size: int):
    for i, x in enumerate(items):
        if i % world_size == rank:
            yield x


def line_source(data_list_file, partition: bool = True, shuffle: bool = True,
                shuffle_size: int = 2 ** 30, cycle: int = 1,
                rank: int = 0, world_size: int = 1,
                seed: Optional[int] = None) -> Pipeline:
    """Stage-1 source: lines of the list file, shuffled per epoch, partitioned
    across ranks, cycled `cycle` times."""
    def gen():
        lines = list(_read_lines(data_list_file))
        rng = random.Random(seed)
        for epoch in range(max(cycle, 1)):
            ls = list(lines)
            if shuffle:
                if len(ls) > shuffle_size:
                    ls = ls[:shuffle_size]
                rng.shuffle(ls)
            it = _partition(ls, rank, world_size) if partition else iter(ls)
            yield from it
    return Pipeline(gen)


def parse_json(line: str) -> dict:
    """raw list line → sample dict (processor.parse_json)."""
    obj = json.loads(line)
    assert 'key' in obj and 'wav' in obj and 'txt' in obj, obj
    return obj


def _group_tar_members(tar) -> Iterator[dict]:
    """Group tar entries by example key: `<key>.<ext>` files become fields."""
    prev_key = None
    example: dict = {}
    for member in tar:
        if not member.isfile():
            continue
        name = member.name
        base, _, ext = name.rpartition('.')
        key = base.split('/')[-1]
        if prev_key is not None and key != prev_key:
            if 'wav' in example or 'flac' in example or 'mp3' in example:
                yield example
            example = {}
        prev_key = key
        data = tar.extractfile(member).read()
        if ext in ('wav', 'flac', 'mp3', 'ogg', 'opus'):
            example['key'] = key
            example['wav'] = data          # raw bytes; decode_wav handles it
            example['audio_format'] = ext
        elif ext == 'txt':
            example['key'] = key
            example['txt'] = data.decode('utf8').strip()
        else:
            example[ext] = data
    if example and ('wav' in example):
        yield example


def tar_shard_source(data_list_file, partition: bool = True,
                     shuffle: bool = True, shuffle_size: int = 2 ** 30,
                     cycle: int = 1, rank: int = 0, world_size: int = 1,
                     seed: Optional[int] = None) -> Pipeline:
    """Shard source: each list line is a tar path (or URL); yields samples."""
    lines = line_source(data_list_file, partition, shuffle, shuffle_size,
                        cycle, rank, world_size, seed)

    def expand(path):
        try:
            with tarfile.open(path, 'r:*') as tar:
                yield from _group_tar_members(tar)
        except Exception as e:                  # noqa: BLE001
            mystats['bad_shard'] += 1
            import logging
            logging.warning('skipping shard %s: %r', path, e)
    return lines.flat_map(expand)


def zip_shard_source(data_list_file, **kwargs) -> Pipeline:
    """Zip shards: entries `<key>.wav` / `<key>.txt` (datapipes.py:541-627)."""
    lines = line_source(data_list_file, **kwargs)

    def expand(path):
        try:
            with zipfile.ZipFile(path) as zf:
                groups: dict = {}
                for name in zf.namelist():
                    base, _, ext = name.rpartition('.')
                    key = base.split('/')[-1]
                    groups.setdefault(key, {})[ext] = name
                for key, fields in sorted(groups.items()):
                    if 'wav' not in fields:
                        continue
                    ex = {'key': key, 'wav': zf.read(fields['wav']),
                          'audio_format': 'wav'}
                    if 'txt' in fields:
                        ex['txt'] = zf.read(fields['txt']).decode(
                            'utf8').strip()
                    yield ex
        except Exception as e:                  # noqa: BLE001
            mystats['bad_shard'] += 1
            import logging
            logging.warning('skipping shard %s: %r', path, e)
    return lines.flat_map(expand)
