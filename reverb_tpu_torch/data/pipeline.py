"""Streaming pipeline combinators (the host side of the input pipeline).

The port's copy of reverb_tpu/data/pipeline.py: plain composable generator
stages feeding padded numpy batches to the device, in place of the
reference's torchdata IterDataPipe chain (asr/wenet/dataset/datapipes.py):
  - map / map_ignore_error (datapipes.py:50-77)  with drop-stat counters
  - filter, shuffle buffer, sort buffer (:80-205)
  - static / bucket / dynamic / distribute batching (:208-371)
  - map_parallel, a thread-pool map (the DataLoader-workers equivalent)
  - background prefetch thread (:372-413)
"""

from __future__ import annotations

import queue as queue_mod
import random
import threading
from collections import Counter
from typing import Callable, Iterable, Iterator, List, Optional

mystats = Counter()   # global drop/telemetry counters (rev_processor.py:14)


class Pipeline:
    """A lazily-evaluated chain over an iterable factory (re-iterable)."""

    def __init__(self, factory: Callable[[], Iterator]):
        self._factory = factory

    def __iter__(self):
        return iter(self._factory())

    # ------------------------------ stages ------------------------------

    def map(self, fn, *args, **kwargs) -> 'Pipeline':
        def gen():
            for x in self:
                yield fn(x, *args, **kwargs)
        return Pipeline(gen)

    def map_ignore_error(self, fn, log_error: bool = True) -> 'Pipeline':
        def gen():
            for x in self:
                try:
                    yield fn(x)
                except Exception as e:           # noqa: BLE001
                    mystats['map_error'] += 1
                    if log_error:
                        import logging
                        logging.warning('map_ignore_error: %r', e)
        return Pipeline(gen)

    def filter(self, pred) -> 'Pipeline':
        def gen():
            for x in self:
                if pred(x):
                    yield x
                else:
                    mystats['filtered'] += 1
        return Pipeline(gen)

    def flat_map(self, fn) -> 'Pipeline':
        def gen():
            for x in self:
                yield from fn(x)
        return Pipeline(gen)

    def shuffle(self, buffer_size: int = 10000, seed: Optional[int] = None
                ) -> 'Pipeline':
        def gen():
            rng = random.Random(seed)
            buf: List = []
            for x in self:
                buf.append(x)
                if len(buf) >= buffer_size:
                    rng.shuffle(buf)
                    while buf:
                        yield buf.pop()
            rng.shuffle(buf)
            while buf:
                yield buf.pop()
        return Pipeline(gen)

    def sort(self, buffer_size: int = 500, key_func=None) -> 'Pipeline':
        def gen():
            buf: List = []
            for x in self:
                buf.append(x)
                if len(buf) >= buffer_size:
                    buf.sort(key=key_func)
                    yield from buf
                    buf = []
            buf.sort(key=key_func)
            yield from buf
        return Pipeline(gen)

    def batch(self, batch_size: int, wrapper_class=None, drop_last=False
              ) -> 'Pipeline':
        def gen():
            buf: List = []
            for x in self:
                buf.append(x)
                if len(buf) == batch_size:
                    yield wrapper_class(buf) if wrapper_class else buf
                    buf = []
            if buf and not drop_last:
                yield wrapper_class(buf) if wrapper_class else buf
        return Pipeline(gen)

    def bucket_by_sequence_length(self, elem_length_fn, bucket_boundaries,
                                  bucket_batch_sizes, wrapper_class=None
                                  ) -> 'Pipeline':
        assert len(bucket_batch_sizes) == len(bucket_boundaries) + 1

        def bucket_id(length):
            for i, b in enumerate(bucket_boundaries):
                if length <= b:
                    return i
            return len(bucket_boundaries)

        def gen():
            buckets: dict = {}
            for x in self:
                bid = bucket_id(elem_length_fn(x))
                buckets.setdefault(bid, []).append(x)
                if len(buckets[bid]) == bucket_batch_sizes[bid]:
                    batch = buckets.pop(bid)
                    yield wrapper_class(batch) if wrapper_class else batch
            for batch in buckets.values():
                if batch:
                    yield wrapper_class(batch) if wrapper_class else batch
        return Pipeline(gen)

    def dynamic_batch(self, window_class, wrapper_class=None) -> 'Pipeline':
        """Frame-budget batching (datapipes.py:335-369)."""
        def gen():
            buf: List = []
            for x in self:
                if window_class(x, len(buf)):
                    if buf:
                        yield wrapper_class(buf) if wrapper_class else buf
                    buf = [x]
                else:
                    buf.append(x)
            if buf:
                yield wrapper_class(buf) if wrapper_class else buf
        return Pipeline(gen)

    def distribute_batch(self, window_class, wrapper_class=None,
                         one_utt_per_job: bool = True,
                         max_words_per_epoch: int = -1,
                         max_words_per_batch: int = -1,
                         verbose: bool = False) -> 'Pipeline':
        """Rev-specific batching (datapipes.py:208-332): frame-budget windows
        with one-utterance-per-source-job dedup (key prefix before the last
        '_') and optional word-count caps per batch/epoch."""
        def job_of(sample):
            key = sample.get('key', '')
            return key.rsplit('_', 1)[0] if '_' in key else key

        def wordcount(sample):
            txt = sample.get('txt', '')
            return len(txt.split()) if isinstance(txt, str) else 0

        def gen():
            buf: List = []
            jobs = set()
            words_epoch = 0
            words_batch = 0
            for x in self:
                if max_words_per_epoch > 0 and words_epoch >= \
                        max_words_per_epoch:
                    mystats['distribute_epoch_word_cap'] += 1
                    break
                j = job_of(x)
                full = window_class(x, len(buf))
                dup = one_utt_per_job and j in jobs
                overflow = (max_words_per_batch > 0 and
                            words_batch + wordcount(x) > max_words_per_batch
                            and buf)
                if full or dup or overflow:
                    if buf:
                        yield wrapper_class(buf) if wrapper_class else buf
                    buf = [x]
                    jobs = {j}
                    words_batch = wordcount(x)
                else:
                    buf.append(x)
                    jobs.add(j)
                    words_batch += wordcount(x)
                words_epoch += wordcount(x)
            if buf:
                yield wrapper_class(buf) if wrapper_class else buf
        return Pipeline(gen)

    def map_parallel(self, fn, workers: int = 4,
                     buffer_size: int = 32) -> 'Pipeline':
        """Order-preserving thread-pool map — the DataLoader-num_workers
        equivalent (utils/train_utils.py:301-349).

        Threads, not processes: numpy's FFT, matmul and resampling release
        the GIL for most of a sample's feature work.  Exceptions propagate
        at the failing sample's position.  buffer_size bounds the futures
        in flight (backpressure).
        """
        import os as _os
        # more threads than cores buys nothing and pays the switches
        workers = min(workers, _os.cpu_count() or 1)
        if workers <= 1:
            return self.map(fn)

        def gen():
            from concurrent.futures import ThreadPoolExecutor
            import collections
            with ThreadPoolExecutor(max_workers=workers) as ex:
                pending = collections.deque()
                it = iter(self)
                try:
                    for x in it:
                        pending.append(ex.submit(fn, x))
                        if len(pending) >= buffer_size:
                            yield pending.popleft().result()
                    while pending:
                        yield pending.popleft().result()
                finally:
                    for f in pending:
                        f.cancel()
        return Pipeline(gen)

    def prefetch(self, buffer_size: int = 4) -> 'Pipeline':
        """Background-thread prefetch so host IO overlaps device compute."""
        def gen():
            q: queue_mod.Queue = queue_mod.Queue(maxsize=buffer_size)
            _END = object()

            def worker():
                try:
                    for x in self:
                        q.put(x)
                except Exception as e:          # noqa: BLE001
                    q.put(e)
                finally:
                    q.put(_END)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        return Pipeline(gen)


def from_list(items) -> Pipeline:
    return Pipeline(lambda: iter(list(items)))
