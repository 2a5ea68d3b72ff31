"""Epoch batch iterator (counterpart of chimera_st_tpu/data/iterators.py, the
part the inference CLIs read).

``EpochBatchIterator`` keeps the contract of the JAX package's: a frozen batch
list, read in order, and a background thread that collates the next batches
while the device works. The seeded shuffle, epoch counting, shard slicing,
mid-epoch resume, grouped iteration, per-epoch batch lists and the
multi-worker collation pool serve training and wait for it (ROADMAP A10).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List

import numpy as np


class CountingIterator:
    """Iterator wrapper that counts the elements it has yielded."""

    def __init__(self, iterable, total: int):
        self._itr = iter(iterable)
        self.n = 0
        self.total = total

    def __len__(self):
        return self.total

    def __iter__(self):
        return self

    def __next__(self):
        if self.n >= self.total:
            raise StopIteration
        x = next(self._itr)
        self.n += 1
        return x


class BackgroundPrefetcher:
    """Prefetch from an iterator on a daemon thread (bounded queue); a
    worker exception is re-raised on the consumer side."""

    _SENTINEL = object()

    def __init__(self, iterable, buffer_size: int = 4):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._error = None
        self._done = False
        self._thread = threading.Thread(target=self._worker, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _worker(self, itr):
        try:
            for x in itr:
                self._queue.put(x)
        except BaseException as e:
            self._error = e
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        x = self._queue.get()
        if x is self._SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return x


class EpochBatchIterator:
    """``dataset_collate``: fn(index array) -> batch (host-side collation);
    ``batches``: the frozen list of index arrays (from ``batch_by_size``)."""

    def __init__(self, dataset_collate: Callable[[np.ndarray], Any], batches: List[np.ndarray],
                 buffer_size: int = 4):
        self.collate = dataset_collate
        self.frozen_batches = list(batches)
        self.buffer_size = buffer_size

    def __len__(self):
        return len(self.frozen_batches)

    def next_epoch_itr(self, shuffle: bool = False) -> CountingIterator:
        if shuffle:
            raise NotImplementedError("shuffled epochs are not ported yet (ROADMAP A10)")
        batches = self.frozen_batches
        source = (self.collate(b) for b in batches)
        if self.buffer_size > 0:
            source = BackgroundPrefetcher(source, self.buffer_size)
        return CountingIterator(source, total=len(batches))
