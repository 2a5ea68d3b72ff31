"""Epoch batch iterators (counterpart of chimera_st_tpu/data/iterators.py,
the same batch order, shards and resume state).

``EpochBatchIterator``: a frozen batch list, a per-epoch
shuffle seeded by ``numpy.random.default_rng([seed, epoch])``, shard slicing
with fill, and a checkpointable ``state_dict`` with ``iterations_in_epoch``
for mid-epoch resume (O(1): the consumed batches are dropped before
collation); a background thread, or with ``num_workers`` > 1 a pool of
threads, collates the next batches while the device works; ``data_s``
maps each epoch to the seconds its collations took, summed over the threads.
``GroupedIterator`` groups ``update_freq`` micro-batches into an update.
``StreamingEpochBatchIterator`` iterates a source that yields ready batches
each epoch (the joint tasks' interleaved batches), with an epoch-granular
``state_dict``."""

from __future__ import annotations

import functools
import inspect
import itertools
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Union

import numpy as np


_INFER = object()


class CountingIterator:
    """Iterator wrapper that counts elements.

    ``total`` defaults to the iterable's length when it has one; pass
    ``total=None`` explicitly for an unsized/streaming source (then
    ``has_next`` answers by peeking one element)."""

    def __init__(self, iterable, start: int = 0, total=_INFER):
        self._itr = iter(iterable)
        self.n = start
        self.total = (
            start + len(iterable) if total is _INFER and hasattr(iterable, "__len__")
            else (None if total is _INFER else total)
        )

    def __len__(self):
        return self.total if self.total is not None else 0

    def __iter__(self):
        return self

    _SENTINEL = object()

    def __next__(self):
        if self.total is not None and self.n >= self.total:
            raise StopIteration
        if getattr(self, "_peeked", self._SENTINEL) is not self._SENTINEL:
            x, self._peeked = self._peeked, self._SENTINEL
        else:
            x = next(self._itr)
        self.n += 1
        return x

    def has_next(self) -> bool:
        if self.total is not None:
            return self.n < self.total
        # unsized source (streaming): peek one element to answer truthfully
        if getattr(self, "_peeked", self._SENTINEL) is self._SENTINEL:
            try:
                self._peeked = next(self._itr)
            except StopIteration:
                return False
        return True

    def skip(self, n: int) -> "CountingIterator":
        # a pending has_next() peek is the FIRST upcoming element — it must
        # count toward the skip, or the stale peeked item would be yielded
        # out of order after the skipped window
        take = n
        if take > 0 and getattr(self, "_peeked", self._SENTINEL) \
                is not self._SENTINEL:
            self._peeked = self._SENTINEL
            take -= 1
        next(itertools.islice(self._itr, take, take), None)
        self.n += n
        return self


class GroupedIterator(CountingIterator):
    """Groups `chunk_size` elements (update_freq). A 0-length inner (a
    streaming source reports len 0) counts as unsized."""

    def __init__(self, iterable, chunk_size: int):
        self.chunk_size = chunk_size
        inner_len = len(iterable) if hasattr(iterable, "__len__") else None
        if not inner_len:  # None OR 0 (unsized sources report len 0)
            inner_len = None
        total = (
            -(-inner_len // chunk_size) if inner_len is not None else None
        )
        self._inner = iter(iterable)
        self._itr = self._chunks()  # inherited has_next/skip consume this
        # a mid-epoch-resumed CountingIterator arrives with n=offset: the
        # group counter starts at ceil(inner.n / chunk), else len() /
        # has_next() report a full epoch on every resumed epoch
        inner_n = int(getattr(iterable, "n", 0) or 0)
        self.n = -(-inner_n // chunk_size) if inner_n > 0 else 0
        self.total = total

    def _chunks(self):
        while True:
            chunk = list(itertools.islice(self._inner, self.chunk_size))
            if not chunk:
                return
            yield chunk

    def __next__(self):
        if self.total is not None and self.n >= self.total:
            raise StopIteration
        if getattr(self, "_peeked", self._SENTINEL) is not self._SENTINEL:
            chunk, self._peeked = self._peeked, self._SENTINEL
        else:
            chunk = next(self._itr)
        self.n += 1
        return chunk


class BackgroundPrefetcher:
    """Prefetch from an iterator on a daemon thread (bounded queue)."""

    _SENTINEL = object()

    def __init__(self, iterable, buffer_size: int = 4):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._len = len(iterable) if hasattr(iterable, "__len__") else None
        self._error = None
        self._thread = threading.Thread(
            target=self._worker, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _worker(self, itr):
        try:
            for x in itr:
                self._queue.put(x)
        except BaseException as e:  # re-raised on the consumer side
            self._error = e
        finally:
            self._queue.put(self._SENTINEL)

    def __len__(self):
        return self._len if self._len is not None else 0

    def __iter__(self):
        return self

    def __next__(self):
        # the worker enqueues exactly one sentinel; remember exhaustion so a
        # later next() (e.g. a has_next peek) re-raises instead of blocking
        if getattr(self, "_done", False):
            raise StopIteration
        x = self._queue.get()
        if x is self._SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return x


class ParallelPrefetcher:
    """Multi-worker ordered collation pipeline (``--num-workers`` > 1).

    Three stages, all off the consumer thread:

    1. a ``ThreadPoolExecutor(num_workers)`` runs ``work_fn(item)`` for up to
       ``num_workers + buffer_size`` items concurrently (wav read, feature
       prep and the numpy pad copy all release the GIL, so threads scale
       without the fork cost and batch-pickle wire of process workers),
    2. a single *stager* thread consumes completed futures IN SUBMIT ORDER —
       the output stream is bit-identical to serial iteration whenever
       ``work_fn`` is per-item deterministic — and applies the optional
       ``post_fn``,
    3. a bounded queue hands finished batches to the consumer.

    Worker exceptions propagate to the consumer at the failing item's
    position; later items are dropped."""

    _SENTINEL = object()

    def __init__(self, items, work_fn, num_workers: int = 4,
                 buffer_size: int = 4, post_fn=None):
        items = list(items)
        self._len = len(items)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._error = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(num_workers, 1),
            thread_name_prefix="chimera-collate",
        )
        self._stager = threading.Thread(
            target=self._stage,
            args=(items, work_fn, max(num_workers, 1) + max(buffer_size, 1),
                  post_fn),
            daemon=True,
        )
        self._stager.start()

    def _stage(self, items, work_fn, max_in_flight, post_fn):
        import collections

        pending: "collections.deque" = collections.deque()
        it = iter(items)
        try:
            for item in itertools.islice(it, max_in_flight):
                pending.append(self._pool.submit(work_fn, item))
            while pending:
                x = pending.popleft().result()
                nxt = next(it, self._SENTINEL)
                if nxt is not self._SENTINEL:
                    pending.append(self._pool.submit(work_fn, nxt))
                if post_fn is not None:
                    x = post_fn(x)
                self._queue.put(x)
        except BaseException as e:  # re-raised on the consumer side
            self._error = e
            for f in pending:
                f.cancel()
        finally:
            self._pool.shutdown(wait=False)
            self._queue.put(self._SENTINEL)

    def __len__(self):
        return self._len

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, "_done", False):
            raise StopIteration
        x = self._queue.get()
        if x is self._SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return x


class EpochBatchIterator:
    """Args:
        dataset_collate: fn(list_of_indices) -> batch (host-side collation)
        batches: frozen list of index arrays (from batch_by_size), or a
            function epoch -> that epoch's list, for a dataset that re-samples
            each epoch (it calls the dataset's ``set_epoch``)
    """

    def __init__(
        self,
        dataset_collate: Callable[[np.ndarray], Any],
        batches: Union[List[np.ndarray], Callable[[int], List[np.ndarray]]],
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
        buffer_size: int = 4,
        num_workers: int = 1,
    ):
        """``num_workers > 1`` collates batches on a thread pool
        (ParallelPrefetcher)."""
        self.collate = dataset_collate
        # a collate that takes the epoch (a task whose noise re-rolls each
        # epoch, translation_lev) is given it
        self._collate_takes_epoch = "epoch" in inspect.signature(dataset_collate).parameters
        if callable(batches):
            self._batches_fn, self._batches_cache = batches, (None, None)
        else:
            self._batches_fn, self._batches_cache = None, (None, list(batches))
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.buffer_size = buffer_size
        self.num_workers = max(int(num_workers), 1)
        self.epoch = 1
        self._cur: Optional[CountingIterator] = None
        self._next_epoch_itr: Optional[CountingIterator] = None
        self.shuffle = True
        self.data_s: dict = {}
        self._data_lock = threading.Lock()

    def _timed(self, work: Callable, epoch: int) -> Callable:
        def run(batch):
            t0 = time.perf_counter()
            out = work(batch)
            with self._data_lock:
                self.data_s[epoch] = self.data_s.get(epoch, 0.0) + time.perf_counter() - t0
            return out

        return run

    @property
    def frozen_batches(self) -> List[np.ndarray]:
        """This epoch's batches."""
        cached_epoch, cached = self._batches_cache
        if self._batches_fn is None:
            return cached
        if cached_epoch != self.epoch:
            self._batches_cache = (self.epoch, self._batches_fn(self.epoch))
        return self._batches_cache[1]

    def __len__(self):
        return -(-len(self.frozen_batches) // self.num_shards)

    @property
    def n(self) -> int:
        return self.iterations_in_epoch

    @property
    def iterations_in_epoch(self) -> int:
        if self._cur is not None:
            return self._cur.n
        if self._next_epoch_itr is not None:
            # a checkpoint written between load_state_dict and the first
            # next_epoch_itr must keep the mid-epoch offset
            return self._next_epoch_itr.n
        return 0

    def _shuffled(self, epoch: int, shuffle: bool) -> List[np.ndarray]:
        batches = list(self.frozen_batches)
        if shuffle:
            rng = np.random.default_rng([self.seed, epoch])
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        # shard with fill so every shard sees the same number of batches
        n = len(batches)
        per = -(-n // self.num_shards)
        sharded = [
            batches[(self.shard_id + i * self.num_shards) % max(n, 1)]
            for i in range(per)
        ] if n else []
        return sharded

    def next_epoch_itr(self, shuffle: bool = True, offset: int = 0):
        if self._next_epoch_itr is not None:
            itr = self._next_epoch_itr
            self._next_epoch_itr = None
        else:
            batches = self._shuffled(self.epoch, shuffle)
            total = len(batches)
            if offset > 0:
                # resume is O(1): drop the already-consumed batch indices
                # before collation; the counter still starts at `offset`
                batches = batches[offset:]
            work = self.collate
            if self._collate_takes_epoch:
                work = functools.partial(self.collate, epoch=self.epoch)
            work = self._timed(work, self.epoch)
            if self.num_workers > 1 and self.buffer_size > 0:
                source: Any = ParallelPrefetcher(
                    batches, work, num_workers=self.num_workers,
                    buffer_size=self.buffer_size,
                )
            else:
                gen = (work(b) for b in batches)
                source = BackgroundPrefetcher(
                    _SizedGenerator(gen, len(batches)), self.buffer_size
                ) if self.buffer_size > 0 else _SizedGenerator(gen, len(batches))
            itr = CountingIterator(source, total=total, start=offset)
        self.shuffle = shuffle
        self._cur = itr
        return itr

    def end_of_epoch(self) -> bool:
        return self._cur is None or not self._cur.has_next()

    def next_epoch(self):
        self.epoch += 1
        self._cur = None

    def state_dict(self):
        return {
            "epoch": self.epoch,
            "iterations_in_epoch": self.iterations_in_epoch,
            "shuffle": self.shuffle,
        }

    def load_state_dict(self, state):
        self.epoch = state.get("epoch", 1)
        offset = state.get("iterations_in_epoch", 0)
        shuffle = state.get("shuffle", True)
        if offset > 0 and offset < len(self):
            self._next_epoch_itr = None
            itr = self.next_epoch_itr(shuffle=shuffle, offset=offset)
            self._next_epoch_itr = itr
            self._cur = None
        else:
            if offset >= len(self) > 0:
                self.epoch += 1  # checkpoint was at epoch boundary


class _SizedGenerator:
    def __init__(self, gen, n):
        self._gen = gen
        self._n = n

    def __len__(self):
        return self._n

    def __iter__(self):
        return iter(self._gen)


class StreamingEpochBatchIterator:
    """Epoch iterator over a source that yields ready batches (counterpart
    of the JAX ``StreamingEpochBatchIterator``): ``set_epoch`` is forwarded
    to the source, a background thread prefetches ``buffer_size`` batches,
    and the state is the epoch alone (a resume starts the stored epoch from
    its beginning, as in JAX)."""

    def __init__(self, dataset, buffer_size: int = 0):
        self.dataset = dataset
        self.epoch = 1
        self.buffer_size = int(buffer_size)
        self._cur: Optional[CountingIterator] = None

    @property
    def next_epoch_idx(self) -> int:
        if self._cur is not None and self.end_of_epoch():
            return self.epoch + 1
        return self.epoch

    def next_epoch_itr(self, shuffle: bool = True, offset: int = 0):
        self.epoch = self.next_epoch_idx
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        source: Any = self.dataset
        if self.buffer_size > 0:
            source = BackgroundPrefetcher(source, self.buffer_size)
        self._cur = CountingIterator(source, total=None)
        return self._cur

    def end_of_epoch(self) -> bool:
        return self._cur is None or not self._cur.has_next()

    def next_epoch(self):
        """After an exhausted epoch: the next one (and the exhausted
        iterator cleared, so that ``next_epoch_itr`` does not advance
        again)."""
        self.epoch = self.next_epoch_idx
        self._cur = None

    @property
    def iterations_in_epoch(self) -> int:
        return self._cur.n if self._cur is not None else 0

    def state_dict(self):
        return {"epoch": self.epoch}

    def load_state_dict(self, state):
        self.epoch = state.get("epoch", 1)
