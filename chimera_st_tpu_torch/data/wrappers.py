"""Wrapper datasets (own copy of chimera_st_tpu/data/wrappers.py): the
concatenation and per-epoch resampling that comma-joined training splits
and the multilingual tasks use; the token-level wrappers (append, prepend,
truncate, subsample, cache), back-translation, colorizing, and the
multi-corpus datasets. Each has the host-side dataset interface the tasks
read (``__len__``, ``num_tokens``, ``__getitem__``, ``collater``,
``set_epoch``), and draws what it samples from numpy generators keyed as
the JAX package's are. The epoch iterator re-packs the batches each epoch
for a dataset with ``set_epoch``.
"""

from __future__ import annotations

import bisect
from typing import Any, Optional, Sequence

import numpy as np


class IdStampedConcat:
    """Parts one after another that share one collater (the first part's),
    each item's ``id`` replaced by its index in the whole (the multilingual
    denoising and multi-simple-epoch views)."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, i: int):
        k = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.parts[k], i - int(self.offsets[k])

    def num_tokens(self, i: int) -> int:
        ds, j = self._locate(i)
        return ds.num_tokens(j)

    def __getitem__(self, i: int):
        ds, j = self._locate(i)
        item = dict(ds[j])
        item["id"] = i
        return item

    def collater(self, samples, *args, **kwargs):
        return self.parts[0].collater(samples, *args, **kwargs)

    def set_epoch(self, epoch: int):
        for p in self.parts:
            if hasattr(p, "set_epoch"):
                p.set_epoch(epoch)


class ConcatDataset:
    """Datasets one after another, each repeated an integer number of times
    (``sample_ratios``)."""

    def __init__(self, datasets: Sequence[Any], sample_ratios: Optional[Sequence[int]] = None):
        if not datasets:
            raise ValueError("ConcatDataset of no dataset")
        self.datasets = list(datasets)
        if sample_ratios is None:
            sample_ratios = [1] * len(self.datasets)
        elif isinstance(sample_ratios, int):
            sample_ratios = [sample_ratios] * len(self.datasets)
        self.sample_ratios = [int(r) for r in sample_ratios]
        self.cumulative_sizes = np.cumsum(
            [int(r) * len(d) for d, r in zip(self.datasets, self.sample_ratios)]).tolist()

    def _map_index(self, idx: int):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        offset = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return ds_idx, (idx - offset) % len(self.datasets[ds_idx])

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx: int):
        ds_idx, local = self._map_index(int(idx))
        return self.datasets[ds_idx][local]

    def num_tokens(self, idx: int) -> int:
        ds_idx, local = self._map_index(int(idx))
        return self.datasets[ds_idx].num_tokens(local)

    def collater(self, samples, **kwargs):
        return self.datasets[0].collater(samples, **kwargs)

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __getattr__(self, name):
        # the first part's attributes (split, dictionaries, ...)
        return getattr(self.__dict__["datasets"][0], name)


class ResamplingDataset:
    """A dataset drawn anew each epoch: ``ceil(len * size_ratio)`` indices,
    with replacement (or, for ``size_ratio`` < 1, optionally without), from
    ``numpy.random.default_rng([seed, epoch])``, so a resumed epoch draws the
    same samples."""

    def __init__(self, dataset, size_ratio: float = 1.0, replace: bool = True, seed: int = 0,
                 epoch: int = 1):
        if size_ratio <= 0.0 or (not replace and size_ratio >= 1.0):
            raise ValueError(f"size_ratio {size_ratio} with replace={replace}")
        self.dataset = dataset
        self.size_ratio = float(size_ratio)
        self.replace = replace
        self.seed = seed
        self.actual_size = int(np.ceil(len(dataset) * self.size_ratio))
        self._cur_epoch: Optional[int] = None
        self._cur_indices: Optional[np.ndarray] = None
        self.set_epoch(epoch)

    def __len__(self):
        return self.actual_size

    def set_epoch(self, epoch: int):
        if epoch == self._cur_epoch:
            return
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        self._cur_epoch = epoch
        rng = np.random.default_rng([self.seed, epoch])
        self._cur_indices = rng.choice(len(self.dataset), self.actual_size, replace=self.replace)

    def __getitem__(self, idx: int):
        return self.dataset[int(self._cur_indices[int(idx)])]

    def num_tokens(self, idx: int) -> int:
        return self.dataset.num_tokens(int(self._cur_indices[int(idx)]))

    def collater(self, samples, **kwargs):
        return self.dataset.collater(samples, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__dict__["dataset"], name)


class _TokenWrapper:
    """Base of the token-level wrappers: the wrapped dataset's length,
    collater, ``set_epoch`` and attributes."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def collater(self, samples, **kwargs):
        return self.dataset.collater(samples, **kwargs)

    def set_epoch(self, epoch):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __getattr__(self, name):
        return getattr(self.__dict__["dataset"], name)


class AppendTokenDataset(_TokenWrapper):
    """Each item with ``token`` appended."""

    def __init__(self, dataset, token: int):
        super().__init__(dataset)
        self.token = int(token)

    def __getitem__(self, i):
        item = self.dataset[int(i)]
        return np.concatenate([item, [self.token]]).astype(item.dtype)

    def num_tokens(self, i):
        return self.dataset.num_tokens(int(i)) + 1


class PrependTokenDataset(_TokenWrapper):
    """Each item with ``token`` prepended."""

    def __init__(self, dataset, token: int):
        super().__init__(dataset)
        self.token = int(token)

    def __getitem__(self, i):
        item = self.dataset[int(i)]
        return np.concatenate([[self.token], item]).astype(item.dtype)

    def num_tokens(self, i):
        return self.dataset.num_tokens(int(i)) + 1


class TruncateDataset(_TokenWrapper):
    """Each item cut to its first ``max_len`` tokens."""

    def __init__(self, dataset, max_len: int):
        super().__init__(dataset)
        self.max_len = int(max_len)

    def __getitem__(self, i):
        return self.dataset[int(i)][: self.max_len]

    def num_tokens(self, i):
        return min(self.dataset.num_tokens(int(i)), self.max_len)


class SubsampleDataset(_TokenWrapper):
    """A fixed ``size_ratio`` share of the items (at least one), drawn
    without replacement from ``numpy.random.default_rng(seed)``, in index
    order."""

    def __init__(self, dataset, size_ratio: float, seed: int = 0):
        super().__init__(dataset)
        if not 0.0 < size_ratio <= 1.0:
            raise ValueError(f"size_ratio {size_ratio} not in (0, 1]")
        n = max(int(len(dataset) * size_ratio), 1)
        rng = np.random.default_rng(seed)
        self.indices = np.sort(rng.choice(len(dataset), n, replace=False))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[int(i)])]

    def num_tokens(self, i):
        return self.dataset.num_tokens(int(self.indices[int(i)]))


class BacktranslationDataset:
    """Target-side monolingual items whose sources are made at collate time:
    ``backtranslate_fn`` takes the list of target token arrays and returns
    the sources, and ``output_collater`` collates the ``{"source",
    "target"}`` pairs."""

    def __init__(self, tgt_dataset, backtranslate_fn, output_collater):
        self.tgt_dataset = tgt_dataset
        self.backtranslate_fn = backtranslate_fn
        self.output_collater = output_collater

    def __len__(self):
        return len(self.tgt_dataset)

    def __getitem__(self, i):
        return self.tgt_dataset[int(i)]

    def num_tokens(self, i):
        return self.tgt_dataset.num_tokens(int(i))

    def collater(self, samples, **kwargs):
        sources = self.backtranslate_fn(samples)
        pairs = [
            {"source": np.asarray(s), "target": np.asarray(t)}
            for s, t in zip(sources, samples)
        ]
        return self.output_collater(pairs, **kwargs)


class LRUCacheDataset(_TokenWrapper):
    """The last ``max_size`` items read, kept (least recently used out)."""

    def __init__(self, dataset, max_size: int = 1024):
        super().__init__(dataset)
        from collections import OrderedDict

        self._cache = OrderedDict()
        self._max = int(max_size)

    def __getitem__(self, i):
        i = int(i)
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        item = self.dataset[i]
        self._cache[i] = item
        if len(self._cache) > self._max:
            self._cache.popitem(last=False)
        return item

    def num_tokens(self, i):
        return self.dataset.num_tokens(int(i))


class ColorizeDataset(_TokenWrapper):
    """Collated batches with a ``colors`` entry, one int32 a sentence from
    ``color_getter(dataset, id)`` (a language or domain id); items are dicts
    with an ``id``."""

    def __init__(self, dataset, color_getter):
        super().__init__(dataset)
        self.color_getter = color_getter

    def __getitem__(self, i):
        return self.dataset[int(i)]

    def num_tokens(self, i):
        return self.dataset.num_tokens(int(i))

    def collater(self, samples, **kwargs):
        batch = self.dataset.collater(samples, **kwargs)
        if batch:
            batch["colors"] = np.asarray(
                [self.color_getter(self.dataset, s["id"]) for s in samples],
                np.int32,
            )
        return batch


class MultiCorpusSampledDataset:
    """Several corpora in one dataset, every batch wholly from one corpus,
    chosen at collate time by ``sampling_func(keys)`` or, without one, by a
    generator ``numpy.random.default_rng(seed)``, made anew as
    ``default_rng(seed + epoch)`` by ``set_epoch``. Global index ``i``
    addresses item ``i % len(corpus)`` of every corpus; ``num_tokens`` is
    the largest of them."""

    def __init__(self, datasets, sampling_func=None, seed: int = 0):
        if not datasets:
            raise ValueError("MultiCorpusSampledDataset of no dataset")
        self.datasets = dict(datasets)  # insertion-ordered
        self.keys = list(self.datasets.keys())
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.sampling_func = sampling_func
        self.total = sum(len(d) for d in self.datasets.values())

    def _pick_key(self):
        if self.sampling_func is not None:
            return self.sampling_func(self.keys)
        return self.keys[int(self._rng.integers(len(self.keys)))]

    def __len__(self):
        return self.total

    def __getitem__(self, idx: int):
        i = int(idx)
        return {
            key: ds[i % len(ds)] for key, ds in self.datasets.items()
        }

    def num_tokens(self, idx: int) -> int:
        # batching budgets for whichever corpus the collater picks
        i = int(idx)
        return max(
            ds.num_tokens(i % len(ds)) for ds in self.datasets.values()
        )

    def collater(self, samples, **kwargs):
        if not samples:
            return None
        key = self._pick_key()
        picked = [s[key] for s in samples]
        return self.datasets[key].collater(picked, **kwargs)

    def set_epoch(self, epoch: int):
        self._rng = np.random.default_rng(self.seed + int(epoch))
        for ds in self.datasets.values():
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)


class MultiCorpusDataset:
    """Corpora mixed item by item under ``distribution``: each
    ``set_epoch`` (and the constructor, as epoch 1) draws from
    ``numpy.random.default_rng((seed, epoch))`` a corpus for each of the
    ``sum(len)`` slots, then each corpus's items for its slots from fresh
    permutations, one after another. Every member must be of one type: the
    first one's collater serves a mixed batch."""

    def __init__(self, datasets, distribution, seed: int = 0):
        if not datasets:
            raise ValueError("MultiCorpusDataset of no dataset")
        self.datasets = dict(datasets)
        self.keys = list(self.datasets.keys())
        if len(distribution) != len(self.keys):
            raise ValueError(f"{len(distribution)} probabilities for {len(self.keys)} corpora")
        first = type(next(iter(self.datasets.values())))
        for ds in self.datasets.values():
            if type(ds) is not first:
                raise ValueError(
                    "MultiCorpusDataset members must share one dataset type "
                    "(one collater serves the mixed batch)"
                )
        for key, ds in self.datasets.items():
            if len(ds) == 0:
                raise ValueError(f"MultiCorpusDataset member {key!r} is empty")
        total_p = float(sum(distribution))
        self.distribution = [float(p) / total_p for p in distribution]
        self.seed = int(seed)
        self.total = sum(len(d) for d in self.datasets.values())
        self._resample(1)

    def _resample(self, epoch: int):
        rng = np.random.default_rng((self.seed, int(epoch)))
        corpus = rng.choice(len(self.keys), size=self.total, p=self.distribution)
        self._corpus = corpus
        self._inner = np.zeros(self.total, dtype=np.int64)
        for k, key in enumerate(self.keys):
            slots = np.flatnonzero(corpus == k)
            n, L = len(slots), len(self.datasets[key])
            if n == 0:
                continue
            perms = [rng.permutation(L) for _ in range((n + L - 1) // L)]
            self._inner[slots] = np.concatenate(perms)[:n]

    def __len__(self):
        return self.total

    def _map_index(self, idx: int):
        i = int(idx)
        return self.keys[self._corpus[i]], int(self._inner[i])

    def __getitem__(self, idx: int):
        key, i = self._map_index(idx)
        return self.datasets[key][i]

    def num_tokens(self, idx: int) -> int:
        key, i = self._map_index(idx)
        return self.datasets[key].num_tokens(i)

    def size(self, idx: int):
        key, i = self._map_index(idx)
        return self.datasets[key].size(i)

    def collater(self, samples, **kwargs):
        if not samples:
            return None
        return next(iter(self.datasets.values())).collater(samples, **kwargs)

    def set_epoch(self, epoch: int):
        self._resample(epoch)
        for ds in self.datasets.values():
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)
