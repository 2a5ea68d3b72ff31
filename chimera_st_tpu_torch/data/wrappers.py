"""Concatenation and per-epoch resampling of datasets (own copy of the
wrappers of chimera_st_tpu/data/wrappers.py that comma-joined training
splits and the multilingual tasks use): the host-side dataset interface the
tasks read (``__len__``, ``num_tokens``, ``__getitem__``, ``collater``,
``set_epoch``). The epoch iterator re-packs the batches each epoch for a
dataset with ``set_epoch``.
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
