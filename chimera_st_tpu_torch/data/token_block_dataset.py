"""Token-block dataset for language modeling (own copy of
chimera_st_tpu/data/token_block_dataset.py; reference
fairseq/data/token_block_dataset.py + the Cython token_block_utils_fast.pyx):
slicing a token stream into LM blocks.

Break modes: "none" (fixed-size blocks over the concatenated stream), "eos"
(one sentence per block), "complete" (pack whole sentences up to
block_size)."""

from __future__ import annotations

from typing import List

import numpy as np


class TokenBlockDataset:
    def __init__(
        self,
        dataset,  # indexable of token arrays
        sizes: np.ndarray,
        block_size: int,
        pad: int = 1,
        eos: int = 2,
        break_mode: str = "none",
    ):
        self.dataset = dataset
        self.pad = pad
        self.eos = eos
        sizes = np.asarray(sizes, np.int64)
        self.slices: List[tuple] = []  # (start_item, start_off, end_item, end_off)
        if break_mode == "eos":
            for i in range(len(sizes)):
                self.slices.append((i, 0, i, int(sizes[i])))
        elif break_mode == "complete":
            start = 0
            cur = 0
            for i in range(len(sizes)):
                if cur + sizes[i] > block_size and cur > 0:
                    self.slices.append((start, 0, i - 1, int(sizes[i - 1])))
                    start, cur = i, 0
                cur += int(sizes[i])
            if cur > 0:
                self.slices.append((start, 0, len(sizes) - 1, int(sizes[-1])))
        elif break_mode == "none":
            total = int(sizes.sum())
            boundaries = np.concatenate([[0], np.cumsum(sizes)])
            for s in range(0, total, block_size):
                e = min(s + block_size, total)
                si = int(np.searchsorted(boundaries, s, side="right") - 1)
                ei = int(np.searchsorted(boundaries, e - 1, side="right") - 1)
                self.slices.append(
                    (si, s - int(boundaries[si]), ei, e - int(boundaries[ei]))
                )
        else:
            raise ValueError(f"unknown break_mode {break_mode!r}")
        # block lengths are pure arithmetic over the sizes array: no
        # dataset[i] reads at construction
        csum = np.concatenate([[0], np.cumsum(sizes)])
        self._item_sizes = sizes
        self._csum = csum
        self._sizes = np.asarray(
            [self._slice_len(sl) for sl in self.slices], np.int64
        )

    def _slice_len(self, sl):
        si, so, ei, eo = sl
        if si == ei:
            return eo - so
        # (sizes[si] - so) + sum(sizes[si+1:ei]) + eo, via the prefix sum
        return int(
            (self._item_sizes[si] - so)
            + (self._csum[ei] - self._csum[si + 1])
            + eo
        )

    @property
    def sizes(self):
        return self._sizes

    def __len__(self):
        return len(self.slices)

    def num_tokens(self, i: int) -> int:
        return int(self._sizes[i])

    def __getitem__(self, i: int) -> np.ndarray:
        si, so, ei, eo = self.slices[i]
        parts = []
        for j in range(si, ei + 1):
            arr = np.asarray(self.dataset[j])
            lo = so if j == si else 0
            hi = eo if j == ei else len(arr)
            parts.append(arr[lo:hi])
        return np.concatenate(parts).astype(np.int32)
