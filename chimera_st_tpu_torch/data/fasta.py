"""FASTA sequence datasets (counterpart of chimera_st_tpu/data/fasta.py;
fairseq ``data/fasta_dataset.py``): ``FastaDataset`` indexes the byte
offset and residue count of every record of ``<prefix>.fasta`` in one scan
and reads records at random; ``EncodedFastaDataset`` maps a record's
residues through a ``Dictionary``, one id a character, eos appended. The
``.fasta.idx.npy`` index cache has the JAX package's format, so either
package reads the other's.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Tuple

import numpy as np


def fasta_file_path(prefix_path: str) -> str:
    return prefix_path + ".fasta"


class FastaDataset:
    """Random access over FASTA records -> (description, sequence) pairs."""

    def __init__(self, path: str, cache_indices: bool = False):
        self.fn = fasta_file_path(path)
        self.threadlocal = threading.local()
        self.cache = Path(f"{path}.fasta.idx.npy")
        if cache_indices and self.cache.exists():
            self.offsets, self.sizes = np.load(self.cache)
        else:
            self.offsets, self.sizes = self._build_index()
            if cache_indices:
                np.save(self.cache, np.stack([self.offsets, self.sizes]))

    def _build_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """One pass: the byte offset of each '>' header and the residue count
        of each record."""
        offsets, sizes = [], []
        pos = 0
        size = 0
        with open(self.fn, "rb") as fh:
            for raw in fh:
                if raw.startswith(b">"):
                    if offsets:
                        sizes.append(size)
                    offsets.append(pos)
                    size = 0
                else:
                    size += len(raw.strip())
                pos += len(raw)
        if offsets:
            sizes.append(size)
        return (np.asarray(offsets, np.int64), np.asarray(sizes, np.int64))

    def _get_file(self):
        if not hasattr(self.threadlocal, "f"):
            self.threadlocal.f = open(self.fn, "r")
        return self.threadlocal.f

    def __getitem__(self, idx: int) -> Tuple[str, str]:
        f = self._get_file()
        f.seek(int(self.offsets[idx]))
        desc = f.readline().strip()
        chunks = []
        line = f.readline()
        while line != "" and line[0] != ">":
            chunks.append(line.strip())
            line = f.readline()
        return desc, "".join(chunks)

    def __len__(self) -> int:
        return int(self.offsets.size)

    def num_tokens(self, idx: int) -> int:
        return int(self.sizes[idx])

    def size(self, idx: int) -> int:
        return int(self.sizes[idx])

    # picklable across data-loading workers
    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "threadlocal"}

    def __setstate__(self, state):
        self.__dict__ = state
        self.threadlocal = threading.local()

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(fasta_file_path(path))


class EncodedFastaDataset(FastaDataset):
    """FASTA residues encoded through a Dictionary, one id per character,
    eos appended."""

    def __init__(self, path: str, dictionary):
        super().__init__(path, cache_indices=True)
        self.dictionary = dictionary

    def __getitem__(self, idx: int) -> np.ndarray:
        _, seq = super().__getitem__(idx)
        ids = [self.dictionary.index(ch) for ch in seq]
        ids.append(self.dictionary.eos())
        return np.asarray(ids, np.int64)
