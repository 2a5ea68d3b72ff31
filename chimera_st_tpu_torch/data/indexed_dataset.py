"""Binarized token datasets (own copy of chimera_st_tpu/data/indexed_dataset.py):
fairseq's ``MMapIndexedDataset`` format, read and written, so that corpora
binarized by ``fairseq-preprocess``, the JAX package's ``chimera-preprocess``
or the port's ``chimera-torch-preprocess`` load in either package.

.idx: magic ``MMIDIDX\\x00\\x00`` + version u64 + dtype code u8 + count u64 +
      sizes i32[count] + pointers i64[count]
.bin: the token arrays, concatenated.

The writer's dtype is int32, as the JAX package's preprocess writes it
(fairseq would pick uint16 under 65,500 symbols); the reader takes every
dtype code of ``_DTYPES``.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"

_DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def idx_path(prefix: str) -> str:
    return prefix + ".idx"


def bin_path(prefix: str) -> str:
    return prefix + ".bin"


class MMapIndexedDataset:
    """The arrays of ``{prefix}.bin`` / ``.idx``, memory-mapped; ``sizes``
    holds each array's length."""

    def __init__(self, prefix: str):
        with open(idx_path(prefix), "rb") as f:
            magic = f.read(9)
            if magic != _MAGIC:
                raise ValueError(f"bad index magic in {prefix}.idx")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"{prefix}.idx: index version {version}, not 1")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            (count,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        buf = np.memmap(idx_path(prefix), mode="r", order="C")
        self.sizes = np.frombuffer(buf, dtype=np.int32, count=count, offset=offset)
        self.pointers = np.frombuffer(buf, dtype=np.int64, count=count,
                                      offset=offset + count * 4)
        self.data = np.memmap(bin_path(prefix), mode="r", dtype=self.dtype)

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        ptr = self.pointers[i] // self.dtype.itemsize
        return np.asarray(self.data[ptr: ptr + self.sizes[i]])

    @staticmethod
    def exists(prefix: str) -> bool:
        return Path(idx_path(prefix)).is_file() and Path(bin_path(prefix)).is_file()


class MMapIndexedDatasetBuilder:
    """Writes ``{prefix}.bin`` item by item, then ``{prefix}.idx`` at
    ``finalize``."""

    def __init__(self, prefix: str, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(bin_path(prefix), "wb")
        self.sizes: List[int] = []
        self.pointers: List[int] = []
        self._offset = 0

    def add_item(self, tokens: np.ndarray):
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes(order="C"))
        self.pointers.append(self._offset)
        self.sizes.append(len(arr))
        self._offset += arr.nbytes

    def finalize(self):
        self._bin.close()
        with open(idx_path(self.prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _CODES[self.dtype]))
            f.write(struct.pack("<Q", len(self.sizes)))
            f.write(np.asarray(self.sizes, np.int32).tobytes(order="C"))
            f.write(np.asarray(self.pointers, np.int64).tobytes(order="C"))
