"""The edit operations behind the Levenshtein and insertion transformers'
training targets (the port's own copy of the JAX package's
``suggested_edit_ops``; fairseq libnat's ``suggested_ed2_path``, with its
insert > delete > keep tie order).

``suggested_edit_ops`` runs the C++ routine ``csrc/edit_ops.cpp``,
compiled with ``g++ -O3 -shared -fPIC`` on first use into
``chimera_st_tpu_torch/_build/`` (its file name carries a hash of the
source) and loaded with ctypes; a failed build raises, nothing falls back.
``suggested_edit_ops_plain`` is the numpy version it is held against.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import host_library

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "edit_ops.cpp"
BUILD_DIR = host_library.BUILD_DIR

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return host_library.library_path(SOURCE, "libchimera_edit_ops", BUILD_DIR)


def build() -> Path:
    """Compiles the routine if its library is missing; raises with the
    compiler's output if ``g++`` fails."""
    return host_library.build(SOURCE, "libchimera_edit_ops", BUILD_DIR)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.chimera_suggested_edit_ops
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        _lib = lib
    return _lib


def _outputs(B: int, Lx: int, Ly: int):
    return (np.zeros((B, max(Lx - 1, 1)), np.int32), np.zeros((B, Ly), np.uint8),
            np.zeros((B, Lx), np.uint8))


def suggested_edit_ops(in_tokens, out_tokens, pad: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ins_counts [B, Lx-1] int32, ins_masks [B, Ly] bool, del_labels
    [B, Lx] bool) that turn each row of ``in_tokens`` into the same row of
    ``out_tokens`` (pads skipped): tokens to insert between adjacent inputs,
    the outputs that are insertions, the inputs to delete."""
    xs = np.ascontiguousarray(in_tokens, np.int32)
    ys = np.ascontiguousarray(out_tokens, np.int32)
    (B, Lx), Ly = xs.shape, ys.shape[1]
    ic, im, dl = _outputs(B, Lx, Ly)
    _library().chimera_suggested_edit_ops(xs.ctypes.data, ys.ctypes.data, B, Lx, Ly, pad,
                                          ic.ctypes.data, im.ctypes.data, dl.ctypes.data)
    return ic, im.astype(bool), dl.astype(bool)


def suggested_edit_ops_plain(in_tokens, out_tokens, pad: int = 1
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy version of ``suggested_edit_ops`` (the same dynamic
    programme, backtrack and replay)."""
    xs, ys = np.asarray(in_tokens, np.int32), np.asarray(out_tokens, np.int32)
    (B, Lx), Ly = xs.shape, ys.shape[1]
    ins_counts, ins_masks, del_labels = _outputs(B, Lx, Ly)
    for b in range(B):
        xpos = np.nonzero(xs[b] != pad)[0]
        x, y = xs[b, xpos], ys[b][ys[b] != pad]
        lx, ly = len(x), len(y)
        if lx == 0:
            ins_masks[b, :ly] = 1
            continue
        d = np.zeros((lx + 1, ly + 1), np.int32)
        d[:, 0] = np.arange(lx + 1)
        d[0, :] = np.arange(ly + 1)
        for i in range(1, lx + 1):
            for j in range(1, ly + 1):  # d[i, j] depends on d[i, j - 1]
                d[i, j] = min(min(d[i - 1, j], d[i, j - 1]) + 1,
                              d[i - 1, j - 1] + (0 if x[i - 1] == y[j - 1] else 2))
        ops, i, j = [], lx, ly
        while i > 0 or j > 0:
            if j > 0 and d[i, j - 1] < d[i, j]:
                ops.append(1)
                j -= 1
            elif i > 0 and d[i - 1, j] < d[i, j]:
                ops.append(2)
                i -= 1
            else:
                ops.append(3)
                i, j = i - 1, j - 1
        xcount = ycount = 0
        for op in reversed(ops):
            if op == 1:
                if 1 <= xcount <= lx - 1:
                    ins_counts[b, xcount - 1] += 1
                    if ycount < ly:
                        ins_masks[b, ycount] = 1
                ycount += 1
            elif op == 2:
                del_labels[b, xpos[xcount]] = 1
                xcount += 1
            else:
                xcount += 1
                ycount += 1
    return ins_counts, ins_masks.astype(bool), del_labels.astype(bool)
