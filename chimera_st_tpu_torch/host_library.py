"""Host-side C++ routines of the port (``csrc/*.cpp``), compiled with
``g++ -O3 -shared -fPIC`` on first use into ``chimera_st_tpu_torch/_build/``
and loaded with ctypes. A library's file name carries a hash of its source
and flags; a failed build raises with the compiler's output, and nothing
falls back. ``libbleu`` loads ``csrc/libbleu.cpp`` (the BLEU counter, the
edit distance, the batch packer) once a process."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path(source: Path, stem: str, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode() + Path(source).read_bytes()).hexdigest()[:12]
    return Path(build_dir) / f"{stem}_{h}.so"


def build(source: Path, stem: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compiles ``source`` if its library is missing; raises if ``g++``
    fails."""
    lib = library_path(source, stem, build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.stem}.{os.getpid()}.so.tmp"
    proc = subprocess.run(["g++", *FLAGS, str(source), "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {Path(source).name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never sees half a file
    return lib


LIBBLEU_SOURCE = PKG_DIR / "csrc" / "libbleu.cpp"
_libbleu: Optional[ctypes.CDLL] = None
_libbleu_lock = threading.Lock()


def libbleu() -> ctypes.CDLL:
    """``csrc/libbleu.cpp``, built if missing and loaded once a process,
    with its routines' signatures set."""
    global _libbleu
    with _libbleu_lock:
        if _libbleu is None:
            lib = ctypes.CDLL(str(build(LIBBLEU_SOURCE, "libchimera_bleu")))
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.chimera_bleu_add.restype = None
            lib.chimera_bleu_add.argtypes = [ptr, ptr, i64, ptr, i64]
            lib.chimera_levenshtein.restype = i64
            lib.chimera_levenshtein.argtypes = [ptr, i64, ptr, i64]
            lib.chimera_batch_by_size_fast.restype = i64
            lib.chimera_batch_by_size_fast.argtypes = [ptr, i64, i64, i64, i64, ptr]
            _libbleu = lib
    return _libbleu
