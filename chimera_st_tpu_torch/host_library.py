"""Host-side C++ routines of the port (``csrc/*.cpp``), compiled with
``g++ -O3 -shared -fPIC`` on first use into ``chimera_st_tpu_torch/_build/``
and loaded with ctypes. A library's file name carries a hash of its source
and flags; a failed build raises with the compiler's output, and nothing
falls back."""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

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
