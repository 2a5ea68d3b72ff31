"""Checkpoint I/O on HDFS (own copy of chimera_st_tpu/utils/hdfs.py; fairseq
``models/chimera/hdfs_utils.py``): an ``hdfs://`` path is read and written
through pipes to the ``hdfs dfs`` command (``-cat``, ``-put -f``,
``-appendToFile``), which must be on ``PATH``; a local path passes through
to ``open``."""

from __future__ import annotations

import contextlib
import pickle
import shutil
import subprocess
from typing import IO, Iterator


def is_hdfs_path(path: str) -> bool:
    return str(path).startswith("hdfs://")


def hdfs_available() -> bool:
    return shutil.which("hdfs") is not None


@contextlib.contextmanager
def hopen(path: str, mode: str = "rb") -> Iterator[IO[bytes]]:
    """Open a local or ``hdfs://`` path for binary reading (``r``), writing
    (``w``, which overwrites) or appending (``a``)."""
    if not is_hdfs_path(path):
        with open(path, mode) as f:
            yield f
        return
    if not hdfs_available():
        raise RuntimeError(f"hdfs binary not found on PATH (needed for {path})")
    if "r" in mode:
        proc = subprocess.Popen(["hdfs", "dfs", "-cat", path], stdout=subprocess.PIPE)
        try:
            yield proc.stdout
        finally:
            proc.stdout.close()
            proc.wait()
    elif "w" in mode or "a" in mode:
        # -appendToFile takes no -f; -put -f overwrites as a local "w" does
        cmd = (["hdfs", "dfs", "-appendToFile", "-", path] if "a" in mode
               else ["hdfs", "dfs", "-put", "-f", "-", path])
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        try:
            yield proc.stdin
        finally:
            proc.stdin.close()
            rc = proc.wait()
            if rc != 0:
                raise RuntimeError(f"hdfs write to {path} failed (rc={rc})")
    else:
        raise ValueError(f"unsupported mode {mode!r}")


def load_pickle(path: str):
    with hopen(path, "rb") as f:
        return pickle.loads(f.read())


def save_pickle(obj, path: str) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    with hopen(path, "wb") as f:
        f.write(data)
