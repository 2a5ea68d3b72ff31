"""Audio I/O (own copy of chimera_st_tpu/data/audio.py; stdlib ``wave`` and
numpy only).

WAV parsing (PCM8/PCM16/PCM32), the ``path:frame_offset:frame_length``
addressing of the MuST-C wave manifests, and .npy feature loading (optionally
zip-packed with byte offsets). Decoded waveforms and features are kept in a
process-wide LRU cache capped in bytes (``CHIMERA_WAV_CACHE_MB``, default
512; 0 turns it off; ``configure_wav_cache``), so epochs after the first
skip the disk read and the decode. ``int16=True`` reads mono PCM16 as its
raw samples, the training wire format (``manifests.set_wire_format``).
"""

from __future__ import annotations

import io
import os
import threading
import wave
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def read_wav(
    path: str,
    frame_offset: int = 0,
    frames: int = -1,
    normalize: bool = True,
    int16: bool = False,
) -> Tuple[np.ndarray, int]:
    """Read (a slice of) a WAV file -> (mono float32 waveform, sample_rate).

    ``int16=True``: a mono PCM16 source comes back as its raw ``<i2``
    samples, lossless (the float path's samples / 32768 is applied on the
    device, ``train_step.prepare_batch``); other sources as float32."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        total = w.getnframes()
        if frame_offset > 0:
            w.setpos(min(frame_offset, total))
        n = total - frame_offset if frames < 0 else min(frames, total - frame_offset)
        raw = w.readframes(max(n, 0))

    if sampwidth == 2:
        if int16 and n_channels == 1:
            return np.frombuffer(raw, dtype="<i2"), sr
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        if normalize:
            data /= 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32)
        if normalize:
            data /= 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0)
        if normalize:
            data /= 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sr


def write_wav(path: str, data: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono float32 [-1, 1] to 16-bit PCM WAV (for tests/tools)."""
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def parse_path_with_slice(path: str) -> Tuple[str, int, int]:
    """'file.wav:offset:length' -> (file, offset, length); bare path -> (-1s)."""
    parts = path.rsplit(":", 2)
    if len(parts) == 3 and parts[1].lstrip("-").isdigit() and parts[2].lstrip("-").isdigit():
        return parts[0], int(parts[1]), int(parts[2])
    return path, 0, -1


class _LRUByteCache:
    """An LRU map of arrays capped in bytes, safe across threads; an array
    larger than the cap is not kept. Its arrays are shared: a consumer
    copies before it writes."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._store: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._store.get(key)
            if arr is not None:
                self._store.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return arr

    def put(self, key, arr: np.ndarray) -> None:
        nb = arr.nbytes
        if nb > self.max_bytes:
            return
        with self._lock:
            if key in self._store:
                return
            self._store[key] = arr
            self._bytes += nb
            while self._bytes > self.max_bytes and self._store:
                _, old = self._store.popitem(last=False)
                self._bytes -= old.nbytes


def _new_cache(max_mb: float) -> Optional[_LRUByteCache]:
    return _LRUByteCache(int(max_mb * 1024 * 1024)) if max_mb > 0 else None


_wav_cache = _new_cache(float(os.environ.get("CHIMERA_WAV_CACHE_MB", "512")))


def configure_wav_cache(max_mb: float) -> None:
    """Replace the process-wide decoded-waveform cache with an empty one of
    ``max_mb`` MiB (0: none)."""
    global _wav_cache
    _wav_cache = _new_cache(max_mb)


def wav_cache_stats() -> Optional[dict]:
    """The cache's hits, misses and bytes held (None: no cache)."""
    cache = _wav_cache
    if cache is None:
        return None
    return {"hits": cache.hits, "misses": cache.misses, "bytes": cache._bytes}


def get_features_or_waveform(
    path: str, use_audio_input: bool = True, audio_root: str = "", int16: bool = False,
) -> np.ndarray:
    """Dispatch on the manifest's audio column: raw-wave slice, .npy
    features, or zip-packed .npy (``archive.zip:offset:length`` byte
    window). ``int16=True`` asks for mono PCM16 as raw samples (see
    ``read_wav``; either dtype may come back). Served from the process-wide
    cache: treat the array as read-only."""
    fname, offset, length = parse_path_with_slice(path)
    full = str(Path(audio_root) / fname) if audio_root else fname
    key = (full, offset, length, use_audio_input, int16)
    cache = _wav_cache
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
    if fname.endswith(".npy"):
        out = np.load(full)
    elif fname.endswith(".zip"):
        with open(full, "rb") as f:
            f.seek(offset)
            blob = f.read(length)
        out = np.load(io.BytesIO(blob))
    elif use_audio_input:
        out = read_wav(full, frame_offset=offset, frames=length, int16=int16)[0]
    else:
        raise ValueError(f"cannot load features from {path!r}")
    if cache is not None:
        out.flags.writeable = False  # shared with later reads
        cache.put(key, out)
    return out
