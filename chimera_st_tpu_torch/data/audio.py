"""Audio I/O (own copy of chimera_st_tpu/data/audio.py; stdlib ``wave`` and
numpy only).

WAV parsing (PCM8/PCM16/PCM32), the ``path:frame_offset:frame_length``
addressing of the MuST-C wave manifests, and .npy feature loading (optionally
zip-packed with byte offsets). The JAX package's decoded-waveform cache and
its int16 wire format serve repeated training epochs and are left out.
"""

from __future__ import annotations

import io
import wave
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(
    path: str,
    frame_offset: int = 0,
    frames: int = -1,
    normalize: bool = True,
) -> Tuple[np.ndarray, int]:
    """Read (a slice of) a WAV file -> (mono float32 waveform, sample_rate)."""
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


def get_features_or_waveform(
    path: str, use_audio_input: bool = True, audio_root: str = "",
) -> np.ndarray:
    """Dispatch on the manifest's audio column: raw-wave slice, .npy
    features, or zip-packed .npy (``archive.zip:offset:length`` byte
    window)."""
    fname, offset, length = parse_path_with_slice(path)
    full = str(Path(audio_root) / fname) if audio_root else fname
    if fname.endswith(".npy"):
        return np.load(full)
    if fname.endswith(".zip"):
        with open(full, "rb") as f:
            f.seek(offset)
            blob = f.read(length)
        return np.load(io.BytesIO(blob))
    if use_audio_input:
        return read_wav(full, frame_offset=offset, frames=length)[0]
    raise ValueError(f"cannot load features from {path!r}")
