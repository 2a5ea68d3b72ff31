"""K4: the kaldi log-mel frontend, a hand-written CUDA kernel
(csrc/logmel.cu) with its plain PyTorch version beside it.

Replaces the Pallas kernel ``chimera_st_tpu/ops/pallas_logmel.py``
``logmel_pallas``. It serves the fbank speech-to-text transformer with
``compute_fbank=True``: raw 16 kHz wav [B, T] fp32 -> [B, F, M] fp32 log-mel,
F = 1 + (T - 400) // 160 (none below 400 samples). The plain version is
``fbank.logmel_plain``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from . import _build
from .fbank import (
    FFT_SIZE,
    FRAME_LEN,
    PREEMPHASIS,
    SAMPLE_RATE,
    logmel_plain,
    mel_filterbank,
    num_frames,
    povey_window,
)

__all__ = ["logmel", "logmel_cuda", "logmel_plain", "mel_ranges"]


def mel_ranges(weights: np.ndarray) -> np.ndarray:
    """[M, 2] int32: the [first, last + 1) non-zero columns of each row of
    the [M, 257] mel weights ([0, 0] for an all-zero row)."""
    out = np.zeros((weights.shape[0], 2), np.int32)
    for m, row in enumerate(weights):
        nz = np.flatnonzero(row)
        if nz.size:
            out[m] = nz[0], nz[-1] + 1
    return out


@lru_cache(maxsize=8)
def _kernel_constants(device: torch.device, num_mel_bins: int):
    """Window, twiddles, mel weights and their ranges on ``device``, made
    once per (device, M); the kernel only reads them."""
    ang = 2.0 * math.pi * np.arange(FFT_SIZE // 2) / FFT_SIZE
    twiddle = np.concatenate([np.cos(ang), -np.sin(ang)])  # float64: K4's FFT is fp64
    mel_w = mel_filterbank(num_mel_bins, FFT_SIZE, SAMPLE_RATE)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (povey_window(FRAME_LEN), twiddle, mel_w, mel_ranges(mel_w)))


def logmel_cuda(wav: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """Launches K4. wav: [B, T] contiguous float32 CUDA tensor ->
    [B, F, num_mel_bins] float32. Fewer than 400 samples give F = 0 and no
    launch."""
    if not wav.is_cuda:
        raise RuntimeError("logmel_cuda takes CUDA tensors")
    if wav.dim() != 2 or wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError("wav must be a contiguous float32 [B, T] tensor")
    B, T = wav.shape
    F = num_frames(T)
    if F == 0 or B == 0:
        return wav.new_zeros((B, F, num_mel_bins))
    if B > 65535:
        raise ValueError("log-mel kernel takes at most 65535 utterances a call")
    window, twiddle, mel_w, ranges = _kernel_constants(wav.device, num_mel_bins)
    out = torch.empty((B, F, num_mel_bins), dtype=torch.float32, device=wav.device)
    err = _build.kernel("logmel")(
        wav.data_ptr(), window.data_ptr(), twiddle.data_ptr(), mel_w.data_ptr(),
        ranges.data_ptr(), out.data_ptr(), B, T, F, num_mel_bins, PREEMPHASIS,
        _build.stream_handle(wav.device),
    )
    _build.check_launch("logmel", err)
    logmel.launches += 1
    return out


def logmel(wav: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """Kaldi log-mel of a [B, T] float32 batch. A CPU tensor takes the plain
    version; a CUDA tensor launches K4 (or raises)."""
    if wav.is_cuda:
        return logmel_cuda(wav, num_mel_bins)
    return logmel_plain(wav, num_mel_bins)


logmel.launches = 0
