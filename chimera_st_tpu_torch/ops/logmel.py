"""K4: the kaldi log-mel frontend, a hand-written CUDA kernel
(csrc/logmel.cu) with its plain PyTorch version beside it.

Replaces the Pallas kernel ``chimera_st_tpu/ops/pallas_logmel.py``
``logmel_pallas``. It serves the fbank speech-to-text transformer with
``compute_fbank=True``: raw 16 kHz wav [B, T] fp32 -> [B, F, M] fp32 log-mel,
F = 1 + (T - 400) // 160 (none below 400 samples). The plain version is
``fbank.logmel_plain``.

On the H100 neither the bytes (640 in, 320 out a frame) nor the fp64
operations bound the kernel, but one warp's chain of dependent steps and
its round trips through shared memory. The kernel packs two neighbouring
frames into one complex 512-point transform (separated afterwards by
symmetry), runs it as three radix-8 passes in registers with two exchanges
through padded shared memory, reads its inputs from samples the block
staged once, and sums the mel bins from the compact non-zero runs of the
triangles (``mel_compact``), four lanes a bin. All arithmetic between the
fp32 samples and the fp32 mel value is fp64.
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

__all__ = ["logmel", "logmel_cuda", "logmel_plain", "mel_compact", "mel_ranges",
           "wave_features"]

# what csrc/logmel.cu holds in shared memory
MAX_MEL_BINS = 128
MAX_MEL_WEIGHTS = 520


def mel_ranges(weights: np.ndarray) -> np.ndarray:
    """[M, 2] int32: the [first, last + 1) non-zero columns of each row of
    the [M, 257] mel weights ([0, 0] for an all-zero row)."""
    out = np.zeros((weights.shape[0], 2), np.int32)
    for m, row in enumerate(weights):
        nz = np.flatnonzero(row)
        if nz.size:
            out[m] = nz[0], nz[-1] + 1
    return out


def mel_compact(weights: np.ndarray):
    """The [M, 257] mel weights as K4 reads them: ``values``, the run of
    columns [first, last + 1) of each row, one run after the other (float32),
    and ``meta`` [2, M + 1] int32, row 0 the first column of each run, row 1
    its offset in ``values`` (entry M = len(values))."""
    ranges = mel_ranges(weights)
    lens = ranges[:, 1] - ranges[:, 0]
    meta = np.zeros((2, weights.shape[0] + 1), np.int32)
    meta[0, :-1] = ranges[:, 0]
    meta[1, 1:] = np.cumsum(lens)
    values = np.concatenate([row[a:b] for row, (a, b) in zip(weights, ranges)])
    return values.astype(np.float32), meta


@lru_cache(maxsize=8)
def _kernel_constants(device: torch.device, num_mel_bins: int):
    """Window, twiddles, compact mel weights and their meta on ``device``,
    made once per (device, M); the kernel only reads them."""
    ang = 2.0 * math.pi * np.arange(FFT_SIZE // 2) / FFT_SIZE
    twiddle = np.concatenate([np.cos(ang), -np.sin(ang)])  # float64: K4's FFT is fp64
    values, meta = mel_compact(mel_filterbank(num_mel_bins, FFT_SIZE, SAMPLE_RATE))
    if num_mel_bins > MAX_MEL_BINS or not 0 < values.size <= MAX_MEL_WEIGHTS:
        raise ValueError(f"log-mel kernel takes at most {MAX_MEL_BINS} mel bins with "
                         f"{MAX_MEL_WEIGHTS} non-zero weights")
    return tuple(torch.from_numpy(a).to(device)
                 for a in (povey_window(FRAME_LEN), twiddle, values, meta))


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
    window, twiddle, mel_w, meta = _kernel_constants(wav.device, num_mel_bins)
    out = torch.empty((B, F, num_mel_bins), dtype=torch.float32, device=wav.device)
    err = _build.kernel("logmel")(
        wav.data_ptr(), window.data_ptr(), twiddle.data_ptr(), mel_w.data_ptr(),
        meta.data_ptr(), out.data_ptr(), B, T, F, num_mel_bins, mel_w.numel(), PREEMPHASIS,
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


def wave_features(wav: torch.Tensor, padding_mask: torch.Tensor, num_mel_bins: int = 80):
    """A padded batch of 16 kHz waves [B, T] and its padding mask (True =
    pad) -> the log-mel features [B, F, num_mel_bins] (``logmel``: K4 on the
    card) and their padding mask [B, F], a frame being real where the
    wave's real samples fill it."""
    samples = (~padding_mask).sum(dim=-1)
    features = logmel(wav.float().contiguous(), num_mel_bins)
    pos = torch.arange(features.shape[1], device=features.device)[None, :]
    return features, pos >= num_frames(samples)[:, None]
