"""Kaldi-compatible log-mel filterbank parameters and the plain PyTorch
log-mel (counterpart of chimera_st_tpu/ops/fbank.py; own numpy copies of
its window and filterbank, so the port imports nothing of the JAX package).

Defaults are kaldi's: 25 ms povey window, 10 ms shift, pre-emphasis 0.97
against the previous sample (the first sample against itself), DC removal,
snip edges, 512-point power spectrum, 80 mel bins from 20 Hz to Nyquist,
log floored at float32 epsilon.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME_LEN = 400  # 25 ms @ 16 kHz
FRAME_SHIFT = 160  # 10 ms
PREEMPHASIS = 0.97
LOG_FLOOR = 1.1920929e-07  # float32 epsilon


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


FFT_SIZE = _next_pow2(FRAME_LEN)  # 512
N_BINS = FFT_SIZE // 2 + 1  # 257


def povey_window(n: int) -> np.ndarray:
    # kaldi "povey": hann^0.85
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2 * math.pi * i / (n - 1))
    return (hann**0.85).astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


@lru_cache(maxsize=8)
def mel_filterbank(
    num_bins: int, fft_size: int, sample_rate: int, low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """[num_bins, fft_size // 2 + 1] triangular mel weights (kaldi-style)."""
    nyquist = sample_rate / 2.0
    high = nyquist + high_freq if high_freq <= 0 else high_freq
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high)
    mel_points = np.linspace(mel_low, mel_high, num_bins + 2)
    bins = fft_size // 2 + 1
    fft_freqs = np.arange(bins) * sample_rate / fft_size
    fft_mels = mel_scale(fft_freqs)
    weights = np.zeros((num_bins, bins), np.float64)
    for m in range(num_bins):
        left, center, right = mel_points[m], mel_points[m + 1], mel_points[m + 2]
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        weights[m] = np.maximum(0.0, np.minimum(up, down))
    return weights.astype(np.float32)


def num_frames(samples):
    """Frames of ``samples`` samples with snip edges: max(1 + (n - 400) //
    160, 0), floor division (an int or an int tensor)."""
    if torch.is_tensor(samples):
        return torch.clamp(1 + torch.div(samples - FRAME_LEN, FRAME_SHIFT, rounding_mode="floor"),
                           min=0)
    return max(1 + (samples - FRAME_LEN) // FRAME_SHIFT, 0)


def logmel_plain(wav: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """The plain PyTorch log-mel, the steps of the JAX ``logmel_jax``:
    [B, T] -> [B, F, num_mel_bins], F = num_frames(T). Computes in float64
    for a float64 wav (an exact reference for K4) and in float32 otherwise."""
    dtype = torch.float64 if wav.dtype == torch.float64 else torch.float32
    B, T = wav.shape
    F = num_frames(T)
    if F == 0:
        return wav.new_zeros((B, 0, num_mel_bins), dtype=dtype)
    frames = wav.to(dtype).unfold(1, FRAME_LEN, FRAME_SHIFT)  # [B, F, 400]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPHASIS * pre
    frames = frames * torch.from_numpy(povey_window(FRAME_LEN)).to(frames.device, dtype)
    spec = torch.fft.rfft(frames, n=FFT_SIZE, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel_w = torch.from_numpy(mel_filterbank(num_mel_bins, FFT_SIZE, SAMPLE_RATE))
    mel = torch.matmul(power, mel_w.to(wav.device, dtype).t())
    return torch.log(torch.clamp(mel, min=LOG_FLOOR))
