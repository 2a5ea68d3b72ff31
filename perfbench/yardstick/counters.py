"""The kernels' roofline counters, frozen with the benchmark.

Copied from ``chip_smoke.py`` (``bound_ms``, the K1 and K2 operation
counts of ``k1_case`` / ``k2_case``, ``k3_bytes``, ``k4_flops``) and held
here, where a change to the program cannot move them. Each counts what one
launch needs: every input byte read once, every output byte written once,
and the operations of the function, at the published peaks of one NVIDIA
H100 SXM (data sheet, dense rates).

K2 is counted per launch (one conv layer each), where ``chip_smoke.py``
counted the six layers of one call as one: the operations are the same sum,
and the bytes of each layer's input and output are counted once each.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores, dense
FP32_FLOPS = 67e12  # CUDA cores
FP64_FLOPS = 34e12

# the conv tail's channels and (kernel, stride) of its six layers
K2_CHANNELS = 512


def bound_s(n_bytes: float, flops: float, peak_flops: float = BF16_FLOPS) -> Tuple[float, str]:
    """The least time a launch can take, in seconds, and which bound sets it:
    the larger of the bytes at the HBM rate and the operations at the peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_for(itemsize: int) -> float:
    """The operations peak of a launch in the given element size: bf16 on
    the tensor cores, fp32 on the CUDA cores."""
    return BF16_FLOPS if itemsize == 2 else FP32_FLOPS


def k1_counts(B: int, T: int, H: int, D: int, itemsize: int) -> Tuple[float, float]:
    """K1 (encoder self-attention, [B, T, H, D]): q, k, v read, the output
    written, the key mask read; QK^T and PV over every query and key."""
    n_bytes = 4 * B * T * H * D * itemsize + B * T
    flops = 4 * B * H * T * T * D
    return float(n_bytes), float(flops)


def k2_counts(B: int, t_in: int, t_out: int, kernel: int, itemsize: int,
              channels: int = K2_CHANNELS) -> Tuple[float, float]:
    """One K2 launch (one layer of the conv tail, channels-last): its input,
    its weight and its output once each; 2 operations a multiply-add."""
    n_bytes = (B * t_in * channels + channels * channels * kernel + B * t_out * channels) \
        * itemsize
    flops = 2 * B * t_out * kernel * channels * channels
    return float(n_bytes), float(flops)


def k3_bytes(anc_np: np.ndarray, S: int, C: int, H: int, D: int, idx: int,
             itemsize: int) -> float:
    """The bytes one K3 call must move: the cache rows the step reads
    (distinct ancestor columns per (sentence, time) before the step; the
    step's own row comes from k_new / v_new), q, k_new and v_new, the new
    rows written into the caches, the ancestry rows and the output."""
    N = S * C
    rows = k3_distinct_rows(anc_np, S, C, idx)
    return float((2 * rows + 6 * N) * H * D * itemsize + (idx + 1) * N * 4)


def k3_distinct_rows(anc_np: np.ndarray, S: int, C: int, idx: int) -> int:
    """Distinct ancestor columns per (sentence, time) over times 0..idx-1:
    the sum of len(set(anc[l, s*C:(s+1)*C])), vectorised."""
    if idx <= 0:
        return 0
    a = np.sort(np.asarray(anc_np[:idx]).reshape(idx, S, C), axis=-1)
    return int(idx * S + (a[..., 1:] != a[..., :-1]).sum())


def k3_flops(N: int, H: int, D: int, idx: int) -> float:
    """QK^T and PV of one step over its idx + 1 cached rows."""
    return float(4 * N * H * (idx + 1) * D)


def k4_flops(frames: int, mel_nonzero: int, num_mel_bins: int, fft_flops: float) -> float:
    """Operations of the log-mel for ``frames`` frames with an FFT of
    ``fft_flops`` a frame: framing (mean, DC removal, pre-emphasis, window:
    5 a sample), power (3 a bin), the mel sums over the non-zero weights (2
    each) and one log a mel bin."""
    per_frame = 5 * 400 + fft_flops + 3 * 257 + 2 * mel_nonzero + num_mel_bins
    return float(frames * per_frame)


def mel_weights(bins: int = 80, low: float = 20.0, rate: int = 16000,
                nfft: int = 512) -> np.ndarray:
    """[bins, nfft // 2 + 1] kaldi triangles on the mel scale, from ``low``
    Hz to Nyquist: the weights K4 reads, whose non-zero entries its mel sums
    count."""
    mel = lambda f: 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)
    points = np.linspace(mel(low), mel(rate / 2.0), bins + 2)
    fft_mels = mel(np.arange(nfft // 2 + 1) * rate / nfft)
    w = np.zeros((bins, nfft // 2 + 1))
    for j in range(bins):
        left, centre, right = points[j:j + 3]
        w[j] = np.maximum(0.0, np.minimum((fft_mels - left) / (centre - left),
                                          (right - fft_mels) / (right - centre)))
    return w.astype(np.float32)


def k4_counts(B: int, T: int, F: int, M: int, mel_weights: np.ndarray) -> Tuple[float, float]:
    """One K4 launch ([B, T] fp32 wav -> [B, F, M] fp32 log-mel): the wav,
    the output, the window and the mel weights once each; the operations of
    a real-input 512-point FFT (2.5 N log2 N) and the framing, power, mel
    sums and logs, at the fp32 peak."""
    n_bytes = 4 * (B * T + B * F * M + 400 + mel_weights.size)
    flops = k4_flops(B * F, int((mel_weights != 0).sum()), M, 2.5 * 512 * 9)
    return float(n_bytes), flops


def sum_bounds(items: Sequence[Tuple[float, float, float]]) -> float:
    """Sum of ``bound_s`` over (bytes, flops, peak) triples."""
    return sum(bound_s(b, f, p)[0] for b, f, p in items)
