"""The frozen roofline and model counters against cases worked out by hand."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.yardstick import counters, flops  # noqa: E402


def test_bound_takes_the_larger_side():
    t, by = counters.bound_s(3.35e12, 0.0)
    assert (t, by) == (1.0, "bytes")
    t, by = counters.bound_s(0.0, 989e12)
    assert (t, by) == (1.0, "operations")
    t, by = counters.bound_s(1.0, 67e12, counters.FP32_FLOPS)
    assert by == "operations" and t == pytest.approx(1.0)


def test_k1_counts():
    # B 2, T 3, H 1, D 4 in bf16: q, k, v, out = 4 * 24 elements * 2 bytes,
    # the mask 6 bytes; QK^T and PV = 2 * 2 * (2 * 1 * 9 * 4)
    assert counters.k1_counts(2, 3, 1, 4, 2) == (198.0, 288.0)


def test_k2_counts():
    # one layer, 2 channels, kernel 3: x 7 x 2, w 2 x 2 x 3, out 3 x 2 (bf16)
    assert counters.k2_counts(1, 7, 3, 3, 2, channels=2) == (64.0, 72.0)


def test_k3_bytes_counts_distinct_ancestor_rows():
    anc = np.array([[0, 1], [0, 0], [1, 1]], np.int32)
    # step 2 reads times 0 and 1: columns {0, 1} then {0}: 3 rows
    assert counters.k3_distinct_rows(anc, 1, 2, 2) == 3
    # (2 * 3 + 6 * 2) rows of H 1 x D 2 in bf16, and (2 + 1) x 2 ancestry ints
    assert counters.k3_bytes(anc, 1, 2, 1, 2, 2, 2) == 96.0
    assert counters.k3_distinct_rows(anc, 1, 2, 0) == 0


def test_k3_distinct_rows_matches_sets():
    rng = np.random.default_rng(0)
    S, C, L = 3, 5, 9
    anc = rng.integers(0, C, size=(L + 1, S * C))
    for idx in (1, 4, 9):
        want = sum(len(set(anc[t, s * C:(s + 1) * C])) for s in range(S) for t in range(idx))
        assert counters.k3_distinct_rows(anc, S, C, idx) == want


def test_k4_counts():
    w = np.zeros((2, 257), np.float32)
    w[0, 1:4] = 1.0
    w[1, 3:5] = 1.0
    n_bytes, ops = counters.k4_counts(1, 560, 2, 2, w)
    assert n_bytes == 4 * (560 + 4 + 400 + 514)
    per_frame = 5 * 400 + 2.5 * 512 * 9 + 3 * 257 + 2 * 5 + 2
    assert ops == pytest.approx(2 * per_frame)


def test_mel_weights_are_kaldi_triangles():
    w = counters.mel_weights(80)
    assert w.shape == (80, 257) and w.min() >= 0 and w.max() <= 1
    # every bin has a triangle, and no FFT bin below 20 Hz (bin 0) is used
    assert (w.max(axis=1) > 0).all() and not w[:, 0].any()


def test_encoder_stack_and_decoder():
    # one layer, T 2, D 1, F 3: 8*2 + 4*4 + 4*2*3
    assert flops.encoder_stack(2, 1, 3, 1) == 16 + 16 + 24
    # teacher-forced U 2, memory 3, D 1, F 1, V 5, one layer
    want = 8 * 2 + 2 * 2 * 3 + 4 * 2 + 4 * 3 + 4 * 2 * 3 + 4 * 2 + 2 * 2 * 5
    assert flops.decoder_teacher(2, 3, 1, 1, 5, 1) == want


def test_decoder_beam_sums_its_steps():
    D, F, V, L, mem, steps, rows = 4, 8, 11, 2, 3, 5, 2
    per_row = sum(L * (8 * D * D + 4 * (i + 1) * D + 4 * D * D + 4 * mem * D + 4 * D * F)
                  + 2 * D * V for i in range(steps))
    want = rows * per_row + L * 4 * mem * D * D
    assert flops.decoder_beam(steps, rows, mem, D, F, V, L) == pytest.approx(want)


def test_conv_lengths():
    spec = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
    # one second of 16 kHz audio: the wav2vec 2.0 extractor's 49 frames
    assert flops.conv_lengths(16000, spec)[-1] == 49
    assert flops.subsampled(49, 2) == 13
