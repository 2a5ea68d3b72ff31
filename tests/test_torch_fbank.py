"""Parity of the PyTorch port's log-mel frontend (K4's plain version, and
the window and filterbank it is built from) with the JAX package on the
CPU: the Pallas kernel in interpret mode, ``logmel_jax`` and the host-side
kaldi-compatible ``logmel_numpy``.

Tolerance 5e-4 absolute on log values, what ``tests/test_pallas_logmel.py``
holds the TPU kernel to (fp32 spectra summed in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.ops import fbank as jax_fbank
from chimera_st_tpu.ops.pallas_logmel import logmel_pallas
from chimera_st_tpu_torch.ops import fbank, logmel

TOL = dict(atol=5e-4, rtol=0)


def _tone(samples: int = 16000, hz: float = 1000.0) -> np.ndarray:
    t = np.arange(samples) / 16000
    return np.sin(2 * np.pi * hz * t).astype(np.float32)[None]


CASES = {
    "batch2_1s": lambda: np.random.default_rng(0).normal(size=(2, 16000)).astype(np.float32),
    # 204 frames: not a multiple of the Pallas kernel's 128-frame block
    "33000_samples": lambda: np.random.default_rng(1).normal(size=(1, 33000)).astype(np.float32),
    "zero_padded_row": lambda: np.concatenate(
        [np.random.default_rng(2).normal(size=(1, 8000)) * 0.1,
         np.pad(np.random.default_rng(3).normal(size=(1, 3000)), ((0, 0), (0, 5000)))],
    ).astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logmel_matches_jax_pallas_and_numpy(case):
    wav = CASES[case]()
    before = logmel.logmel.launches
    got = logmel.logmel(torch.from_numpy(wav)).numpy()
    assert logmel.logmel.launches == before  # a CPU tensor takes the plain version
    frames = 1 + (wav.shape[1] - 400) // 160
    assert got.shape == (wav.shape[0], frames, 80) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.stack([jax_fbank.logmel_numpy(w) for w in wav]), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_fbank.logmel_jax(jnp.asarray(wav))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(logmel_pallas(jnp.asarray(wav), interpret=True)), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logmel_plain_float64_is_exact(case):
    """A float64 wav gives a float64 log-mel (K4's exact reference on the
    card): equal to a float64 numpy mirror of the kaldi steps within 1e-9,
    and within the fp32 tolerance of the float32 version."""
    wav = CASES[case]().astype(np.float64)
    got = fbank.logmel_plain(torch.from_numpy(wav))
    assert got.dtype == torch.float64
    n = np.arange(1 + (wav.shape[1] - 400) // 160)[:, None] * 160 + np.arange(400)
    frames = wav[:, n]
    frames = frames - frames.mean(-1, keepdims=True)
    frames = frames - 0.97 * np.concatenate([frames[..., :1], frames[..., :-1]], -1)
    spec = np.fft.rfft(frames * jax_fbank.povey_window(400).astype(np.float64), n=512)
    mel = (spec.real ** 2 + spec.imag ** 2) @ jax_fbank.mel_filterbank(80, 512, 16000).T.astype(
        np.float64)
    np.testing.assert_allclose(got.numpy(), np.log(np.maximum(mel, 1.1920929e-07)),
                               atol=1e-9, rtol=0)
    np.testing.assert_allclose(got.numpy(), fbank.logmel_plain(
        torch.from_numpy(wav.astype(np.float32))).numpy(), **TOL)


def test_all_zero_frames_are_the_log_floor():
    """Frames of zero padding come out at log(1.1920929e-07) exactly, as in
    the JAX package; the frames before them are real."""
    wav = CASES["zero_padded_row"]()
    got = logmel.logmel(torch.from_numpy(wav)).numpy()
    floor = np.float32(np.log(np.float32(1.1920929e-07)))
    last_real = (3000 - 1) // 160  # frames starting at or after sample 3000 are all zero
    assert (got[1, last_real + 1:] == floor).all()
    assert (got[1, :last_real] > floor).all()


def test_tone_peak_bin_matches():
    tone = _tone()
    got = logmel.logmel(torch.from_numpy(tone)).numpy()[0]
    ref = jax_fbank.logmel_numpy(tone[0])
    assert got.mean(0).argmax() == ref.mean(0).argmax()
    pallas = np.asarray(logmel_pallas(jnp.asarray(tone), interpret=True))[0]
    assert got.mean(0).argmax() == pallas.mean(0).argmax()
    # the bins that carry the tone agree to the usual tolerance
    loud = ref > ref.max() - 20.0
    np.testing.assert_allclose(got[loud], ref[loud], **TOL)


@pytest.mark.parametrize("samples", [0, 150, 399])
def test_fewer_than_400_samples_give_no_frames(samples):
    wav = torch.zeros(3, samples)
    got = logmel.logmel(wav)
    assert got.shape == (3, 0, 80) and got.dtype == torch.float32
    assert np.asarray(jax_fbank.logmel_jax(jnp.zeros((3, samples)))).shape == (3, 0, 80)
    assert fbank.num_frames(samples) == 0
    assert fbank.num_frames(torch.tensor([samples, 400, 559, 560])).tolist() == [0, 1, 1, 2]


@pytest.mark.parametrize("num_bins", [80, 40])
def test_window_and_filterbank_equal_jax_exactly(num_bins):
    np.testing.assert_array_equal(fbank.povey_window(400), jax_fbank.povey_window(400))
    np.testing.assert_array_equal(fbank.mel_filterbank(num_bins, 512, 16000),
                                  jax_fbank.mel_filterbank(num_bins, 512, 16000))
    assert fbank._next_pow2(400) == jax_fbank._next_pow2(400) == fbank.FFT_SIZE


def test_mel_ranges_cover_every_nonzero_weight():
    """K4 sums each mel bin over [first, last + 1) of its non-zero FFT bins:
    every non-zero weight lies inside its row's range."""
    w = fbank.mel_filterbank(80, 512, 16000)
    ranges = logmel.mel_ranges(w)
    cols = np.arange(w.shape[1])[None, :]
    inside = (cols >= ranges[:, :1]) & (cols < ranges[:, 1:])
    assert (w[~inside] == 0).all() and (ranges[:, 1] > ranges[:, 0]).all()


# ---- numpy mirror of the K4 kernel's arithmetic (csrc/logmel.cu)

_W512 = np.exp(-2j * np.pi * np.arange(256) / 512)  # the kernel's twiddle table


def _fft8_mirror(x):
    """Radix-8 butterfly over the last axis, as the kernel's fft8: two
    4-point transforms of the even and the odd samples, then W8^k."""
    def fft4(y0, y1, y2, y3):
        a, b, c, d = y0 + y2, y0 - y2, y1 + y3, y1 - y3
        return a + c, b - 1j * d, a - c, b + 1j * d

    e = fft4(x[..., 0], x[..., 2], x[..., 4], x[..., 6])
    o = fft4(x[..., 1], x[..., 3], x[..., 5], x[..., 7])
    r = np.sqrt(0.5)
    p = (o[0], o[1] * (r - 1j * r), o[2] * -1j, o[3] * (-r - 1j * r))
    return np.stack([e[k] + p[k] for k in range(4)] + [e[k] - p[k] for k in range(4)], axis=-1)


def _powers(w0, w):
    """w0 * w^k, k = 0..7, by repeated multiplication (the kernel's twiddle8)."""
    out = [w0]
    for _ in range(7):
        out.append(out[-1] * w)
    return np.stack(out, axis=-1)


def _slot(a, b, c):
    return 72 * a + 9 * b + c


def _k4_fft512_mirror(z):
    """[P, 512] complex -> [P, 512]: 512 = 8 x 8 x 8 with n = 64 n1 + 8 n2 +
    n3 and k = k1 + 8 k2 + 64 k3, every butterfly writing its outputs over
    its inputs in a buffer padded to 72 a + 9 b + c."""
    P = z.shape[0]
    buf = np.full((P, 8 * 72), np.nan, complex)
    i8 = np.arange(8)
    for u in range(64):  # pass 1: butterfly (n2, n3) over n1, times W64^(n2 k1)
        n2, n3 = u >> 3, u & 7
        x = _fft8_mirror(z[:, 64 * i8 + u]) * _powers(1.0 + 0j, _W512[8 * n2])
        buf[:, _slot(i8, n2, n3)] = x
    for u in range(64):  # pass 2: butterfly (k1, n3) over n2, times W512^(n3 (k1 + 8 k2))
        k1, n3 = u >> 3, u & 7
        x = _fft8_mirror(buf[:, _slot(k1, i8, n3)]) * _powers(_W512[k1 * n3], _W512[8 * n3])
        buf[:, _slot(k1, i8, n3)] = x
    for u in range(64):  # pass 3: butterfly (k1, k2) over n3
        k1, k2 = u >> 3, u & 7
        buf[:, _slot(k1, k2, i8)] = _fft8_mirror(buf[:, _slot(k1, k2, i8)])
    k = np.arange(512)
    return buf[:, _slot(k & 7, (k >> 3) & 7, k >> 6)]


def _k4_pair_powers(za, zb):
    """Power spectra [P, 257] of two real [P, 512] signals from ONE complex
    transform of za + i zb, separated by symmetry as the kernel does."""
    z = _k4_fft512_mirror(za + 1j * zb)
    k = np.arange(257)
    zk, zm = z[:, k], z[:, (512 - k) % 512]
    ar, ai = zk.real + zm.real, zk.imag - zm.imag  # 2 X_a
    br, bi = zk.imag + zm.imag, zm.real - zk.real  # 2 X_b
    return 0.25 * (ar * ar + ai * ai), 0.25 * (br * br + bi * bi)


def _k4_logmel_mirror(wav, num_mel_bins=80):
    """The whole kernel in float64 from float32 samples: frames paired (an
    odd last frame with zeros), DC removal, pre-emphasis, window, the packed
    transform, the compact mel sums, log of the float32 mel value."""
    B, T = wav.shape
    F = 1 + (T - 400) // 160
    idx = np.arange(F)[:, None] * 160 + np.arange(400)
    v = wav.astype(np.float64)[:, idx]  # [B, F, 400]
    v = v - v.sum(-1, keepdims=True) / 400
    y = (v - 0.97 * np.concatenate([v[..., :1], v[..., :-1]], -1)) * fbank.povey_window(400).astype(
        np.float64)
    y = np.pad(y, ((0, 0), (0, F % 2), (0, 112))).reshape(B * ((F + 1) // 2), 2, 512)
    pa, pb = _k4_pair_powers(y[:, 0], y[:, 1])
    power = np.stack([pa, pb], 1).reshape(B, -1, 257)[:, :F]
    values, meta = logmel.mel_compact(fbank.mel_filterbank(num_mel_bins, 512, 16000))
    mel = np.zeros((B, F, num_mel_bins))
    for m in range(num_mel_bins):
        first, off, end = meta[0, m], meta[1, m], meta[1, m + 1]
        for part in range(4):  # four lanes a mel bin, each every fourth weight
            i = np.arange(part, end - off, 4)
            mel[..., m] += (values[off + i].astype(np.float64) * power[..., first + i]).sum(-1)
    return np.log(np.maximum(mel.astype(np.float32), np.float32(1.1920929e-07)))


def test_k4_radix8_transform_mirror_matches_numpy_fft():
    """The kernel's 8 x 8 x 8 transform on complex input vs np.fft.fft, and
    its real-input packing with the separation step vs np.fft.rfft, in
    float64; 1e-10 of the spectrum's largest value."""
    rng = np.random.default_rng(11)
    z = rng.normal(size=(5, 512)) + 1j * rng.normal(size=(5, 512))
    ref = np.fft.fft(z)
    np.testing.assert_allclose(_k4_fft512_mirror(z), ref, atol=1e-10 * np.abs(ref).max(), rtol=0)
    a, b = rng.normal(size=(2, 5, 512))
    b[3] = 0.0  # a frame paired with zeros
    pa, pb = _k4_pair_powers(a, b)
    for got, x in ((pa, a), (pb, b)):
        want = np.abs(np.fft.rfft(x)) ** 2
        np.testing.assert_allclose(got, want, atol=1e-10 * want.max(), rtol=0)
    assert pb[3].max() < 1e-24  # the zero frame's leakage: far below the log floor


def test_mel_compact_rebuilds_the_filterbank():
    """The compact runs K4 reads hold every non-zero weight at its place, at
    most two an FFT bin, within the kernel's shared-memory room."""
    for bins in (80, 40):
        w = fbank.mel_filterbank(bins, 512, 16000)
        values, meta = logmel.mel_compact(w)
        dense = np.zeros_like(w)
        for m in range(bins):
            n = meta[1, m + 1] - meta[1, m]
            dense[m, meta[0, m]:meta[0, m] + n] = values[meta[1, m]:meta[1, m + 1]]
        np.testing.assert_array_equal(dense, w)
        assert (w != 0).sum(0).max() <= 2 and values.size <= logmel.MAX_MEL_WEIGHTS
        assert meta[1, bins] == values.size and bins <= logmel.MAX_MEL_BINS


K4_CASES = {
    "even_frames": lambda: np.random.default_rng(20).normal(size=(2, 33000)).astype(np.float32),
    # 99 frames: the last one is paired with zeros
    "odd_frames": lambda: (np.random.default_rng(21).normal(size=(1, 16080)) * 0.1).astype(
        np.float32),
    "zero_padded_row": CASES["zero_padded_row"],
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_logmel_mirror_matches_plain_and_pallas(case):
    """The mirrored kernel vs the plain version in float64 (1e-5) and in
    float32, and vs the Pallas kernel in interpret mode (5e-4); all-zero
    frames come out at the log floor exactly, also where such a frame shares
    its transform with a real one."""
    wav = K4_CASES[case]()
    got = _k4_logmel_mirror(wav)
    exact = fbank.logmel_plain(torch.from_numpy(wav.astype(np.float64))).numpy()
    assert got.shape == exact.shape and (got.shape[1] % 2 == 1) == (case == "odd_frames")
    np.testing.assert_allclose(got, exact, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, fbank.logmel_plain(torch.from_numpy(wav)).numpy(), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(logmel_pallas(jnp.asarray(wav), interpret=True)), **TOL)
    if case == "zero_padded_row":
        floor = np.float32(np.log(np.float32(1.1920929e-07)))
        last_real = (3000 - 1) // 160
        assert (got[1, last_real + 1:] == floor).all() and (got[1, :last_real] > floor).all()
