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
