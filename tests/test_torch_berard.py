"""``s2t_berard`` against the JAX package on the CPU: teacher-forced logits
and every gradient from the same seeded weights on fbank features with
padding (``test_torch_zoo.check_model``, 1e-4 of the largest JAX value), at
odd lengths where flax's SAME padding at stride 2 puts the extra step at the
end; the lengths after each convolution; the presets; and the port's
``compute_fbank`` input, the wave through the log-mel (K4's plain version
here) equal to the model on those features, with one ``TrainStep`` update
over an ``audio`` batch of ``label_smoothed_cross_entropy``, the call the
card's ``zoo_steps`` phase makes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.config.registry import ARCHITECTURES as JAX_ARCHITECTURES
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.config.registry import ARCHITECTURES
from chimera_st_tpu_torch.criterions.label_smoothed_ce import make_label_smoothed_ce
from chimera_st_tpu_torch.models import berard
from chimera_st_tpu_torch.models.interlingua import init_params_
from chimera_st_tpu_torch.ops.fbank import logmel_plain, num_frames
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.train.train_step import TrainStep
from tests.test_torch_zoo import check_model, jax_model, port_model

V = 19
TINY = dict(tgt_vocab_size=V, input_feat_per_channel=13, conv_channels=(3, 4), lstm_size=8,
            encoder_layers=2, decoder_embed_dim=6, decoder_hidden=10, decoder_layers=2,
            attention_dim=7, dropout=0.2)
PREV = np.array([[2, 5, 14, 3, 8], [2, 7, 10, 1, 1]], np.int32)


@pytest.mark.parametrize("T", [17])
def test_logits_and_gradients_match_jax(T):
    rng = np.random.default_rng(T)
    feats = rng.normal(size=(2, T, 13)).astype(np.float32)
    mask = np.zeros((2, T), bool)
    mask[1, T - 6:] = True
    port = port_model("s2t_berard", TINY)
    assert convert.model_kind(port) == "s2t_berard"
    check_model(jax_model("s2t_berard", TINY),
                (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(PREV)), port,
                (torch.from_numpy(feats), torch.from_numpy(mask), torch.from_numpy(PREV).long()),
                "s2t_berard", seed=T)
    _, enc_mask = port.encode_audio(torch.from_numpy(feats), torch.from_numpy(mask))
    lengths = (~torch.from_numpy(mask)).sum(dim=1)
    for _ in range(2):
        lengths = (lengths + 1) // 2
    assert enc_mask.shape[1] == -(-(-(-T // 2)) // 2)
    assert torch.equal((~enc_mask).sum(dim=1), lengths)


@pytest.mark.parametrize("size, kernel, stride", [(17, 3, 2), (22, 3, 2), (13, 3, 2), (9, 3, 1),
                                                  (8, 4, 1)])
def test_same_padding_is_flax_same(size, kernel, stride):
    """The port's explicit padding gives flax ``padding='SAME'``'s output
    (an odd total pads one more step at the end)."""
    from flax import linen as nn

    x = np.random.default_rng(size).normal(size=(1, size, 1, 1)).astype(np.float32)
    conv = nn.Conv(1, (kernel, 1), strides=(stride, 1), padding="SAME", use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))[0, :, 0, 0]
    w = np.asarray(params["params"]["kernel"])[:, 0, 0, 0]
    lo, hi = berard.same_padding(size, kernel, stride)
    xp = np.pad(x[0, :, 0, 0], (lo, hi))
    got = np.array([xp[i * stride:i * stride + kernel] @ w for i in range(len(want))])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_presets_match_jax():
    for arch in ("s2t_berard", "s2t_berard_256_3_3", "s2t_berard_512_3_2",
                 "s2t_berard_512_5_3"):
        assert ARCHITECTURES.get(arch)[1]({}) == JAX_ARCHITECTURES.get(arch)[1]({}), arch


def test_compute_fbank_input_and_one_update_on_the_cpu():
    """The wave through the log-mel equals the model on those features; one
    TrainStep update over the audio batch is finite and moves the
    parameters."""
    cfg = dict(TINY, input_feat_per_channel=80)
    on_wave = berard.build_berard({**cfg, "compute_fbank": True}, device="cpu")
    on_feats = berard.build_berard(cfg, device="cpu")
    init_params_(on_wave, torch.Generator().manual_seed(0))
    on_feats.load_state_dict(on_wave.state_dict())
    rng = np.random.default_rng(1)
    wav = torch.from_numpy((rng.normal(size=(2, 6000)) * 0.1).astype(np.float32))
    wav_mask = torch.zeros(2, 6000, dtype=torch.bool)
    wav_mask[1, 4000:] = True
    prev = torch.from_numpy(PREV).long()
    feats = logmel_plain(wav)
    frame_mask = torch.arange(feats.shape[1])[None, :] >= num_frames((~wav_mask).sum(dim=1))[:, None]
    on_wave.eval()
    on_feats.eval()
    torch.testing.assert_close(on_wave(wav, wav_mask, prev), on_feats(feats, frame_mask, prev))

    on_wave.train()
    step = TrainStep(on_wave, make_label_smoothed_ce({"label_smoothing": 0.1}),
                     build_optimizer({"_name": "adam"}, list(on_wave.parameters())),
                     build_lr_schedule({"_name": "fixed", "lr": 1e-3}),
                     compute_dtype=torch.float32)
    before = [p.detach().clone() for p in on_wave.parameters()]
    target = torch.cat([prev[:, 1:], torch.full((2, 1), 2)], dim=1)
    out = step([{"audio": wav, "audio_padding_mask": wav_mask, "prev_output_tokens": prev,
                 "target": target, "ntokens": 8.0}])
    assert np.isfinite(float(out["loss"])) and np.isfinite(float(out["gnorm"]))
    assert any(not torch.equal(a, p) for a, p in zip(before, on_wave.parameters()))


@pytest.mark.parametrize("real", [400, 559, 560, 5999])
def test_wave_features_mask_frames_past_the_real_samples(real):
    """``ops.logmel.wave_features``, the one front end of both fbank
    models: the plain log-mel of the padded batch, and a frame is real
    exactly where the row's real samples fill it (at the 400-sample window
    and the 160-sample shift's edges)."""
    from chimera_st_tpu_torch.ops.logmel import wave_features

    wav = torch.from_numpy(np.random.default_rng(real).normal(size=(2, 6000)).astype(np.float32))
    mask = torch.zeros(2, 6000, dtype=torch.bool)
    mask[1, real:] = True
    feats, frame_mask = wave_features(wav, mask)
    torch.testing.assert_close(feats, logmel_plain(wav), rtol=0, atol=0)
    assert frame_mask.shape == feats.shape[:2]
    assert not frame_mask[0].any()
    assert int((~frame_mask[1]).sum()) == 1 + (real - 400) // 160
