"""Parity of the PyTorch port's fbank speech-to-text transformer with the
JAX package on the CPU: ``encode_audio`` (states and padding mask) and
teacher-forced logits from log-mel features and from raw wav
(``compute_fbank``), beam search against the JAX generator, the presets and
the flax -> torch converter.

Weights are made once by flax and carried across with
``convert.s2t_params_from_flax``; inputs come from numpy with a fixed seed.
Tolerance 1e-4 (fp32 through ~10 chained layers) unless stated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint import torch_import
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.models import build_model_from_arch
from chimera_st_tpu.models.s2t_transformer import S2TTransformerConfig as JaxConfig
from chimera_st_tpu.models.s2t_transformer import S2TTransformerModel as JaxModel
from chimera_st_tpu_torch.convert import s2t_params_from_flax
from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
from chimera_st_tpu_torch.models.s2t_transformer import (
    ARCHITECTURES,
    S2TTransformerConfig,
    S2TTransformerModel,
    build_s2t_transformer,
    s2t_config,
)
from tests.test_torch_models import numpy_tree

TOL = dict(atol=1e-4, rtol=1e-4)
# tests/test_s2t_transformer.py's TINY with 80-d features and 2 layers each
TINY = JaxConfig(
    tgt_vocab_size=20, input_feat_per_channel=80, conv_channels=16, encoder_embed_dim=16,
    encoder_ffn_dim=32, encoder_layers=2, encoder_heads=2, decoder_embed_dim=16,
    decoder_ffn_dim=32, decoder_layers=2, decoder_heads=2,
)
PREV = np.array([[2, 5, 6, 7, 1], [2, 8, 9, 1, 1], [2, 4, 1, 1, 1]], np.int32)


def port_config(jax_cfg) -> S2TTransformerConfig:
    known = {f.name for f in dataclasses.fields(S2TTransformerConfig)}
    return S2TTransformerConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items()
                                   if k in known})


def inputs(compute_fbank: bool, seed: int = 0):
    """A padded batch of 3: raw wav [3, 8000] (rows of 8000, 5000 and 3000
    samples) or log-mel-like features [3, 48, 80] (48, 30 and 17 frames)."""
    rng = np.random.default_rng(seed)
    T, lengths = (8000, (8000, 5000, 3000)) if compute_fbank else (48, (48, 30, 17))
    shape = (3, T) if compute_fbank else (3, T, 80)
    x = (rng.normal(size=shape) * (0.1 if compute_fbank else 1.0)).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.array(lengths)[:, None]
    x[mask] = 0.0
    return x, mask


def flax_init(cfg, seed: int = 0):
    model = JaxModel(cfg)
    x, mask = inputs(cfg.compute_fbank)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mask),
                        jnp.asarray(PREV))
    return model, params


def port_model(cfg, params) -> S2TTransformerModel:
    model = S2TTransformerModel(port_config(cfg), device="cpu")
    model.load_state_dict(s2t_params_from_flax(numpy_tree(params)), strict=True)
    return model.eval()


@pytest.mark.parametrize("compute_fbank", [False, True])
def test_encode_audio_and_teacher_forced_logits_match_jax(compute_fbank):
    cfg = dataclasses.replace(TINY, compute_fbank=compute_fbank)
    jm, params = flax_init(cfg)
    model = port_model(cfg, params)
    x, mask = inputs(compute_fbank, seed=1)
    enc_j, mask_j = jm.apply(params, jnp.asarray(x), jnp.asarray(mask),
                             method=JaxModel.encode_audio)
    logits_j = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(PREV))
    with torch.no_grad():
        enc, enc_mask = model.encode_audio(torch.from_numpy(x), torch.from_numpy(mask))
        logits = model(torch.from_numpy(x), torch.from_numpy(mask),
                       torch.from_numpy(PREV).long())
    np.testing.assert_array_equal(enc_mask.numpy(), np.asarray(mask_j))
    assert enc_mask.any() and not enc_mask.all(dim=1).any()  # padded, no empty row
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


def test_frame_mask_counts_only_full_frames_of_real_samples():
    """compute_fbank: a row of n real samples keeps max(1 + (n - 400) // 160,
    0) frames (floor division, so 399 samples keep none) before the
    subsampler, as the JAX model masks them."""
    cfg = dataclasses.replace(TINY, compute_fbank=True, encoder_layers=1, decoder_layers=1)
    jm, params = flax_init(cfg)
    model = port_model(cfg, params)
    wav = np.random.default_rng(5).normal(size=(3, 2000)).astype(np.float32) * 0.1
    mask = np.arange(2000)[None, :] >= np.array([2000, 560, 399])[:, None]
    _, mask_j = jm.apply(params, jnp.asarray(wav), jnp.asarray(mask),
                         method=JaxModel.encode_audio)
    with torch.no_grad():
        _, got = model.encode_audio(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(mask_j))
    # 2000 samples: 11 frames -> 6 -> 3; 560: 2 -> 1 -> 1; 399: none
    assert (~got).sum(dim=1).tolist() == [3, 1, 0]


@pytest.fixture(scope="module")
def fbank_decoder_scaled():
    """The compute_fbank TINY model with its decoder kernels scaled x4 so
    that the random beams differ (as tests/test_torch_generation.py)."""
    cfg = dataclasses.replace(TINY, compute_fbank=True)
    _, params = flax_init(cfg, seed=3)
    scaled = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * 4.0
        if "decoder" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path)
        else np.asarray(x), params)
    return cfg, scaled


@pytest.mark.parametrize("eos_scale,settings", [
    (1.0, dict(min_len=2, len_penalty=0.5)),  # eos forced at max_decode_len
    (6.0, dict(min_len=1, len_penalty=1.0)),  # natural eos too
])
def test_generate_audio_matches_jax(fbank_decoder_scaled, eos_scale, settings):
    """Beam 3 over padded encoder states: every beam's tokens and length
    exactly, scores to 1e-4."""
    cfg, params = fbank_decoder_scaled
    params = numpy_tree(params)
    emb = params["params"]["decoder"]["embed_tokens"]["embedding"].copy()
    emb[2] *= eos_scale  # eos = 2
    params["params"]["decoder"]["embed_tokens"]["embedding"] = emb
    wav, mask = inputs(True, seed=4)
    common = dict(beam_size=3, max_decode_len=14, **settings)

    jax_gen = JaxGenerator(JaxModel(cfg), JaxSettings(**common))
    ref = jax_gen.generate_audio(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(wav),
                                 jnp.asarray(mask))
    ref_tokens, ref_scores, ref_lens = map(np.asarray, ref)

    gen = SequenceGenerator(port_model(cfg, params), GeneratorSettings(**common))
    tokens, scores, lens = gen.generate_audio(torch.from_numpy(wav), torch.from_numpy(mask))

    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(scores.numpy(), ref_scores, **TOL)
    assert len({tuple(t) for t in tokens.numpy().reshape(-1, 14)}) > 3  # beams differ
    assert (lens.numpy() < 14).any() == (eos_scale > 1)  # some hypotheses end early


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_presets_match_jax_registry(arch):
    overrides = {"tgt_vocab_size": 10, "encoder_layers": 1, "decoder_layers": 1}
    ref = build_model_from_arch(arch, dict(overrides)).cfg
    assert s2t_config(arch, overrides) == port_config(ref)
    # without the layer overrides the deep presets keep 16 encoder layers
    deep = s2t_config(arch, {"tgt_vocab_size": 10}).encoder_layers
    assert deep == (16 if arch.endswith("p") else 12)


def test_untied_output_projection_is_not_implemented():
    """Once a refusal, now the untied fbank model: ``s2t_transformer_s``
    with ``share_decoder_input_output_embed=False`` builds with an output
    projection of its own, and at TINY widths its weights from a JAX tree
    give the JAX model's log-probabilities (1e-5) and beam tokens."""
    model = build_s2t_transformer("s2t_transformer_s", {
        "share_decoder_input_output_embed": False, "encoder_layers": 1, "decoder_layers": 1},
        device="cpu")
    assert tuple(model.decoder.output_projection.weight.shape) == (
        model.cfg.tgt_vocab_size, model.cfg.decoder_embed_dim)
    cfg = dataclasses.replace(TINY, share_decoder_input_output_embed=False)
    jm, params = flax_init(cfg, seed=2)
    assert "output_projection" in params["params"]["decoder"]
    port = port_model(cfg, params)
    x, mask = inputs(False, seed=5)
    logits_j = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(PREV))
    with torch.no_grad():
        logits = port(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(PREV).long())
    np.testing.assert_allclose(torch.log_softmax(logits, -1).numpy(),
                               np.asarray(jax.nn.log_softmax(logits_j, -1)),
                               atol=1e-5, rtol=1e-5)
    common = dict(beam_size=2, max_decode_len=8, min_len=2)
    ref = JaxGenerator(jm, JaxSettings(**common)).generate_audio(
        params, jnp.asarray(x), jnp.asarray(mask))
    tokens, scores, lens = SequenceGenerator(port, GeneratorSettings(**common)).generate_audio(
        torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref[1]), **TOL)


@pytest.fixture(scope="module")
def tiny_params():
    return numpy_tree(flax_init(TINY)[1])


def test_converter_round_trips_every_leaf(tiny_params):
    """flax tree -> port state dict (fairseq names) -> the JAX package's
    fairseq -> flax layout helpers -> the same flax tree, leaf for leaf
    (exact)."""
    sd = s2t_params_from_flax(tiny_params)
    back = {}
    for i in range(len(TINY.conv_kernel_sizes)):
        torch_import._conv1d(sd, f"encoder.subsample.conv_layers.{i}", back,
                             ["subsample", f"conv_layers_{i}"])
    for i in range(TINY.encoder_layers):
        torch_import._enc_layer(sd, f"encoder.transformer_layers.{i}", back,
                                [f"transformer_layers_{i}"])
    torch_import._norm(sd, "encoder.layer_norm", back, ["encoder_layer_norm"])
    torch_import._embedding(sd, "decoder.embed_tokens", back, ["decoder", "embed_tokens"])
    for i in range(TINY.decoder_layers):
        torch_import._dec_layer(sd, f"decoder.layers.{i}", back, ["decoder", f"layers_{i}"])
    torch_import._norm(sd, "decoder.layer_norm", back, ["decoder", "layer_norm"])
    flat = dict(jax.tree_util.tree_flatten_with_path(tiny_params["params"])[0])
    flat_back = {str(k): v for k, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert set(map(str, flat)) == set(flat_back)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[str(path)], leaf, err_msg=str(path))


def test_converter_rejects_missing_and_extra_keys(tiny_params):
    missing = numpy_tree(tiny_params)
    del missing["params"]["transformer_layers_1"]["fc2"]["bias"]
    with pytest.raises(KeyError, match="transformer_layers_1/fc2/bias"):
        s2t_params_from_flax(missing)
    extra = numpy_tree(tiny_params)
    extra["params"]["decoder"]["mystery_projection"] = {"kernel": np.zeros((16, 20), np.float32)}
    with pytest.raises(ValueError, match="unconsumed flax parameters"):
        s2t_params_from_flax(extra)
    # an untied decoder's output projection is a module of the table
    untied = numpy_tree(tiny_params)
    untied["params"]["decoder"]["output_projection"] = {"kernel": np.ones((16, 20), np.float32)}
    assert s2t_params_from_flax(untied)["decoder.output_projection.weight"].shape == (20, 16)
    # every state-dict entry of the port's model is produced, nothing else
    model = S2TTransformerModel(port_config(TINY), device="cpu")
    assert set(s2t_params_from_flax(tiny_params)) == set(model.state_dict())
