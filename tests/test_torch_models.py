"""Parity of the PyTorch port's models with the JAX package on the CPU: the
wav2vec2 trunk, the whole interlingua model (audio and text encoders,
teacher-forced logits), and the flax -> torch weight converter.

Weights are made once by flax and carried across with
``chimera_st_tpu_torch.convert``; inputs come from numpy with a fixed seed.
Tolerance 1e-4 (fp32 through ~10 chained layers) unless stated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.torch_import import import_interlingua_state_dict
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu.models.wav2vec2 import DEFAULT_CONV_SPEC
from chimera_st_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxW2V2
from chimera_st_tpu_torch.convert import params_from_flax, wav2vec2_params_from_flax
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel, InterlinguaConfig
from chimera_st_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder
from tests.test_interlingua_model import TINY

TOL = dict(atol=1e-4, rtol=1e-4)


def port_config(jax_cfg) -> InterlinguaConfig:
    known = {f.name for f in dataclasses.fields(InterlinguaConfig)}
    return InterlinguaConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items()
                                if k in known})


def flax_init(cfg, seed: int = 0):
    model = JaxModel(cfg)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 400)), jnp.zeros((2, 400), bool),
        jnp.zeros((2, 4), jnp.int32), jnp.zeros((2, 5), jnp.int32),
        method=JaxModel.init_everything,
    )
    return model, params


def numpy_tree(params):
    """The flax tree with numpy leaves, as the converter takes it."""
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(cfg, params) -> ChimeraInterlinguaModel:
    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu")
    model.load_state_dict(params_from_flax(numpy_tree(params)), strict=True)
    return model.eval()


def padded_audio(seed: int, batch: int = 2, samples: int = 4000):
    rng = np.random.default_rng(seed)
    wav = rng.normal(size=(batch, samples)).astype(np.float32)
    mask = np.zeros((batch, samples), bool)
    mask[1, int(samples * 0.6):] = True
    return wav, mask


@pytest.fixture(scope="module")
def tiny():
    jm, params = flax_init(TINY)
    return jm, params, port_model(TINY, params)


def test_wav2vec2_trunk_matches_jax():
    """Default extractor spec (so the port runs its conv tail through K2's
    plain version) and a 2-layer narrow transformer, ~4000 samples."""
    jm = JaxW2V2(encoder_embed_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=2,
                 conv_spec=DEFAULT_CONV_SPEC, conv_pos=16, conv_pos_groups=4)
    wav, mask = padded_audio(1, samples=4000)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask))
    ref, ref_mask = jm.apply(params, jnp.asarray(wav), jnp.asarray(mask))
    model = Wav2Vec2Encoder(32, 64, 2, 2, DEFAULT_CONV_SPEC, conv_pos=16, conv_pos_groups=4,
                            device="cpu")
    model.load_state_dict(wav2vec2_params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    assert model.feature_extractor.kernel_tail
    with torch.no_grad():
        got, got_mask = model(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_encode_audio_and_teacher_forced_logits_match_jax(tiny):
    jm, params, model = tiny
    wav, mask = padded_audio(0)
    mem_j, mask_j = jm.apply(params, jnp.asarray(wav), jnp.asarray(mask),
                             method=JaxModel.encode_audio)
    prev = np.array([[2, 5, 6, 7, 1], [2, 8, 9, 1, 1]], np.int32)
    logits_j = jm.apply(params, jnp.asarray(prev), mem_j, mask_j, method=JaxModel.decode)
    with torch.no_grad():
        mem, mem_mask = model.encode_audio(torch.from_numpy(wav), torch.from_numpy(mask))
        logits = model.decode(torch.from_numpy(prev).long(), mem, mem_mask)
    assert mem_mask is None and mask_j is None
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_j), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


def test_encode_text_matches_jax(tiny):
    jm, params, model = tiny
    toks = np.array([[4, 5, 6, 2], [7, 8, 2, 1]], np.int32)
    ref, _ = jm.apply(params, jnp.asarray(toks), method=JaxModel.encode_text)
    with torch.no_grad():
        got, _ = model.encode_text(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", [
    dict(interlingua_mask_padding=True),
    dict(modal_embedding=True),
    dict(no_interlingua=True),
])
def test_encoder_variants_match_jax(variant):
    """The masked-interlingua fix, the modality embedding added to the
    memory slots, and the plain w2v2 + transformer model without a memory
    bank."""
    cfg = dataclasses.replace(TINY, **variant)
    jm, params = flax_init(cfg, seed=2)
    model = port_model(cfg, params)
    wav, mask = padded_audio(3)
    ref, ref_mask = jm.apply(params, jnp.asarray(wav), jnp.asarray(mask),
                             method=JaxModel.encode_audio)
    with torch.no_grad():
        got, got_mask = model.encode_audio(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if ref_mask is None:
        assert got_mask is None
    else:
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_audio_exclusive_layers_replace_the_first_shared_layers(tiny):
    """``non_shared_encoder_layers = 1``: on the audio path the audio-only
    layer stands in for shared layer 0. The JAX package's audio path fails
    on this setting (it adds a list to a tuple), so the reference is the JAX
    model whose shared layer 0 holds the audio-only layer's weights."""
    jm, params, _ = tiny
    cfg = dataclasses.replace(TINY, non_shared_encoder_layers=1)
    rng = np.random.default_rng(4)
    exclusive = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.1,
        params["params"]["transformer_layers_0"])
    swapped = numpy_tree(params)
    swapped["params"]["transformer_layers_0"] = exclusive
    wav, mask = padded_audio(5)
    ref, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, swapped), jnp.asarray(wav),
                      jnp.asarray(mask), method=JaxModel.encode_audio)
    with_exclusive = numpy_tree(params)
    with_exclusive["params"]["audio_exclusive_layers_0"] = exclusive
    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu")
    model.load_state_dict(params_from_flax(with_exclusive), strict=True)
    with torch.no_grad():
        got, _ = model.eval().encode_audio(torch.from_numpy(wav), torch.from_numpy(mask))
        text, _ = model.encode_text(torch.tensor([[4, 5, 6, 2]]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the text path keeps the shared layer 0
    text_ref, _ = jm.apply(params, jnp.asarray([[4, 5, 6, 2]]), method=JaxModel.encode_text)
    np.testing.assert_allclose(text.numpy(), np.asarray(text_ref), **TOL)


def test_converter_round_trips_every_leaf(tiny):
    """flax tree -> port state dict (fairseq names) -> the JAX package's own
    fairseq importer -> the same flax tree, leaf for leaf (exact)."""
    _, params, _ = tiny
    params = numpy_tree(params)
    sd = params_from_flax(params)
    fairseq = {k: v.numpy() for k, v in sd.items()}
    # the importer reads the trunk's positional conv as a weight-normed conv:
    # g = ||w|| over dims (0, 1), v = w folds back to w exactly
    key = "encoder.wav2vec_model.encoder.pos_conv.0"
    w = fairseq.pop(f"{key}.weight")
    fairseq[f"{key}.weight_v"] = w
    fairseq[f"{key}.weight_g"] = np.sqrt((w * w).sum(axis=(0, 1), keepdims=True))
    back = import_interlingua_state_dict(fairseq)
    flat = dict(jax.tree_util.tree_flatten_with_path(params["params"])[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(str, flat)) == set(map(str, flat_back))
    back_by_name = {str(k): v for k, v in flat_back.items()}
    for path, leaf in flat.items():
        np.testing.assert_allclose(np.asarray(back_by_name[str(path)]), leaf,
                                   rtol=1e-6, atol=1e-7, err_msg=str(path))


def test_converter_rejects_missing_and_extra_keys(tiny):
    _, params, model = tiny
    params = numpy_tree(params)
    missing = numpy_tree(params)
    del missing["params"]["decoder"]["layers_0"]["fc1"]["kernel"]
    with pytest.raises(KeyError, match="decoder/layers_0/fc1/kernel"):
        params_from_flax(missing)
    extra = numpy_tree(params)
    extra["params"]["decoder"]["mystery_projection"] = {"kernel": np.zeros((16, 20), np.float32)}
    with pytest.raises(ValueError, match="unconsumed flax parameters"):
        params_from_flax(extra)
    # an untied decoder's output projection is a module of the table
    untied = numpy_tree(params)
    untied["params"]["decoder"]["output_projection"] = {"kernel": np.ones((16, 20), np.float32)}
    assert params_from_flax(untied)["decoder.output_projection.weight"].shape == (20, 16)
    # every state-dict entry of the port's model is produced, nothing else
    assert set(params_from_flax(params)) == set(model.state_dict())
