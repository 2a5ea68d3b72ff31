"""Checkpoint loading of the PyTorch port against the JAX package's, on the
CPU: a fairseq-layout state dict of ``tests/torch_reference.TorchChimera``
goes through both importers and must give the same teacher-forced logits and
memory bank (fp32, 1e-5: the same weights through ~10 chained layers of two
frameworks) on numpy-seeded inputs; ``infer_interlingua_config`` flat and
nested; the loud completeness check; and a native ``.ckpt`` written by the JAX
package read with ``jax`` blocked."""

import dataclasses
import pickle
import subprocess
import sys
from argparse import Namespace
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint import torch_import as jax_import
from chimera_st_tpu.checkpoint.store import save_state
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxW2V2
from chimera_st_tpu_torch.checkpoint import store, torch_import
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel
from chimera_st_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder
from tests.test_interlingua_model import TINY
from tests.test_torch_models import flax_init, port_config
from tests.torch_reference import TorchChimera

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)


def fairseq_state_dict(cfg, seed=0):
    torch.manual_seed(seed)
    tref = TorchChimera(cfg).eval()
    sd = dict(tref.state_dict())
    # what a real fine-tune checkpoint carries besides the model
    sd["encoder.wav2vec_model.mask_emb"] = torch.rand(cfg.w2v2_embed_dim)
    sd["encoder.wav2vec_model.final_proj.weight"] = torch.rand(4, cfg.w2v2_embed_dim)
    sd["encoder.wav2vec_model.final_proj.bias"] = torch.rand(4)
    sd["encoder.wav2vec_model.quantizer.vars"] = torch.rand(1, 4, 2)
    sd["encoder.wav2vec_model.project_q.weight"] = torch.rand(4, 4)
    sd["encoder.embed_positions._float_tensor"] = torch.zeros(1)
    sd["decoder.embed_positions._float_tensor"] = torch.zeros(1)
    sd["decoder.output_projection.weight"] = sd["decoder.embed_tokens.weight"]
    sd["decoder.version"] = torch.tensor([3.0])
    return tref, sd


@pytest.fixture(scope="module")
def imported():
    tref, sd = fairseq_state_dict(TINY)
    model = ChimeraInterlinguaModel(port_config(TINY), device="cpu")
    model.load_state_dict(torch_import.import_interlingua_state_dict(sd), strict=True)
    params = {"params": jax_import.import_interlingua_state_dict(sd)}
    return tref, sd, model.eval(), params


def test_audio_logits_match_jax_importer(imported):
    tref, _, model, params = imported
    rng = np.random.default_rng(0)
    wav = rng.normal(size=(2, 400)).astype(np.float32)
    mask = np.zeros((2, 400), bool)
    mask[1, 250:] = True
    prev = np.array([[2, 4, 5, 6], [2, 7, 8, 1]], np.int64)
    ref_logits, ref_mem = JaxModel(TINY).apply(
        params, jnp.asarray(wav), jnp.asarray(mask), jnp.asarray(prev, jnp.int32),
        method=JaxModel.forward_audio_with_internal)
    with torch.inference_mode():
        mem, _ = model.encode_audio(torch.from_numpy(wav), torch.from_numpy(mask))
        logits = model(torch.from_numpy(wav), torch.from_numpy(mask), torch.from_numpy(prev))
        tref_logits, _ = tref.forward_audio(torch.from_numpy(wav), torch.from_numpy(mask),
                                            torch.from_numpy(prev))
    np.testing.assert_allclose(mem.numpy(), np.asarray(ref_mem), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    # and the model the state dict came from (its own fp32 order of operations)
    np.testing.assert_allclose(logits.numpy(), tref_logits.numpy(), atol=1e-4, rtol=1e-4)


def test_text_logits_match_jax_importer(imported):
    _, _, model, params = imported
    src = np.array([[4, 5, 6, 7, 2], [8, 9, 2, 1, 1]], np.int64)
    prev = np.array([[2, 4, 5], [2, 6, 1]], np.int64)
    ref_logits, ref_mem = JaxModel(TINY).apply(
        params, jnp.asarray(src, jnp.int32), jnp.asarray(prev, jnp.int32),
        method=JaxModel.forward_text_with_internal)
    with torch.inference_mode():
        mem, mem_mask = model.encode_text(torch.from_numpy(src))
        logits = model.decode(torch.from_numpy(prev), mem, mem_mask)
    np.testing.assert_allclose(mem.numpy(), np.asarray(ref_mem), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)


def test_weight_norm_fold_matches_jax(imported):
    _, sd, model, _ = imported
    key = "encoder.wav2vec_model.encoder.pos_conv.0"
    w, b = torch_import._fold_weight_norm(sd, key)
    assert torch.equal(model.state_dict()[key + ".weight"], w)
    ref_w, ref_b = jax_import._fold_weight_norm(sd, key)
    np.testing.assert_allclose(w.numpy(), ref_w, atol=1e-7)
    np.testing.assert_array_equal(b.numpy(), ref_b)
    # g = 2 ||v|| doubles the weight, whatever the scale of v
    doubled = dict(sd)
    doubled[key + ".weight_g"] = 2 * sd[key + ".weight_v"].pow(2).sum((0, 1), keepdim=True).sqrt()
    doubled[key + ".weight_v"] = 7.0 * sd[key + ".weight_v"]
    w2, _ = torch_import._fold_weight_norm(doubled, key)
    np.testing.assert_allclose(w2.numpy(), 2 * sd[key + ".weight_v"].numpy(), rtol=1e-6)


def test_wav2vec2_importer_matches_jax(imported):
    _, sd, _, _ = imported
    prefix = "encoder.wav2vec_model."
    w2v_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    stripped = torch_import.strip_w2v2_pretraining_keys(w2v_sd)
    assert sorted(stripped) == sorted(jax_import.strip_w2v2_pretraining_keys(w2v_sd))
    assert "mask_emb" not in stripped and "final_proj.weight" not in stripped
    out = torch_import.import_wav2vec2_state_dict(sd, prefix=prefix)
    c = TINY
    trunk = Wav2Vec2Encoder(c.w2v2_embed_dim, c.w2v2_ffn_dim, c.w2v2_layers, c.w2v2_heads,
                            c.w2v2_conv_spec, c.w2v2_conv_bias, c.w2v2_conv_pos,
                            c.w2v2_conv_pos_groups, device="cpu")
    trunk.load_state_dict(out, strict=True)
    rng = np.random.default_rng(1)
    wav = rng.normal(size=(2, 600)).astype(np.float32)
    mask = np.zeros((2, 600), bool)
    mask[0, 420:] = True
    ref_params = {"params": jax_import.import_wav2vec2_state_dict(stripped)}
    ref, ref_mask = JaxW2V2(
        encoder_embed_dim=c.w2v2_embed_dim, encoder_ffn_dim=c.w2v2_ffn_dim,
        encoder_layers=c.w2v2_layers, encoder_heads=c.w2v2_heads, conv_spec=c.w2v2_conv_spec,
        conv_pos=c.w2v2_conv_pos, conv_pos_groups=c.w2v2_conv_pos_groups,
    ).apply(ref_params, jnp.asarray(wav), jnp.asarray(mask))
    with torch.inference_mode():
        got, got_mask = trunk.eval()(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    keep = ~np.asarray(ref_mask)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(ref)[keep], **TOL)
    # keep_mask_emb reads the fine-tune span-masking embedding, as JAX does
    kept = torch_import.import_wav2vec2_state_dict(sd, prefix=prefix, keep_mask_emb=True)
    ref_kept = jax_import.import_wav2vec2_state_dict(sd, prefix=prefix, keep_mask_emb=True)
    np.testing.assert_array_equal(kept["mask_emb"].numpy(), np.asarray(ref_kept["mask_emb"]))
    assert sorted(set(kept) - set(out)) == ["mask_emb"]


def test_unknown_key_raises(imported):
    _, sd, _, _ = imported
    bad = dict(sd)
    bad["encoder.mystery_module.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unmatched.*mystery_module"):
        torch_import.import_interlingua_state_dict(bad)
    # a stray key under the trunk that is no pretraining head is no documented drop
    bad = dict(sd)
    bad["encoder.wav2vec_model.adapter.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unmatched"):
        torch_import.import_interlingua_state_dict(bad)
    with pytest.raises(ValueError, match="unmatched"):
        jax_import.import_interlingua_state_dict(bad)


def test_missing_tensor_raises_on_load(imported):
    _, sd, _, _ = imported
    short = {k: v for k, v in sd.items() if not k.startswith("decoder.layers.1.fc2")}
    with pytest.raises(KeyError, match="decoder.layers.1.fc2.weight"):
        torch_import.import_interlingua_state_dict(short)
    # and a tensor the importer does not look for by name fails the strict load
    short = {k: v for k, v in sd.items() if not k.startswith("encoder.layer_norm")}
    model = ChimeraInterlinguaModel(port_config(TINY), device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(torch_import.import_interlingua_state_dict(short), strict=True)


UNTIED = dataclasses.replace(TINY, share_decoder_input_output_embed=False)


def test_output_projection_of_its_own_raises(imported):
    """Once a refusal, now the untied flagship: a ``.pt`` whose
    ``decoder.output_projection`` is a tensor of its own loads into a model
    built with ``share_decoder_input_output_embed=False`` and gives the JAX
    package's log-probabilities (1e-5) and beam tokens; the same weights
    through the JAX ``.ckpt`` tree load too."""
    from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
    from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
    from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator

    _, sd, _, _ = imported
    untied = dict(sd)
    rng = np.random.default_rng(3)
    untied["decoder.output_projection.weight"] = torch.from_numpy(
        4.0 * rng.normal(size=tuple(sd["decoder.embed_tokens.weight"].shape)).astype(np.float32))
    port_sd = torch_import.import_interlingua_state_dict(untied)
    assert torch.equal(port_sd["decoder.output_projection.weight"],
                       untied["decoder.output_projection.weight"])
    model = ChimeraInterlinguaModel(port_config(UNTIED), device="cpu")
    model.load_state_dict(port_sd, strict=True)
    model.eval()
    params = {"params": jax_import.import_interlingua_state_dict(untied)}
    assert "output_projection" in params["params"]["decoder"]
    # the JAX .ckpt tree of the same model carries across to the same weights
    from_ckpt = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(from_ckpt) == sorted(port_sd)
    assert torch.equal(from_ckpt["decoder.output_projection.weight"],
                       port_sd["decoder.output_projection.weight"])

    wav = rng.normal(size=(2, 4000)).astype(np.float32)
    mask = np.zeros((2, 4000), bool)
    mask[1, 2600:] = True
    prev = np.array([[2, 4, 5, 6], [2, 7, 8, 1]], np.int64)
    ref_logits, _ = JaxModel(UNTIED).apply(
        params, jnp.asarray(wav), jnp.asarray(mask), jnp.asarray(prev, jnp.int32),
        method=JaxModel.forward_audio_with_internal)
    with torch.inference_mode():
        logits = model(torch.from_numpy(wav), torch.from_numpy(mask), torch.from_numpy(prev))
    np.testing.assert_allclose(torch.log_softmax(logits, -1).numpy(),
                               np.asarray(jax.nn.log_softmax(ref_logits, -1)), **TOL)
    common = dict(beam_size=2, max_decode_len=8, min_len=2)
    ref = JaxGenerator(JaxModel(UNTIED), JaxSettings(**common)).generate_audio(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(wav), jnp.asarray(mask))
    tokens, scores, lens = SequenceGenerator(model, GeneratorSettings(**common)).generate_audio(
        torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref[1]), atol=1e-4, rtol=1e-4)


def test_audio_exclusive_layers_are_consumed():
    cfg = dataclasses.replace(TINY, non_shared_encoder_layers=1)
    _, sd = fairseq_state_dict(TINY, seed=1)
    for k in list(sd):
        if k.startswith("encoder.transformer_layers.0."):
            sd[k.replace("transformer_layers.0.", "audio_exclusive_layers.0.")] = sd[k] * 1.5
    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu")
    model.load_state_dict(torch_import.import_interlingua_state_dict(sd), strict=True)
    assert torch.equal(model.encoder.audio_exclusive_layers[0].fc1.weight,
                       1.5 * model.encoder.transformer_layers[0].fc1.weight)


FLAT = Namespace(
    encoder_embed_dim=32, encoder_ffn_embed_dim=48, encoder_layers=3, encoder_attention_heads=4,
    decoder_embed_dim=32, decoder_ffn_embed_dim=40, decoder_layers=2, decoder_attention_heads=2,
    interlingua_length=64, interlingua_layers=1, conv_kernel_sizes="5,3", conv_channels=24,
    activation_fn="gelu", no_scale_embedding=True, non_shared_encoder_layers=1,
    w2v2_embed_dim=48, w2v2_ffn_dim=96, w2v2_layers=2, w2v2_heads=4,
    w2v2_conv_spec=[[16, 10, 5], [24, 3, 2]], w2v2_conv_pos=16, w2v2_conv_pos_groups=4,
    max_target_positions=128,
)
W2V = Namespace(encoder_embed_dim=48, encoder_ffn_embed_dim=96, encoder_layers=2,
                encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
                conv_feature_layers="[(16, 10, 5), (24, 3, 2)]")
CONFIG_CASES = {
    "flat": FLAT,
    "nested": Namespace(encoder_embed_dim=32, encoder_layers=2, interlingua_length=8,
                        w2v_args=W2V),
    "flat_wins_over_nested": Namespace(encoder_embed_dim=32, w2v2_heads=2, w2v_args=W2V),
    "defaults": Namespace(),
    "released_w2v_args_defaults": Namespace(w2v_args=Namespace()),
    "dropout_rates": Namespace(dropout=0.3, attention_dropout=0.2, activation_dropout=0.05),
    "plain_w2v2_arch": Namespace(arch="s2t_transformer_w2v2_s", encoder_embed_dim=256,
                                 encoder_attention_heads=4, decoder_attention_heads=4),
    "untied_output_projection": Namespace(share_decoder_input_output_embed=False),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_infer_interlingua_config_matches_jax(case):
    ns = CONFIG_CASES[case]
    got = torch_import.infer_interlingua_config(ns, tgt_vocab=100, src_vocab=90)
    ref = jax_import.infer_interlingua_config(ns, tgt_vocab=100, src_vocab=90)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(ref, field.name), field.name
    if case == "released_w2v_args_defaults":
        assert got.w2v2_heads == 12 and got.w2v2_embed_dim == 768
    if case == "flat_wins_over_nested":
        assert got.w2v2_heads == 2 and got.w2v2_embed_dim == 48
    if case == "dropout_rates":
        assert (got.dropout, got.attention_dropout, got.activation_dropout) == (0.3, 0.2, 0.05)
    if case == "plain_w2v2_arch":
        # neither importer reads args.arch: the memory bank stays on (ROADMAP C)
        assert got.no_interlingua is False
    no_text = torch_import.infer_interlingua_config(ns, tgt_vocab=100, src_vocab=None)
    assert no_text.src_vocab_size is None


def test_conv_feature_layers_expression_of_the_released_checkpoint():
    """``wav2vec_small.pt`` stores the extractor's layers as the expression
    fairseq evals; the port evaluates list sums and repeats of literals only."""
    ns = Namespace(w2v_args=Namespace(
        conv_feature_layers="[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512,2,2)] * 2"))
    cfg = torch_import.infer_interlingua_config(ns, tgt_vocab=10, src_vocab=10)
    assert cfg.w2v2_conv_spec == ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2
    for bad in ("__import__('os').getcwd()", "[(1, 2, 3)] - [(1, 2, 3)]", "[1] * [2]"):
        with pytest.raises((ValueError, TypeError)):
            torch_import._parse_conv_feature_layers(bad)


def test_untied_output_embedding_in_args_raises():
    """Once a refusal: ``share_decoder_input_output_embed=False`` in a
    checkpoint's args now reaches the config, as in JAX, and the model it
    builds has an output projection of its own."""
    ns = Namespace(share_decoder_input_output_embed=False, encoder_embed_dim=32)
    got = torch_import.infer_interlingua_config(ns, tgt_vocab=10, src_vocab=10)
    ref = jax_import.infer_interlingua_config(ns, tgt_vocab=10, src_vocab=10)
    assert got.share_decoder_input_output_embed is False
    assert ref.share_decoder_input_output_embed is False
    tied = torch_import.infer_interlingua_config(Namespace(), tgt_vocab=10, src_vocab=10)
    assert tied.share_decoder_input_output_embed is True


def test_load_torch_checkpoint_reads_a_namespace(tmp_path, imported):
    _, sd, _, _ = imported
    path = str(tmp_path / "ckpt.pt")
    torch.save({"model": sd, "args": CONFIG_CASES["nested"], "optimizer_history": [{"x": 1}]}, path)
    ckpt = torch_import.load_torch_checkpoint(path)
    assert ckpt["args"].w2v_args.encoder_attention_heads == 4
    assert sorted(ckpt["model"]) == sorted(sd)
    ref = jax_import.load_torch_checkpoint(path)
    assert vars(ref["args"].w2v_args) == vars(ckpt["args"].w2v_args)


def test_native_checkpoint_read_with_jax_blocked(tmp_path):
    """A ``.ckpt`` the JAX package wrote is unpickled, carried across and run
    in a process where ``jax``, ``flax`` and the JAX package cannot be
    imported; its logits equal the JAX model's on the same weights."""
    _, params = flax_init(TINY, seed=3)
    path = str(tmp_path / "native.ckpt")
    model_cfg = {"arch": "s2t_transformer_w2v2_interlingua_base", "interlingua_length": 4}
    save_state(path, SimpleNamespace(step=7, params=params, opt_state={"mu": params}),
               {"model_cfg": model_cfg, "epoch": 2})
    tree, cfg = store.load_native_checkpoint(path)
    assert cfg == model_cfg
    model = ChimeraInterlinguaModel(port_config(TINY), device="cpu")
    model.load_state_dict(params_from_flax(tree), strict=True)

    rng = np.random.default_rng(2)
    wav = rng.normal(size=(2, 400)).astype(np.float32)
    mask = np.zeros((2, 400), bool)
    prev = np.array([[2, 4, 5, 6], [2, 7, 8, 1]], np.int64)
    np.savez(tmp_path / "inputs.npz", wav=wav, mask=mask, prev=prev)
    ref_logits, _ = JaxModel(TINY).apply(
        params, jnp.asarray(wav), jnp.asarray(mask), jnp.asarray(prev, jnp.int32),
        method=JaxModel.forward_audio_with_internal)
    probe = f"""
import sys
for name in ("jax", "jaxlib", "flax", "chimera_st_tpu"):
    sys.modules[name] = None
import numpy as np, torch
from chimera_st_tpu_torch.checkpoint.store import load_native_checkpoint
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel, InterlinguaConfig
tree, cfg = load_native_checkpoint(sys.argv[1])
model = ChimeraInterlinguaModel(InterlinguaConfig(**{dataclasses.asdict(port_config(TINY))!r}),
                                device="cpu").eval()
model.load_state_dict(params_from_flax(tree), strict=True)
x = np.load(sys.argv[2])
with torch.inference_mode():
    logits = model(torch.from_numpy(x["wav"]), torch.from_numpy(x["mask"]),
                   torch.from_numpy(x["prev"]))
np.save(sys.argv[3], logits.numpy())
"""
    proc = subprocess.run([sys.executable, "-c", probe, path, str(tmp_path / "inputs.npz"),
                           str(tmp_path / "logits.npy")], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(np.load(tmp_path / "logits.npy"), np.asarray(ref_logits), **TOL)
    with open(tmp_path / "other.ckpt", "wb") as f:
        pickle.dump({"model": {}}, f)
    with pytest.raises(ValueError, match="not a native checkpoint"):
        store.load_native_checkpoint(str(tmp_path / "other.ckpt"))
