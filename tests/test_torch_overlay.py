"""The Chimera overlay's own modules that run on ported parts, against the
JAX package on the CPU: the plain w2v2 + Transformer ST model
``s2t_transformer_w2v2`` and its five presets (registry, forward, beam
search, a JAX-written ``.ckpt`` through the generate CLI, the train and
validate CLIs), the ``translation_tts`` task's batches and the
``speech_to_text_bleu`` task's BLEU count buckets.

Widths: a 2-layer trunk and 2 + 2 encoder / decoder layers, 16 wide, on
the synthetic triplet data of ``tests/synthetic_data.py``. Weights: a flax
init with the decoder's kernels x4 (``sharpen``), carried across by
``convert``. Tolerances: logits 1e-4 (fp32 through ~10 chained layers, as
``tests/test_torch_models.py``); tokens, lengths, batches and BLEU counts
identical; beam scores to the generate CLI's printed precision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chimera_st_tpu.models  # noqa: F401 — registration
from chimera_st_tpu.cli import generate as jax_generate
from chimera_st_tpu.config.registry import ARCHITECTURES as JAX_ARCHITECTURES
from chimera_st_tpu.config.registry import MODELS as JAX_MODELS
from chimera_st_tpu.data.audio import write_wav
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch import models
from chimera_st_tpu_torch.cli import generate, preprocess, train, validate
from chimera_st_tpu_torch.config.registry import ARCHITECTURES, MODELS
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.data.dictionary import Dictionary
from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
from chimera_st_tpu_torch.models.interlingua import InterlinguaConfig
from chimera_st_tpu_torch.tasks import setup_task
from tests.synthetic_data import make_parallel_text, make_triplet_dir
from tests.test_torch_cli import assert_same_output, run_generate, sharpen, write_native
from tests.test_torch_models import numpy_tree, padded_audio

TOL = dict(atol=1e-4, rtol=1e-4)
PRESETS = ("s2t_transformer_w2v2", "s2t_transformer_w2v2_s", "s2t_transformer_w2v2_sp",
           "s2t_transformer_w2v2yr_s", "s2t_transformer_w2v2asr_s")
W2V2_TINY = dict(
    encoder_embed_dim=16, encoder_ffn_dim=32, encoder_layers=2, encoder_heads=2,
    decoder_heads=2, decoder_layers=2, conv_channels=8, w2v2_embed_dim=16, w2v2_ffn_dim=32,
    w2v2_layers=2, w2v2_heads=2, w2v2_conv_spec=((8, 10, 5), (12, 3, 2)), w2v2_conv_pos=8,
    w2v2_conv_pos_groups=4, max_target_positions=64)


def jax_build(arch, cfg):
    model_name, preset = JAX_ARCHITECTURES.get(arch)
    jm = JAX_MODELS.get(model_name)(preset(dict(cfg)))
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((2, 400)), jnp.zeros((2, 400), bool),
                     jnp.zeros((2, 4), jnp.int32), jnp.zeros((2, 5), jnp.int32),
                     method=JaxModel.init_everything)
    return jm, numpy_tree(sharpen(params))


def port_build(arch, cfg, params):
    model_name, preset = ARCHITECTURES.get(arch)
    model = MODELS.get(model_name)(preset(dict(cfg)), device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("arch", PRESETS)
def test_plain_w2v2_presets_resolve_to_the_jax_config(arch):
    """Each preset and the model ``s2t_transformer_w2v2`` resolve in both
    registries, to the same config: the interlingua model's without its
    memory bank."""
    assert "s2t_transformer_w2v2" in MODELS and "s2t_transformer_w2v2" in JAX_MODELS
    assert ARCHITECTURES.get(arch)[0] == JAX_ARCHITECTURES.get(arch)[0] == "s2t_transformer_w2v2"
    cfg = {"tgt_vocab_size": 40, "src_vocab_size": 30}
    want = JAX_MODELS.get("s2t_transformer_w2v2")(JAX_ARCHITECTURES.get(arch)[1](cfg)).cfg
    got = models._known(InterlinguaConfig, {**ARCHITECTURES.get(arch)[1](cfg),
                                            "no_interlingua": True})
    got = InterlinguaConfig(**got)
    assert got.no_interlingua and want.no_interlingua
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    small = arch != "s2t_transformer_w2v2"
    assert (got.encoder_embed_dim, got.encoder_heads) == ((256, 4) if small else (512, 8))
    assert got.encoder_layers == (16 if arch.endswith("_sp") else 12)


def test_plain_w2v2_forward_and_beam_tokens_match_jax():
    """``s2t_transformer_w2v2_s`` at small widths: encoder states and their
    padding mask, teacher-forced logits, and every beam of a beam-3 search
    (tokens and lengths identical, scores 1e-4)."""
    cfg = {**W2V2_TINY, "tgt_vocab_size": 20, "src_vocab_size": 16}
    jm, params = jax_build("s2t_transformer_w2v2_s", cfg)
    assert "interlingua_layers_0" not in params["params"]
    model = port_build("s2t_transformer_w2v2_s", cfg, params)
    wav, mask = padded_audio(4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    enc_j, mask_j = jm.apply(jparams, jnp.asarray(wav), jnp.asarray(mask),
                             method=JaxModel.encode_audio)
    prev = np.array([[2, 5, 6, 7, 1], [2, 8, 9, 1, 1]], np.int32)
    logits_j = jm.apply(jparams, jnp.asarray(prev), enc_j, mask_j, method=JaxModel.decode)
    with torch.no_grad():
        enc, enc_mask = model.encode_audio(torch.from_numpy(wav), torch.from_numpy(mask))
        logits = model.decode(torch.from_numpy(prev).long(), enc, enc_mask)
    np.testing.assert_array_equal(enc_mask.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)

    common = dict(beam_size=3, max_decode_len=16, min_len=2)
    ref = JaxGenerator(jm, JaxSettings(**common)).generate_audio(
        jparams, jnp.asarray(wav), jnp.asarray(mask))
    tokens, scores, lens = SequenceGenerator(model, GeneratorSettings(**common)).generate_audio(
        torch.from_numpy(wav), torch.from_numpy(mask))
    ref_tokens, ref_scores, ref_lens = map(np.asarray, ref)
    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(scores.numpy(), ref_scores, **TOL)
    assert len({tuple(t) for t in tokens.numpy().reshape(-1, 16)}) > 2


@pytest.fixture(scope="module")
def triplet(tmp_path_factory):
    """The synthetic triplet data and a JAX-written ``.ckpt`` of
    ``s2t_transformer_w2v2_s`` at small widths on its dictionary."""
    root = tmp_path_factory.mktemp("w2v2")
    make_triplet_dir(str(root), n=8, seed=3)
    vocab = len(Dictionary.load(str(root / "dict.txt")))
    cfg = {**W2V2_TINY, "tgt_vocab_size": vocab, "src_vocab_size": vocab}
    _, params = jax_build("s2t_transformer_w2v2_s", cfg)
    write_native(root / "w2v2.ckpt", params, {"arch": "s2t_transformer_w2v2_s", **W2V2_TINY})
    return root


def test_jax_written_plain_w2v2_ckpt_decodes_identically_through_generate(triplet, tmp_path):
    """The JAX generate CLI and the port's on the same native checkpoint:
    the same S-/T-/H-/D-/P- lines and score line."""
    extra = ["--batch-size", "4", "--num-length-buckets", "1", "--nbest", "2"]
    want = run_generate(jax_generate, triplet, triplet / "w2v2.ckpt", extra, tmp_path / "jax",
                        False)
    got = run_generate(generate, triplet, triplet / "w2v2.ckpt", extra, tmp_path / "port", True)
    assert_same_output(got, want, n_ids=8, nbest=2)


def test_plain_w2v2_trains_and_validates_from_the_command_line(triplet, tmp_path):
    """``cli.train --arch s2t_transformer_w2v2_s`` takes an update on the
    triplet data (label-smoothed CE on audio), saves a checkpoint of the
    model without a memory bank, and ``cli.validate`` rebuilds it from its
    stored arch."""
    flags = [x for k, v in W2V2_TINY.items() if k != "w2v2_conv_spec"
             for x in (f"--{k.replace('_', '-')}", str(v))]
    train.main([str(triplet), "--task", "triplet", "--arch", "s2t_transformer_w2v2_s", *flags,
                "--w2v2-conv-spec", str(W2V2_TINY["w2v2_conv_spec"]), "--criterion",
                "label_smoothed_cross_entropy", "--label-smoothing", "0.1", "--lr", "1e-3",
                "--batch-size", "4", "--max-update", "1", "--dtype", "float32",
                "--save-dir", str(tmp_path), "--disable-validation", "--device", "cpu"])
    stats = validate.main([str(triplet), "--task", "triplet", "--path",
                           str(tmp_path / "checkpoint_last.ckpt"), "--valid-subset", "valid",
                           "--criterion", "label_smoothed_cross_entropy", "--batch-size", "4",
                           "--dtype", "float32", "--device", "cpu"])
    assert set(stats) == {"loss", "nll_loss"} and np.isfinite(stats["loss"])


def _tts_data(root, wav_indices):
    raw = make_parallel_text(str(root / "raw"), n=8)
    preprocess.main(["-s", "de", "-t", "en", "--trainpref", f"{raw}/train",
                     "--destdir", str(root / "bin"), "--joined-dictionary"])
    audio = root / "tts"
    audio.mkdir()
    rng = np.random.default_rng(0)
    for i in wav_indices:
        write_wav(str(audio / f"{i}.wav"),
                  rng.normal(size=int(rng.integers(500, 2900))).astype(np.float32) * 0.1)
    return root / "bin", audio


@pytest.mark.parametrize("case", ["every_row", "rows_0_to_5", "no_audio_dir", "per_split"])
def test_translation_tts_batches_equal_the_jax_tasks(tmp_path, case):
    """An epoch of ``translation_tts`` batches, array for array: with a wav
    for every row (audio padded to a multiple of 1280, the triplet keys),
    with wavs for rows 0-5 only (a batch holding row 6 or 7 is text), with
    no audio directory, and with a per-split dict of directories."""
    data, audio = _tts_data(tmp_path, range(6) if case == "rows_0_to_5" else range(8))
    cfg = {"_name": "translation_tts", "data": str(data), "source_lang": "de",
           "target_lang": "en"}
    if case in ("every_row", "rows_0_to_5"):
        cfg["audio_dirname"] = str(audio)
    elif case == "per_split":
        cfg["audio_dirname"] = {"train": str(audio)}
    epochs = []
    for make in (setup_task, jax_setup_task):
        task = make(dict(cfg))
        task.load_dataset("train")
        epochs.append(list(task.make_batch_iterator(task.dataset("train"), max_sentences=3,
                                                    num_length_buckets=2)
                           .next_epoch_itr(shuffle=False)))
    got, want = epochs
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
    with_audio = ["audio" in b for b in got]
    if case == "no_audio_dir":
        assert not any(with_audio)
    elif case == "rows_0_to_5":
        assert any(with_audio) and not all(with_audio)
    else:
        assert all(with_audio)
    for b in got:
        if "audio" in b:
            assert b["audio"].shape[1] % 1280 == 0
            assert {"audio_padding_mask", "audio_lengths", "src_text",
                    "src_text_lengths"} <= set(b)


def test_speech_to_text_bleu_counts_match_jax(triplet):
    """``speech_to_text_bleu.valid_bleu_counts`` on one batch of 4 through
    the port's generator and through JAX's: the same count buckets, and
    ``bleu_from_counts`` the same score."""
    pytest.importorskip("sacrebleu")
    from chimera_st_tpu.tasks.speech_to_text import SpeechToTextBLEUTask as JaxBleuTask
    from chimera_st_tpu_torch.tasks.speech_to_text import SpeechToTextBLEUTask

    tasks = []
    for make in (setup_task, jax_setup_task):
        task = make({"_name": "speech_to_text_bleu", "data": str(triplet)})
        task.load_dataset("valid")
        tasks.append(task)
    port_task, jax_task = tasks
    assert isinstance(port_task, SpeechToTextBLEUTask)
    vocab = len(port_task.target_dictionary)
    cfg = {**W2V2_TINY, "tgt_vocab_size": vocab, "src_vocab_size": None}
    jm, params = jax_build("s2t_transformer_w2v2_s", {**cfg, "src_vocab_size": vocab})
    params = {"params": {k: v for k, v in params["params"].items()
                         if k != "text_embed_tokens"}}
    jm = JAX_MODELS.get("s2t_transformer_w2v2")(
        JAX_ARCHITECTURES.get("s2t_transformer_w2v2_s")[1](dict(cfg)))
    model = port_build("s2t_transformer_w2v2_s", cfg, params)

    class Cfg:
        beam = 3
        max_decode_len = 12

    batch = next(iter(port_task.make_batch_iterator(
        port_task.dataset("valid"), max_sentences=4, num_length_buckets=1)
        .next_epoch_itr(shuffle=False)))
    got = port_task.valid_bleu_counts(
        port_task.build_generator(model, Cfg),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
         if k in ("audio", "audio_padding_mask", "target")})
    jb = {k: (jnp.asarray(v) if hasattr(v, "shape") else v) for k, v in batch.items()}
    want = jax_task.valid_bleu_counts(jax_task.build_generator(jm, Cfg), params, jb,
                                      decode_fn=lambda s: s)
    assert got == want and got["_bleu_sys_len"] > 0
    assert SpeechToTextBLEUTask.bleu_from_counts(got) == JaxBleuTask.bleu_from_counts(want)
