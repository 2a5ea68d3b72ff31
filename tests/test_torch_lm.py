"""The port's language model and what serves it against the JAX package on
the CPU: ``TransformerLM``'s causal logits, shallow fusion in
``EnsembleSequenceGenerator`` (one MT model, two, and the flagship through
``generate_audio``), the ``eval_lm`` CLI against the JAX CLI on the same
binarized data and JAX-written checkpoint, the language-modeling data
(``TokenBlockDataset``, ``MonolingualDataset``, ``ShortenedDataset``),
``--lm-path`` in the generate CLI, and the rows that refuse: an LM saved
under a preset name (the JAX CLI's arch override), ``interactive
--lm-path``.

Widths: 2 layers, 32 wide, 4 heads; weights are seeded numpy draws over a
flax init's tree (``tests/test_torch_transformer.py`` ``seeded_tree``).
Tolerances: fp32 1e-5; tokens identical; the CLI's printed loss identical
to its 4 decimals."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import save_state as jax_save_state
from chimera_st_tpu.cli import eval_lm as jax_eval_lm
from chimera_st_tpu.cli.generate import load_model_and_params as jax_load
from chimera_st_tpu.data.token_block_dataset import TokenBlockDataset as JaxBlocks
from chimera_st_tpu.generation.ensemble import EnsembleSequenceGenerator as JaxEnsemble
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu.tasks import language_modeling as jax_lm_task
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.cli import eval_lm, generate, interactive, preprocess
from chimera_st_tpu_torch.data.token_block_dataset import TokenBlockDataset
from chimera_st_tpu_torch.generation.ensemble import EnsembleSequenceGenerator
from chimera_st_tpu_torch.generation.generator import GeneratorSettings
from chimera_st_tpu_torch.models import transformer_mt
from chimera_st_tpu_torch.tasks import language_modeling as lm_task
from chimera_st_tpu_torch.tasks import setup_task
from tests.test_interlingua_model import TINY
from tests.test_torch_models import flax_init, port_model
from tests.test_torch_transformer import PREV, SRC, jax_mt_model, port_mt_model, seeded_tree

TOL = dict(atol=1e-5, rtol=1e-5)
LM_WIDTHS = dict(embed_dim=32, ffn_dim=64, layers=2, heads=4)


def jax_lm(vocab: int, seed: int = 1, **cfg):
    model = jax_mt.TransformerLM(jax_mt.TransformerLMConfig(vocab_size=vocab, **LM_WIDTHS,
                                                            **cfg))
    tokens = jnp.asarray(PREV % vocab)
    return model, seeded_tree(model.init(jax.random.PRNGKey(0), tokens), seed)


def port_lm(jax_model, params):
    model = transformer_mt.build_transformer_lm(dataclasses.asdict(jax_model.cfg), device="cpu")
    model.load_state_dict(convert.params_from_flax(params, "transformer_lm"), strict=True)
    return model.eval()


@pytest.mark.parametrize("activation, pre_norm", [("relu", True), ("gelu", False)])
def test_lm_causal_logits_match_jax(activation, pre_norm):
    jm, params = jax_lm(29, activation=activation, normalize_before=pre_norm)
    model = port_lm(jm, params)
    tokens = np.array([[2, 7, 9, 4, 5, 11], [2, 11, 3, 1, 1, 1]], np.int32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jm.apply(jparams, jnp.asarray(tokens))
    want_features = jm.apply(jparams, jnp.asarray(tokens), method=lambda m, t: m.decoder(
        t, None, None, features_only=True))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
        features = model.decoder(torch.from_numpy(tokens).long(), None, features_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(features.numpy(), np.asarray(want_features), **TOL)
    # no cross-attention modules, as the flax tree has none
    assert not any("encoder_attn" in k for k in model.state_dict())


def _assert_same(got, want):
    tokens, scores, lens = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[2].numpy(), lens)
    np.testing.assert_array_equal(got[0].numpy(), tokens)
    np.testing.assert_allclose(got[1].numpy(), scores, **TOL)


@pytest.mark.parametrize("members", [1, 2])
def test_lm_fusion_on_mt_matches_jax(members):
    """``EnsembleSequenceGenerator(lm=...)`` over one or two MT models, text
    input, against the JAX ensemble with the same LM; the fused search is
    not the search without the LM."""
    models = [jax_mt_model("sinusoid_post_norm", seed=3),
              jax_mt_model("learned_pos_pre_norm_untied", seed=4)][:members]
    lm, lm_params = jax_lm(29, seed=5)
    common = dict(beam_size=3, max_decode_len=10, min_len=2, len_penalty=1.2, max_len_a=1.0,
                  max_len_b=2, temperature=0.9)
    lengths = np.array([7, 3, 6])
    want = JaxEnsemble([m for m, _ in models],
                       [jax.tree_util.tree_map(jnp.asarray, p) for _, p in models],
                       JaxSettings(**common),
                       lm=(lm, jax.tree_util.tree_map(jnp.asarray, lm_params), 0.3)
                       ).generate_text(jnp.asarray(SRC), jnp.asarray(lengths))
    port = [port_mt_model(m, p) for m, p in models]
    fused = EnsembleSequenceGenerator(port, GeneratorSettings(**common),
                                      lm=(port_lm(lm, lm_params), 0.3))
    got = fused.generate_text(torch.from_numpy(SRC).long(), torch.from_numpy(lengths))
    _assert_same(got, want)
    alone = EnsembleSequenceGenerator(port, GeneratorSettings(**common)).generate_text(
        torch.from_numpy(SRC).long(), torch.from_numpy(lengths))
    assert not torch.equal(alone[1], got[1])


def test_lm_fusion_on_the_flagship_matches_jax():
    """The flagship (tiny interlingua model) through ``generate_audio`` with
    an LM over its target vocabulary."""
    _, base = flax_init(TINY, seed=1)
    params = jax.tree_util.tree_map(np.asarray, base)
    lm, lm_params = jax_lm(TINY.tgt_vocab_size, seed=6, activation="gelu")
    rng = np.random.default_rng(9)
    wav = rng.normal(size=(2, 4000)).astype(np.float32)
    mask = np.zeros((2, 4000), bool)
    mask[1, 2700:] = True
    common = dict(beam_size=3, max_decode_len=10, min_len=2)
    want = JaxEnsemble([JaxModel(TINY)], [jax.tree_util.tree_map(jnp.asarray, params)],
                       JaxSettings(**common),
                       lm=(lm, jax.tree_util.tree_map(jnp.asarray, lm_params), 0.5)
                       ).generate_audio(jnp.asarray(wav), jnp.asarray(mask))
    got = EnsembleSequenceGenerator([port_model(TINY, params)], GeneratorSettings(**common),
                                    lm=(port_lm(lm, lm_params), 0.5)).generate_audio(
        torch.from_numpy(wav), torch.from_numpy(mask))
    _assert_same(got, want)


@pytest.mark.parametrize("mode", ["none", "eos", "complete"])
def test_token_blocks_and_monolingual_pairs_match_jax(mode):
    rng = np.random.default_rng(2)
    docs = [rng.integers(4, 40, size=int(n)).astype(np.int32) for n in rng.integers(1, 14, 25)]
    sizes = np.array([len(d) for d in docs])
    ours = TokenBlockDataset(docs, sizes, 16, break_mode=mode)
    ref = JaxBlocks(docs, sizes, 16, break_mode=mode)
    assert len(ours) == len(ref) and np.array_equal(ours.sizes, ref.sizes)
    pairs = lm_task.MonolingualDataset(ours, 1, 2)
    ref_pairs = jax_lm_task.MonolingualDataset(ref, 1, 2)
    for i in range(len(ours)):
        a, b = pairs[i], ref_pairs[i]
        assert np.array_equal(a["source"], b["source"]) and np.array_equal(a["target"],
                                                                         b["target"])
    idx = list(range(min(5, len(ours))))
    a = pairs.collater([pairs[i] for i in idx], 16)
    b = ref_pairs.collater([ref_pairs[i] for i in idx], 16)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("method", ["truncate", "random_crop"])
def test_shortened_documents_match_jax(method):
    rng = np.random.default_rng(3)
    docs = [rng.integers(4, 40, size=int(n)).astype(np.int32) for n in rng.integers(1, 30, 12)]

    class Docs(list):
        sizes = np.array([len(d) for d in docs])

    base = Docs(docs)
    ours, ref = (cls(base, 10, method, seed=7)
                 for cls in (lm_task.ShortenedDataset, jax_lm_task.ShortenedDataset))
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert all(np.array_equal(ours[i], ref[i]) for i in range(len(docs)))
    assert np.array_equal(ours.sizes, ref.sizes)


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    """A binarized monolingual corpus (the port's preprocess --only-source)
    over 25 words and a JAX-written LM checkpoint on its dictionary (model_cfg
    ``transformer_lm`` with explicit widths)."""
    root = tmp_path_factory.mktemp("lm")
    rng = np.random.default_rng(11)
    for split, n in (("train", 20), ("test", 30)):
        rows = [" ".join(f"w{i}" for i in rng.zipf(1.5, size=int(rng.integers(3, 15))) % 25)
                for _ in range(n)]
        (root / f"{split}.txt").write_text("\n".join(rows) + "\n")
    preprocess.main(["--only-source", "--trainpref", str(root / "train.txt"), "--testpref",
                     str(root / "test.txt"), "--destdir", str(root / "bin")])
    vocab = len(lm_task.LanguageModelingTask.load_dictionary(str(root / "bin" / "dict.txt")))
    jm, params = jax_lm(vocab, seed=8, activation="gelu", normalize_before=True)
    ckpt = root / "lm.ckpt"
    jax_save_state(str(ckpt), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": {"arch": "transformer_lm", "activation": "gelu", **LM_WIDTHS}},
                   save_optimizer=False)
    return dict(bin=root / "bin", ckpt=ckpt, jax=jm, params=params, vocab=vocab)


@pytest.mark.parametrize("context", [0, 4])
def test_eval_lm_prints_the_jax_cli_loss(lm_data, context, capsys):
    argv = [str(lm_data["bin"]), "--path", str(lm_data["ckpt"]), "--tokens-per-sample", "12",
            "--context-window", str(context), "--batch-size", "4", "--dtype", "float32"]
    jax_eval_lm.main(argv)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    stats = eval_lm.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith(f"Evaluated {stats['tokens']} tokens: loss ")
    assert stats["tokens"] > 100 and np.isfinite(stats["loss_bits"])


def test_generate_lm_path_decodes_the_fused_search(lm_data, tmp_path, capsys):
    """``--lm-path LM.ckpt --lm-weight 0.4`` on an MT model whose target
    dictionary is the LM's: the CLI's hypotheses are the fused ensemble's."""
    from tests.test_torch_transformer import SMALL

    bin_dir = lm_data["bin"]
    data = tmp_path / "mt"
    data.mkdir()
    rng = np.random.default_rng(4)
    raw = tmp_path / "raw"
    raw.mkdir()
    for lang in ("en", "de"):
        (raw / f"test.{lang}").write_text("\n".join(
            " ".join(f"w{i}" for i in rng.integers(0, 20, int(rng.integers(2, 7))))
            for _ in range(5)) + "\n")
    preprocess.main(["-s", "en", "-t", "de", "--srcdict", str(bin_dir / "dict.txt"),
                     "--tgtdict", str(bin_dir / "dict.txt"), "--testpref", str(raw / "test"),
                     "--destdir", str(data)])
    vocab = lm_data["vocab"]
    cfg = dict(SMALL, src_vocab_size=vocab, tgt_vocab_size=vocab)
    jm = jax_mt.TransformerModel(jax_mt.TransformerMTConfig(**cfg))
    params = seeded_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(SRC % vocab),
                                 jnp.asarray(PREV % vocab)), 3)
    ckpt = tmp_path / "mt.ckpt"
    model_cfg = {"arch": "transformer", **{k: v for k, v in SMALL.items()
                                           if not k.endswith("vocab_size")}}
    jax_save_state(str(ckpt), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": model_cfg}, save_optimizer=False)
    argv = [str(data), "--task", "translation", "-s", "en", "-t", "de", "--path", str(ckpt),
            "--gen-subset", "test", "--beam", "3", "--max-decode-len", "10", "--device", "cpu",
            "--dtype", "float32", "--scoring", "bleu", "--batch-size", "5"]
    generate.main(argv + ["--lm-path", str(lm_data["ckpt"]), "--lm-weight", "0.4"])
    hyps = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("H-")]
    task = setup_task({"_name": "translation", "data": str(data), "source_lang": "en",
                       "target_lang": "de"})
    batch = next(iter(task.make_batch_iterator(task.dataset("test"), max_sentences=5)
                      .next_epoch_itr(shuffle=False)))
    lm = generate.load_language_model(str(lm_data["ckpt"]), task, torch.float32, "cpu")
    fused = EnsembleSequenceGenerator(
        [generate.load_model_and_params(str(ckpt), task, torch.float32, "cpu")],
        GeneratorSettings(beam_size=3, max_decode_len=10), lm=(lm, 0.4))
    tokens, scores, lens = fused.generate_text(torch.from_numpy(batch["src_tokens"]).long(),
                                               torch.from_numpy(batch["src_lengths"]))
    want = {f"H-{int(i)}\t{float(scores[b, 0]):.4f}\t"
            + task.target_dictionary.string(tokens[b, 0, :int(lens[b, 0])])
            for b, i in enumerate(batch["id"])}
    assert set(hyps) == want


def test_lm_saved_under_a_preset_keeps_its_architecture(lm_data, tmp_path):
    """An LM saved as ``transformer_lm_gpt`` with its widths given and its
    activation left to the preset (gelu). The JAX CLI replaces the arch with
    ``transformer_lm`` and rebuilds it with ReLU: a different function
    (ROADMAP C). The port keeps the saved preset, so its LM computes what
    the JAX model built from the saved config computes."""
    task = setup_task({"_name": "language_modeling", "data": str(lm_data["bin"])})
    jax_task = jax_setup_task({"_name": "language_modeling", "data": str(lm_data["bin"])})
    saved = {"arch": "transformer_lm_gpt", **LM_WIDTHS}
    jm = jax_task.build_model(dict(saved))
    assert jm.cfg.activation == "gelu" and jm.cfg.embed_dim == 32
    params = seeded_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(PREV)), 2)
    ckpt = tmp_path / "gpt.ckpt"
    jax_save_state(str(ckpt), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": saved}, save_optimizer=False)
    tokens = np.array([[2, 7, 9, 4, 5, 11]], np.int32)
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens)))
    jax_model, jax_params = jax_load(str(ckpt), jax_task, jnp.float32, {"arch": "transformer_lm"})
    assert jax_model.cfg.activation == "relu"
    overridden = np.asarray(jax_model.apply(jax_params, jnp.asarray(tokens)))
    assert np.abs(overridden - want).max() > 1e-3
    lm = generate.load_language_model(str(ckpt), task, torch.float32, "cpu")
    assert lm.cfg.activation == "gelu"
    with torch.no_grad():
        got = lm(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # a checkpoint of another model is no language model
    with pytest.raises(ValueError, match="not a transformer_lm"):
        mt_ckpt = tmp_path / "mt.ckpt"
        jax_save_state(str(mt_ckpt), SimpleNamespace(step=0, params=params, opt_state=None),
                       {"model_cfg": {"arch": "transformer"}}, save_optimizer=False)
        generate.load_language_model(str(mt_ckpt), task, torch.float32, "cpu")


def test_interactive_refuses_lm_path(lm_data):
    with pytest.raises(ValueError, match="--lm-path"):
        interactive.main([str(lm_data["bin"]), "--task", "language_modeling",
                          "--path", str(lm_data["ckpt"]), "--lm-path", str(lm_data["ckpt"]),
                          "--device", "cpu"])
