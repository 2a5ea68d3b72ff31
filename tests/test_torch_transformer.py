"""The port's Transformer family (``models/transformer_mt.py``) against the
JAX package on the CPU: the MT ``TransformerModel`` forward and
``encode_text`` (sinusoidal or learned positions, with or without
``layernorm_embedding``, pre- and post-norm, tied or untied output),
``SequenceGenerator.generate_text`` on it, the 23 presets, the converter
both ways, the fields the port refuses, the generate CLI on a JAX-written
``transformer`` checkpoint under ``--task translation`` (generate and
interactive), and K1's and K3's
plain versions at head dim 128 (the MT presets of 512 / 4 heads).

Weights: a flax init's tree with every leaf replaced by seeded numpy draws
(large enough that beam search meets no near-ties), carried across by
``convert.py``. Widths: 2 + 2 layers, 32 wide, 4 heads. Tolerances: fp32
1e-5 (absolute and relative); tokens and lengths identical."""

import dataclasses
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import save_state as jax_save_state
from chimera_st_tpu.config.registry import ARCHITECTURES as JAX_ARCHITECTURES
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.ops.attention import dot_product_attention as jax_attention
from chimera_st_tpu.ops.pallas_decode_attention import decode_step_attention
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.cli import generate
from chimera_st_tpu_torch.config.registry import ARCHITECTURES
from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
from chimera_st_tpu_torch.models import transformer_mt
from chimera_st_tpu_torch.ops import decode_attention, encoder_attention

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(src_vocab_size=23, tgt_vocab_size=29, encoder_embed_dim=32, encoder_ffn_dim=64,
             encoder_layers=2, encoder_heads=4, decoder_embed_dim=32, decoder_ffn_dim=64,
             decoder_layers=2, decoder_heads=4, dropout=0.0)
VARIANTS = {
    "sinusoid_post_norm": dict(),
    "learned_pos_ln_embedding_post_norm": dict(learned_pos=True, layernorm_embedding=True),
    "sinusoid_pre_norm": dict(encoder_normalize_before=True, decoder_normalize_before=True),
    "learned_pos_pre_norm_untied": dict(learned_pos=True, layernorm_embedding=True,
                                        encoder_normalize_before=True,
                                        decoder_normalize_before=True,
                                        share_decoder_input_output_embed=False),
}
SRC = np.array([[4, 5, 6, 7, 8, 9, 2, 1], [10, 11, 2, 1, 1, 1, 1, 1],
                [12, 13, 14, 15, 16, 2, 1, 1]], np.int32)
PREV = np.array([[2, 7, 9, 4, 5], [2, 11, 1, 1, 1], [2, 6, 6, 8, 1]], np.int32)


def seeded_tree(tree, seed: int):
    """The flax tree with every leaf drawn from numpy: kernels N(0, 1.5^2 /
    fan_in), embeddings N(0, 0.5^2), norm scales 1 + N(0, 0.1^2), biases
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = np.shape(x)
        if name.endswith("['kernel']"):
            v = rng.normal(size=shape) * 1.5 / np.sqrt(shape[0])
        elif name.endswith("['embedding']"):
            v = rng.normal(size=shape) * 0.5
        elif name.endswith("['scale']"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def jax_mt_model(variant, seed=0):
    cfg = jax_mt.TransformerMTConfig(**SMALL, **VARIANTS[variant])
    model = jax_mt.TransformerModel(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(SRC), jnp.asarray(PREV))
    return model, seeded_tree(params, seed)


def port_mt_model(jax_model, params):
    model = transformer_mt.build_transformer(dataclasses.asdict(jax_model.cfg), device="cpu")
    model.load_state_dict(convert.params_from_flax(params, "transformer"), strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def mt(request):
    jm, params = jax_mt_model(request.param)
    return request.param, jm, params, port_mt_model(jm, params)


def test_forward_and_encode_text_match_jax(mt):
    _, jm, params, model = mt
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jm.apply(jparams, jnp.asarray(SRC), jnp.asarray(PREV))
    enc_want, mask_want = jm.apply(jparams, jnp.asarray(SRC), method=type(jm).encode_text)
    with torch.no_grad():
        got = model(torch.from_numpy(SRC).long(), torch.from_numpy(PREV).long())
        enc, mask = model.encode_text(torch.from_numpy(SRC).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_want), **TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_want))
    # the variant's modules exist on both sides, and only there
    names = set(model.state_dict())
    v = jm.cfg
    assert ("encoder.embed_positions.weight" in names) == v.learned_pos
    assert ("decoder.layernorm_embedding.weight" in names) == v.layernorm_embedding
    assert ("decoder.output_projection.weight" in names) == \
        (not v.share_decoder_input_output_embed)


@pytest.mark.parametrize("variant", ["sinusoid_post_norm", "learned_pos_pre_norm_untied"])
def test_generate_text_matches_jax(variant):
    jm, params = jax_mt_model(variant, seed=3)
    common = dict(beam_size=3, max_decode_len=10, min_len=2, len_penalty=1.2,
                  max_len_a=1.0, max_len_b=2)
    lengths = np.array([7, 3, 6])
    ref = JaxGenerator(jm, JaxSettings(**common)).generate_text(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(SRC), jnp.asarray(lengths))
    got = SequenceGenerator(port_mt_model(jm, params), GeneratorSettings(**common)).generate_text(
        torch.from_numpy(SRC).long(), torch.from_numpy(lengths))
    tokens, scores, lens = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(got[2].numpy(), lens)
    np.testing.assert_array_equal(got[0].numpy(), tokens)
    np.testing.assert_allclose(got[1].numpy(), scores, **TOL)


FAMILY = sorted(transformer_mt.ARCHITECTURES)


@pytest.mark.parametrize("arch", FAMILY)
def test_preset_matches_jax(arch):
    """Each of the 23 architecture names: the same model name and the same
    defaults, over a config that sets some fields itself."""
    jax_model, jax_preset = JAX_ARCHITECTURES.get(arch)
    model, preset = ARCHITECTURES.get(arch)
    assert model == jax_model
    given = {"dropout": 0.25, "arch": arch}
    assert preset(dict(given)) == jax_preset(dict(given))
    assert preset({}) == jax_preset({})
    assert len(FAMILY) == 23


def test_round_trip_bit_for_bit_and_unknown_leaf_raises():
    """Both models to flax and back, every tensor bit for bit; a leaf no rule
    takes raises, as does a module missing a required leaf."""
    jm, params = jax_mt_model("learned_pos_pre_norm_untied")
    lm = jax_mt.TransformerLM(jax_mt.TransformerLMConfig(vocab_size=29, embed_dim=32, ffn_dim=64,
                                                         layers=2, heads=4))
    lm_params = seeded_tree(lm.init(jax.random.PRNGKey(0), jnp.asarray(PREV)), 1)
    for kind, tree in (("transformer", params), ("transformer_lm", lm_params)):
        state = convert.params_from_flax(tree, kind)
        back = convert.params_to_flax(state, kind)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            assert np.array_equal(np.asarray(leaf), flat_b[path]), path
        again = convert.params_from_flax(back, kind)
        assert all(torch.equal(state[k], again[k]) for k in state) and state.keys() == again.keys()
    # the LM tree has no cross-attention, so the MT table's decoder layers
    # would need it and the LM table refuses one
    bad = jax.tree_util.tree_map(np.asarray, lm_params)
    bad["params"]["decoder"]["layers_0"]["encoder_attn"] = params["params"]["decoder"][
        "layers_0"]["encoder_attn"]
    with pytest.raises(ValueError, match="unconsumed flax parameters"):
        convert.params_from_flax(bad, "transformer_lm")
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["params"]["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unconsumed flax parameters"):
        convert.params_from_flax(bad, "transformer")
    bad = jax.tree_util.tree_map(np.asarray, params)
    del bad["params"]["layers_0"]["fc1"]["bias"]
    with pytest.raises(KeyError, match="missing layers_0/fc1/bias"):
        convert.params_from_flax(bad, "transformer")


@pytest.mark.parametrize("field, value, item", [
    ("pipeline_stages", 2, "A12"),
])
def test_unported_field_raises(field, value, item):
    """Once a refusal naming A12: ``pipeline_stages`` 2 now puts the
    encoder's and decoder's stacks (the LM's) on the GPipe schedule of a
    grid with 2 pipe ranks, with the JAX builders' checks: a grid whose
    ``pipe`` axis is the stage count, no dropout, layers that divide (the
    schedule itself runs in ``tests/test_torch_parallel.py``)."""
    grid = SimpleNamespace(shape={"data": 1, "pipe": value})
    cfg = {field: value, "encoder_embed_dim": 32, "decoder_embed_dim": 32, "embed_dim": 32,
           "encoder_layers": 2, "decoder_layers": 2, "layers": 2, "dropout": 0.0,
           "attention_dropout": 0.0, "activation_dropout": 0.0, "pipeline_chunks": 4}
    model = transformer_mt.build_transformer({**cfg, "pipeline_mesh": grid}, device="cpu")
    assert model.encoder.pipeline == model.decoder.pipeline == {
        "mesh": grid, "stages": 2, "chunks": 4, "remat": False}
    lm = transformer_mt.build_transformer_lm({**cfg, "pipeline_mesh": grid}, device="cpu")
    assert lm.decoder.pipeline["stages"] == 2
    with pytest.raises(ValueError, match="`pipe` axis"):
        transformer_mt.build_transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="without dropout"):
        transformer_mt.build_transformer({**cfg, "dropout": 0.1, "pipeline_mesh": grid},
                                         device="cpu")
    with pytest.raises(ValueError, match="divide"):
        transformer_mt.build_transformer_lm({**cfg, "layers": 3, "pipeline_mesh": grid},
                                            device="cpu")


def test_share_all_embeddings_is_not_honoured_in_either_package():
    """``share_all_embeddings`` is declared by the JAX config and read by
    nothing: its flax tree keeps a source and a target table, and so does
    the port (ROADMAP C)."""
    cfg = jax_mt.TransformerMTConfig(**dict(SMALL, tgt_vocab_size=23),
                                     share_all_embeddings=True)
    tree = jax_mt.TransformerModel(cfg).init(jax.random.PRNGKey(0), jnp.asarray(SRC),
                                             jnp.asarray(PREV))["params"]
    assert "embed_tokens" in tree and "embed_tokens" in tree["decoder"]
    model = transformer_mt.build_transformer(dataclasses.asdict(cfg), device="cpu")
    sd = model.state_dict()
    assert "encoder.embed_tokens.weight" in sd and "decoder.embed_tokens.weight" in sd
    assert sd["encoder.embed_tokens.weight"].data_ptr() != sd["decoder.embed_tokens.weight"] \
        .data_ptr()


@pytest.mark.parametrize("T", [40, 65])
def test_encoder_attention_plain_at_head_dim_128_matches_jax(T):
    rng = np.random.default_rng(T)
    q, k, v = (rng.normal(size=(2, T, 4, 128)).astype(np.float32) for _ in range(3))
    mask = np.zeros((2, T), bool)
    mask[1, T // 2:] = True
    got = encoder_attention.encoder_attention(*map(torch.from_numpy, (q, k, v)),
                                              torch.from_numpy(mask)).numpy()
    want = jax_attention(*map(jnp.asarray, (q, k, v)), key_padding_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert 128 in encoder_attention.HEAD_DIMS


@pytest.mark.parametrize("step", [0, 5, 11])
def test_decode_attention_plain_at_head_dim_128_matches_pallas(step):
    """decode_attention_plain at D 128 vs the Pallas kernel in interpret
    mode on a random ancestry; the JAX cache holds this step's rows, which
    the plain version writes."""
    rng = np.random.default_rng(step)
    B, C, H, D, L = 2, 3, 2, 128, 12
    N = B * C
    q, k_new, v_new = (rng.normal(size=(N, H, D)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.normal(size=(N, H, L, D)).astype(np.float32) for _ in range(2))
    anc = rng.integers(0, C, size=(L + 1, N)).astype(np.int32)
    k_cache, v_cache = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = decode_attention.decode_attention(
        *map(torch.from_numpy, (q, k_new, v_new)), k_cache, v_cache, torch.from_numpy(anc),
        step, C).numpy()
    kc[:, :, step], vc[:, :, step] = k_new, v_new
    np.testing.assert_array_equal(k_cache.numpy(), kc)

    def pallas_layout(c):  # [N, H, L, D] -> [B, H, C*L, D], row c*L + l
        return jnp.asarray(c.reshape(B, C, H, L, D).transpose(0, 2, 1, 3, 4)
                           .reshape(B, H, C * L, D))

    want = decode_step_attention(jnp.asarray(q.reshape(B, C, H, D)), pallas_layout(kc),
                                 pallas_layout(vc), jnp.asarray(anc[:L]), jnp.asarray(step),
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(want).reshape(N, H, D), **TOL)
    assert 128 in decode_attention.HEAD_DIMS


def _write_translation_dir(root):
    """Binarized en -> de test split (the port's preprocess) over joined
    dictionaries of 23 / 29 symbols."""
    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(5)
    raw = root / "raw"
    raw.mkdir(parents=True)
    for lang, n_words in (("en", 19), ("de", 25)):
        (root / f"dict.{lang}.txt").write_text("".join(f"{lang}{i} 1\n" for i in range(n_words)))
        rows = [" ".join(f"{lang}{i}" for i in rng.integers(0, n_words, int(rng.integers(2, 7))))
                for _ in range(6)]
        (raw / f"test.{lang}").write_text("\n".join(rows) + "\n")
    preprocess.main(["-s", "en", "-t", "de", "--srcdict", str(root / "dict.en.txt"),
                     "--tgtdict", str(root / "dict.de.txt"), "--testpref", str(raw / "test"),
                     "--destdir", str(root / "bin")])
    return root / "bin"


def test_generate_cli_serves_a_jax_written_transformer_checkpoint(tmp_path, capsys):
    """A ``.ckpt`` written by the JAX store (model_cfg ``transformer`` with
    the widths given) decodes through ``cli.generate --task translation`` on
    the CPU to the hypotheses of the port's generator, whose tokens the JAX
    generator's equal (test_generate_text_matches_jax)."""
    data = _write_translation_dir(tmp_path)
    jm, params = jax_mt_model("sinusoid_post_norm", seed=3)
    model_cfg = {"arch": "transformer", **{k: v for k, v in SMALL.items()
                                           if not k.endswith("vocab_size")}}
    ckpt = tmp_path / "mt.ckpt"
    jax_save_state(str(ckpt), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": model_cfg}, save_optimizer=False)
    stats = generate.main([str(data), "--task", "translation", "-s", "en", "-t", "de",
                           "--path", str(ckpt),
                           "--gen-subset", "test", "--beam", "3", "--max-decode-len", "10",
                           "--batch-size", "3", "--device", "cpu", "--dtype", "float32",
                           "--scoring", "bleu"])
    out = capsys.readouterr().out
    assert stats["sentences"] == 6
    with open(ckpt, "rb") as f:
        assert pickle.load(f)["extra"]["model_cfg"]["arch"] == "transformer"
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "translation", "data": str(data), "source_lang": "en",
                       "target_lang": "de"})
    model = generate.load_model_and_params(str(ckpt), task, torch.float32, "cpu")
    assert isinstance(model, transformer_mt.TransformerModel)
    assert model.cfg.src_vocab_size == len(task.source_dictionary) == 23
    gen = SequenceGenerator(model, GeneratorSettings(beam_size=3, max_decode_len=10))
    ds = task.dataset("test")
    hyps = {}
    for line in out.splitlines():
        if line.startswith("H-"):
            head, _, hyp = line.split("\t")
            hyps[int(head[2:])] = hyp
    for i in range(len(ds)):
        src = torch.from_numpy(np.array(ds[i]["source"])[None]).long()
        tokens, _, lens = gen.generate_text(src, torch.tensor([src.shape[1]]))
        assert hyps[i] == task.target_dictionary.string(tokens[0, 0, :int(lens[0, 0])])
    # the interactive CLI on the raw source sentences prints the same
    from chimera_st_tpu_torch.cli import interactive

    interactive.main([str(data), "--task", "translation", "-s", "en", "-t", "de", "--path",
                      str(ckpt), "--beam", "3", "--max-decode-len", "10", "--device", "cpu",
                      "--dtype", "float32", "--input", str(tmp_path / "raw" / "test.en"),
                      "--buffer-size", "3"])
    lines = [ln.split("\t")[2] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("H-")]
    assert lines == [hyps[i] for i in range(len(ds))]


def test_validate_keeps_a_transformer_checkpoints_stored_arch(tmp_path, capsys):
    """``cli.validate`` on a ``transformer`` ``.ckpt`` without ``--arch``
    rebuilds the stored arch and gives the loss of the JAX validate CLI
    under ``--arch transformer`` (which fails without the flag: it replaces
    the stored arch with ``--arch``'s default)."""
    from chimera_st_tpu.cli import validate as jax_validate
    from chimera_st_tpu_torch.cli import validate

    data = _write_translation_dir(tmp_path)
    _, params = jax_mt_model("sinusoid_post_norm", seed=4)
    model_cfg = {"arch": "transformer", **{k: v for k, v in SMALL.items()
                                           if not k.endswith("vocab_size")}}
    ckpt = tmp_path / "mt.ckpt"
    jax_save_state(str(ckpt), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": model_cfg}, save_optimizer=False)
    common = [str(data), "--task", "translation", "-s", "en", "-t", "de", "--path", str(ckpt),
              "--valid-subset", "test", "--batch-size", "3", "--dtype", "float32",
              "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1"]
    got = validate.main(common + ["--device", "cpu"])
    capsys.readouterr()
    jax_validate.main(common + ["--arch", "transformer"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = dict((k, float(v)) for k, v in (kv.split() for kv in line.split(" | ")))
    assert set(got) == set(want) == {"loss", "nll_loss"}
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
