"""The port's BART / mBART (``models/bart.py``) and multilingual
transformer (``models/multilingual_transformer.py``) against the JAX
package on the CPU: BART's forward, ``encode_text`` and ``classify``, its
incremental decode against its full forward, the seven presets, the
converter both ways (BART with its classification head, the multilingual
trees with and without sharing), ``cli.generate --task
translation_from_pretrained_bart`` on a JAX-written checkpoint against the
JAX CLI's output, the multilingual model that neither package serves, and
the registry names of the slice.

Weights: a flax init's tree with every leaf replaced by seeded numpy draws
(``tests/test_torch_transformer.py`` ``seeded_tree``), carried across by
``convert.py``. Widths: 2 + 2 layers, 32 wide, 4 heads. Tolerances: fp32
1e-5 (absolute and relative); tokens identical, printed scores within
2e-4 (four decimals).

``make_bart_data`` writes the binarized corpora of every task of the slice
(``tests/test_torch_bart_train.py`` reads them too).
"""

import json
import pickle
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chimera_st_tpu.criterions  # noqa: F401 — registration
import chimera_st_tpu.models  # noqa: F401
import chimera_st_tpu.tasks  # noqa: F401
from chimera_st_tpu.checkpoint.store import save_state as jax_save_state
from chimera_st_tpu.cli import generate as jax_generate
from chimera_st_tpu.config import registry as JR
from chimera_st_tpu.models import bart as jax_bart
from chimera_st_tpu.models import multilingual_transformer as jax_multi
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.cli import generate, validate
from chimera_st_tpu_torch.config import registry as R
from chimera_st_tpu_torch.data.indexed_dataset import MMapIndexedDatasetBuilder
from chimera_st_tpu_torch.generation.generator import lazy_reorder
from chimera_st_tpu_torch.models import bart, multilingual_transformer
from tests.test_torch_generate_surface import assert_same_lines
from tests.test_torch_transformer import seeded_tree

TOL = dict(atol=1e-5, rtol=1e-5)
WIDTHS = dict(encoder_embed_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=4,
              decoder_embed_dim=32, decoder_ffn_dim=64, decoder_layers=2, decoder_heads=4)
SMALL = dict(src_vocab_size=23, tgt_vocab_size=23, dropout=0.0, **WIDTHS)
SRC = np.array([[4, 5, 6, 7, 8, 9, 2, 1], [10, 11, 2, 1, 1, 1, 1, 1],
                [12, 13, 14, 15, 16, 2, 1, 1]], np.int32)
PREV = np.array([[2, 7, 9, 4, 5], [2, 11, 2, 1, 1], [2, 6, 6, 8, 1]], np.int32)
WORDS = [f"w{i}" for i in range(36)] + ["."]
MBART_LANGS = "en_XX,ro_RO,de_DE"


# ------------------------------------------------------------------ data

def _write_dict(path: Path, words=WORDS) -> None:
    path.write_text("".join(f"{w} {100 - i}\n" for i, w in enumerate(words)))


def _write_split(prefix: Path, rows) -> None:
    b = MMapIndexedDatasetBuilder(str(prefix))
    for row in rows:
        b.add_item(np.asarray(row, np.int32))
    b.finalize()


def _rows(rng, n, lo=3, hi=12, stops=False):
    """n binarized sentences of word ids (4 ...), eos last; with ``stops``
    a few full stops inside (the dictionary's last word)."""
    out = []
    for _ in range(n):
        row = rng.integers(4, 4 + len(WORDS) - 1, size=int(rng.integers(lo, hi + 1)))
        if stops:
            row[rng.random(len(row)) < 0.2] = 4 + len(WORDS) - 1
        out.append(np.concatenate([row, [2]]))
    return out


def make_bart_data(root: Path) -> dict:
    """Seeded binarized corpora over one 37-word vocabulary: ``mt``
    (en_XX-ro_RO, de-en and fr-en pairs, ``dict.{lang}.txt`` and
    ``dict.txt``),
    ``mono`` (denoising: ``train`` / ``valid``, and the subdirectories
    ``en_XX`` / ``ro_RO`` of multilingual denoising), ``glue``
    (sentence prediction: input0 + input1, text labels) and ``rank``
    (sentence ranking: a context and two candidates)."""
    rng = np.random.default_rng(0)
    mt, mono, glue, rank = (root / d for d in ("mt", "mono", "glue", "rank"))
    for d in (mt, mono / "en_XX", mono / "ro_RO", glue / "input0", glue / "input1",
              glue / "label", rank / "input0", rank / "input1", rank / "input2",
              rank / "label"):
        d.mkdir(parents=True)
    for lang in ("en_XX", "ro_RO", "en", "de", "fr"):
        _write_dict(mt / f"dict.{lang}.txt")
    _write_dict(mt / "dict.txt")
    for pair in ("en_XX-ro_RO", "de-en", "fr-en"):
        for split, n in (("train", 16 if pair != "fr-en" else 10), ("valid", 4), ("test", 6)):
            for lang in pair.split("-"):
                _write_split(mt / f"{split}.{pair}.{lang}", _rows(rng, n))
    _write_dict(mono / "dict.txt")
    for sub in ("", "en_XX", "ro_RO"):
        for split, n in (("train", 24 if sub != "ro_RO" else 12), ("valid", 4)):
            _write_split(mono / sub / split, _rows(rng, n, 4, 20, stops=True))
    for d, inputs in ((glue, 2), (rank, 3)):
        _write_dict(d / "input0" / "dict.txt")
        for split, n in (("train", 12), ("valid", 4)):
            for k in range(inputs):
                _write_split(d / f"input{k}" / split, _rows(rng, n, 2, 8))
            labels = (rng.choice(["entailment", "not_entailment"], n) if d is glue
                      else rng.integers(0, 2, n).astype(str))
            (d / "label" / f"{split}.label").write_text("\n".join(labels) + "\n")
    return dict(root=root, mt=mt, mono=mono, glue=glue, rank=rank)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_bart_data(tmp_path_factory.mktemp("bart"))


# ------------------------------------------------------------------ models

def jax_bart_model(arch, seed=0, **extra):
    cfg = JR.ARCHITECTURES.get(arch)[1]({**SMALL, **extra})
    jm = jax_bart.build_bart(cfg)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(SRC), jnp.asarray(PREV),
                                     method=jax_bart.BARTModel.init_everything))
    return jm, seeded_tree(init(jax.random.PRNGKey(0)), seed), cfg


def port_model(kind, build, cfg, params):
    model = build(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params, kind), strict=True)
    return model.eval()


@pytest.mark.parametrize("arch", ["bart_base", "mbart_base_wmt20"])
def test_bart_forward_encode_and_classify_match_jax(arch):
    """Forward logits, ``encode_text`` and ``classify`` (3 classes, row 1
    of PREV with two eos, row 2 with none) against JAX, fp32; the head and
    ``layernorm_embedding`` exist on both sides or neither."""
    jm, params, cfg = jax_bart_model(arch, num_classes=3)
    model = port_model("bart", bart.build_bart, cfg, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    src, prev = jnp.asarray(SRC), jnp.asarray(PREV)
    want = jm.apply(jp, src, prev)
    enc_want, mask_want = jm.apply(jp, src, method=jax_bart.BARTModel.encode_text)
    cls_want = jm.apply(jp, src, prev, method=jax_bart.BARTModel.classify)
    s, p = torch.from_numpy(SRC).long(), torch.from_numpy(PREV).long()
    with torch.no_grad():
        got = model(s, p)
        enc, mask = model.encode_text(s)
        cls = model.classify(s, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_want), **TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_want))
    assert cls.dtype == torch.float32 and cls.shape == (3, 3)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_want), **TOL)
    names = set(model.state_dict())
    assert "classification_out.weight" in names
    assert ("backbone.encoder.layernorm_embedding.weight" in names) == (arch == "bart_base")


def test_incremental_decode_equals_the_full_forward():
    """mbart_base's decoder stepped token by token through its caches (K3's
    plain version here) gives the teacher-forced forward's logits at each
    position."""
    jm, params, cfg = jax_bart_model("mbart_base", seed=2)
    model = port_model("bart", bart.build_bart, cfg, params)
    s, p = torch.from_numpy(SRC).long(), torch.from_numpy(PREV[:, :4].copy()).long()
    p[p == 1] = 5  # no pads inside a decoder prefix
    with torch.no_grad():
        full = model(s, p)
        enc, enc_mask = model.encode_text(s)
        dec = model.decoder
        B, L = p.shape
        caches = dec.init_cache(B, L)
        enc_kv = dec.precompute_encoder_kv(enc)
        anc, _ = lazy_reorder(B, 1, L, "cpu")
        steps = [dec.step(p[:, t:t + 1], t, caches, enc_kv, enc_mask, anc, 1)
                 for t in range(L)]
    np.testing.assert_allclose(torch.stack(steps, dim=1).numpy(), full.numpy(), **TOL)


PRESETS = sorted(bart.ARCHITECTURES) + sorted(multilingual_transformer.ARCHITECTURES)


@pytest.mark.parametrize("arch", PRESETS)
def test_preset_matches_jax(arch):
    """Each architecture name: the same model name and the same defaults,
    over a config that sets some fields itself."""
    model, preset = R.ARCHITECTURES.get(arch)
    jax_model, jax_preset = JR.ARCHITECTURES.get(arch)
    assert model == jax_model
    given = {"dropout": 0.25, "layernorm_embedding": False, "arch": arch}
    assert preset(dict(given)) == jax_preset(dict(given))
    assert preset({}) == jax_preset({})
    assert len(PRESETS) == 7


def _jax_multi(share, seed=1, vocab=23):
    cfg = jax_multi.multilingual_iwslt({**SMALL, "lang_pairs": "de-en,fr-en", "src_vocab_size": vocab,
                                        "tgt_vocab_size": vocab, **share})
    jm = jax_multi.build_multilingual(cfg)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(SRC), jnp.asarray(PREV),
                                     method=jax_multi.MultilingualTransformer.init_everything))
    return jm, seeded_tree(init(jax.random.PRNGKey(0)), seed), cfg


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", ["bart_head", "multi", "multi_share_encoders",
                                  "multi_share_decoders"])
def test_converter_round_trips_and_forward(case):
    """flax -> the port's state dict (every leaf, strict) -> flax, leaf for
    leaf; the parameter counts equal (the multilingual encoder groups hold
    no decoder), and the multilingual forward of each pair matches JAX."""
    if case == "bart_head":
        jm, params, cfg = jax_bart_model("bart_base", num_classes=2)
        kind, build = "bart", bart.build_bart
    else:
        share = {"multi": {}, "multi_share_encoders": {"share_encoders": True},
                 "multi_share_decoders": {"share_decoders": True}}[case]
        jm, params, cfg = _jax_multi(share)
        kind, build = "multilingual_transformer", multilingual_transformer.build_multilingual
    model = port_model(kind, build, cfg, params)
    assert convert.model_kind(model) == kind
    back = convert.params_to_flax(model.state_dict(), kind)
    want, got = _leaves(params), _leaves(back)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in want.values())
    if kind == "bart":
        return
    groups = {k.split("'")[3] for k in want}
    assert ("enc_shared" in groups) == (case == "multi_share_encoders")
    assert ("dec_shared" in groups) == (case == "multi_share_decoders")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for pair in ("de-en", "fr-en"):
        w = jm.apply(jp, jnp.asarray(SRC), jnp.asarray(PREV), pair=pair)
        with torch.no_grad():
            g = model(torch.from_numpy(SRC).long(), torch.from_numpy(PREV).long(), pair)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=pair)


def test_multilingual_decoders_take_the_jax_subset_of_the_config():
    """The decoders keep relu, sinusoidal positions, no
    ``layernorm_embedding`` and attention / activation dropout 0.1 whatever
    the config asks (fairseq passes the whole config; ROADMAP C), in both
    packages: the trees agree and hold no decoder embed_positions."""
    extra = {"activation": "gelu", "learned_pos": True, "layernorm_embedding": True,
             "attention_dropout": 0.0, "activation_dropout": 0.0}
    jm, params, cfg = _jax_multi(extra)
    model = port_model("multilingual_transformer", multilingual_transformer.build_multilingual,
                       {**cfg, **extra}, params)
    dec = model.decoders["en"]
    layer = dec.layers[0]
    assert layer.self_attn.dropout == 0.1 and layer.activation_dropout == 0.1
    assert not hasattr(dec, "embed_positions") and not hasattr(dec, "layernorm_embedding")
    assert hasattr(model.encoders["de"], "embed_positions")
    assert not any(k.startswith("['params']['dec_en']['embed_positions']")
                   for k in _leaves(params))


# ------------------------------------------------------------------ serving

def _mbart_checkpoint(data, path: Path):
    """A JAX-written ``.ckpt`` of ``mbart_base`` at the small widths over
    the en-ro dictionaries with their language tags and ``<mask>``."""
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "translation_from_pretrained_bart", "data": str(data["mt"]),
                       "source_lang": "en_XX", "target_lang": "ro_RO", "langs": MBART_LANGS})
    n = len(task.target_dictionary)
    jm, params, _ = jax_bart_model("mbart_base", seed=5, src_vocab_size=n, tgt_vocab_size=n)
    model_cfg = {"arch": "mbart_base", "dropout": 0.0, **WIDTHS}
    jax_save_state(str(path), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": model_cfg}, save_optimizer=False)
    return task


def test_generate_cli_matches_the_jax_cli(data, tmp_path):
    """``cli.generate --task translation_from_pretrained_bart --langs ...``
    on a JAX-written mBART checkpoint: the port's output file is the JAX
    CLI's line for line (S-, T-, H-, D-, P- and the score line), the
    ``[lang]`` tags stripped from what both print; ``cli.validate``
    rebuilds the stored arch."""
    ckpt = tmp_path / "mbart.ckpt"
    task = _mbart_checkpoint(data, ckpt)
    argv = [str(data["mt"]), "--task", "translation_from_pretrained_bart", "-s", "en_XX", "-t",
            "ro_RO", "--langs", MBART_LANGS, "--path", str(ckpt), "--gen-subset", "test",
            "--beam", "3", "--max-decode-len", "12", "--batch-size", "4", "--dtype", "float32",
            "--scoring", "bleu"]
    outs = {}
    for name, main, dev in (("jax", jax_generate.main, []),
                            ("port", generate.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        main(argv + ["--results-path", str(tmp_path / name)] + dev)
        outs[name] = (tmp_path / name / "generate-test.txt").read_text()
    assert_same_lines(outs["port"], outs["jax"])
    hyps = [ln for ln in outs["port"].splitlines() if ln.startswith("H-")]
    assert len(hyps) == 6
    # validate rebuilds the stored arch too
    got = validate.main([*argv[:9], "--path", str(ckpt), "--valid-subset", "test",
                         "--batch-size", "4", "--dtype", "float32", "--device", "cpu",
                         "--criterion", "label_smoothed_cross_entropy"])
    assert np.isfinite(got["loss"]) and got["loss"] > 0
    tags = {task.target_dictionary[i] for i in task.lang_tag_indices()}
    assert tags == {"[en_XX]", "[ro_RO]", "[de_DE]"}
    assert not any(t in outs["port"] for t in tags)


def test_multilingual_transformer_is_not_served(data, tmp_path):
    """The JAX generate CLI cannot decode a ``multilingual_transformer`` (it
    has no ``encode_text``); the port's refuses it by name (ROADMAP C)."""
    jm, params, cfg = _jax_multi({}, vocab=4 + len(WORDS))
    ckpt = tmp_path / "multi.ckpt"
    model_cfg = {"arch": "multilingual_transformer_iwslt_de_en", "lang_pairs": "de-en,fr-en",
                 **WIDTHS}
    jax_save_state(str(ckpt), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": model_cfg}, save_optimizer=False)
    argv = [str(data["mt"]), "--task", "multilingual_translation", "--lang-pairs",
            "de-en,fr-en", "--path", str(ckpt), "--gen-subset", "test", "--beam", "2",
            "--batch-size", "4", "--dtype", "float32", "--scoring", "bleu"]
    with pytest.raises(AttributeError, match="encode_text"):
        jax_generate.main(argv)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        generate.main(argv + ["--device", "cpu"])
    with open(ckpt, "rb") as f:
        assert pickle.load(f)["extra"]["model_cfg"]["arch"].startswith("multilingual")


# ------------------------------------------------------------------ registry

SLICE = {
    "model": ("bart", "multilingual_transformer"),
    "architecture": tuple(PRESETS),
    "task": ("translation_from_pretrained_bart", "translation_multi_simple_epoch",
             "denoising", "multilingual_denoising", "sentence_prediction",
             "sentence_ranking", "multilingual_translation"),
    "criterion": ("sentence_prediction", "sentence_ranking", "composite_loss",
                  "multilingual_label_smoothed_cross_entropy"),
}
PORT_REGISTRIES = {"model": R.MODELS, "architecture": R.ARCHITECTURES, "task": R.TASKS,
                   "criterion": R.CRITERIONS}
JAX_REGISTRIES = {"model": JR.MODELS, "architecture": JR.ARCHITECTURES, "task": JR.TASKS,
                  "criterion": JR.CRITERIONS}


@pytest.mark.parametrize("kind", sorted(SLICE))
def test_slice_names_are_registered_as_in_jax_and_the_reference(kind):
    """Every name the slice registers resolves in the port and in the JAX
    registry, and is a name of the reference's registries
    (``tests/data/reference_registry_names.json``) but the JAX package's
    own ``multilingual_label_smoothed_cross_entropy``."""
    import chimera_st_tpu_torch.criterions  # noqa: F401
    import chimera_st_tpu_torch.models  # noqa: F401
    import chimera_st_tpu_torch.tasks  # noqa: F401

    reference = json.loads((Path(__file__).parent / "data" /
                            "reference_registry_names.json").read_text())
    for name in SLICE[kind]:
        assert name in PORT_REGISTRIES[kind] and name in JAX_REGISTRIES[kind], name
        if name != "multilingual_label_smoothed_cross_entropy":
            assert f"{kind}:{name}" in reference, name
