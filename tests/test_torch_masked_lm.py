"""The port's masked-LM family (``models/masked_lm.py``,
``models/roberta_hub.py``) against the JAX package on the CPU: the forward
logits, ``encode``, ``classify_sentence`` and ``forward_with_sentence`` on a
padded batch, the converter both ways, the ten presets, the RoBERTa hub
(``encode`` through a GPT-2 BPE, ``fill_mask``, features, ``predict``
through a registered head, the word alignment), the XLM weights merged
into a transformer, and sentence prediction on a ``roberta*`` model, which
neither package trains.

Weights: a flax init's tree with every leaf replaced by seeded numpy draws
(``tests/test_torch_transformer.py`` ``seeded_tree``), carried across by
``convert.py``. Widths: 2 layers, 32 wide, 4 heads, dropout 0. Tolerance:
fp32 1e-5 absolute and relative; top-k and alignments identical.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chimera_st_tpu.criterions  # noqa: F401 — registration
import chimera_st_tpu.models  # noqa: F401
import chimera_st_tpu.tasks  # noqa: F401
from chimera_st_tpu.config import registry as JR
from chimera_st_tpu.data.dictionary import Dictionary as JaxDictionary
from chimera_st_tpu.data.encoders import build_bpe as jax_build_bpe
from chimera_st_tpu.models import masked_lm as jax_mlm
from chimera_st_tpu.models import roberta_hub as jax_hub
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.config import registry as R
from chimera_st_tpu_torch.data.dictionary import Dictionary
from chimera_st_tpu_torch.data.encoders import build_bpe
from chimera_st_tpu_torch.models import masked_lm, roberta_hub
from chimera_st_tpu_torch.tasks import setup_task
from tests.test_torch_bart import data  # noqa: F401 — the sentence-prediction data fixture
from tests.test_torch_transformer import seeded_tree

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(vocab_size=40, embed_dim=32, ffn_dim=64, layers=2, heads=4, dropout=0.0)
# bos 0, pad 1, eos 2; rows of 8, 4 and 7 real tokens
TOKENS = np.array([[0, 5, 6, 7, 8, 9, 10, 2], [0, 11, 12, 2, 1, 1, 1, 1],
                   [0, 13, 14, 15, 16, 17, 2, 1]], np.int32)


def jax_model(arch, seed=0, **extra):
    cfg = JR.ARCHITECTURES.get(arch)[1]({**SMALL, **extra})
    jm = jax_mlm.build_masked_lm(cfg)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(TOKENS)))
    return jm, seeded_tree(init(jax.random.PRNGKey(0)), seed), cfg


def port_model(cfg, params):
    model = masked_lm.build_masked_lm(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params, "masked_lm"), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def bert():
    """``bert_base`` at the small widths (with its next-sentence head)."""
    jm, params, cfg = jax_model("bert_base")
    return jm, params, port_model(cfg, params)


@pytest.mark.parametrize("arch", ["roberta_base", "bert_base"])
def test_forward_encode_and_heads_match_jax(arch, bert):
    """Logits, the final states and (bert) the next-sentence logits of
    ``classify_sentence`` and ``forward_with_sentence`` against JAX, fp32,
    on a batch with padding."""
    jm, params, model = bert if arch == "bert_base" else (*jax_model(arch, seed=3)[:2], None)
    if model is None:
        model = port_model(JR.ARCHITECTURES.get(arch)[1](dict(SMALL)), params)
    cls = jax_mlm.MaskedLMModel
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    t = jnp.asarray(TOKENS)
    tt = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        np.testing.assert_allclose(model(tt).numpy(), np.asarray(jm.apply(jp, t)), **TOL)
        feats, mask = model.encode(tt)
        want, want_mask = jm.apply(jp, t, method=cls.encode)
        np.testing.assert_allclose(feats.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        if arch != "bert_base":
            assert not hasattr(model, "sentence_projection")
            return
        np.testing.assert_allclose(model.classify_sentence(tt).numpy(),
                                   np.asarray(jm.apply(jp, t, method=cls.classify_sentence)),
                                   **TOL)
        got = model.forward_with_sentence(tt)
        want = jm.apply(jp, t, method=cls.forward_with_sentence)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_converter_round_trips(bert):
    """flax -> the port's state dict (strict) -> flax, leaf for leaf, the
    root ``lm_head_bias`` and the next-sentence head included."""
    _, params, model = bert
    back = convert.params_to_flax(model.state_dict(), "masked_lm")
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(want) == set(got) and "['params']['lm_head_bias']" in want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert convert.model_kind(model) == "masked_lm"


ARCHS = ("masked_lm", "roberta", "roberta_base", "roberta_large", "camembert", "xlmr", "xlm",
         "bert_base", "bert_large", "xlm_base")


@pytest.mark.parametrize("arch", ARCHS)
def test_presets_and_names_match_jax(arch):
    """Each preset fills the JAX preset's fields under the same model name;
    the model names ``masked_lm``, ``roberta``, ``camembert`` and ``xlmr``
    resolve in both packages."""
    import chimera_st_tpu_torch.models  # noqa: F401 — registration

    model, preset = R.ARCHITECTURES.get(arch)
    jax_model_name, jax_preset = JR.ARCHITECTURES.get(arch)
    assert model == jax_model_name
    assert preset({"dropout": 0.0}) == jax_preset({"dropout": 0.0})
    for name in ("masked_lm", "roberta", "camembert", "xlmr", "transformer_from_pretrained_xlm"):
        assert name in R.MODELS and name in JR.MODELS


# ------------------------------------------------------------------ the hub

WORDS = ("hello", "world", "there", "peace")


def gpt2_assets(root):
    """A byte-level BPE over the byte alphabet with merges that spell the
    fixture words, those after GPT-2's leading-space marker first (so that
    a word after a space is one token, as in GPT-2's merges)."""
    from chimera_st_tpu_torch.data.encoders_bpe import bytes_to_unicode

    b2u = bytes_to_unicode()
    merges = []
    for w in WORDS:
        for word in ("Ġ" + w, w):
            cur = word[0]
            for c in word[1:]:
                if (cur, c) not in merges:
                    merges.append((cur, c))
                cur += c
    symbols = [b2u[b] for b in range(256)] + list(dict.fromkeys("".join(m) for m in merges))
    (root / "encoder.json").write_text(json.dumps({s: i for i, s in enumerate(symbols)}))
    (root / "vocab.bpe").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    # RoBERTa's dictionary lists the BPE ids
    (root / "dict.txt").write_text("".join(f"{i} {1000 - i}\n" for i in range(len(symbols))))
    return {"_name": "gpt2", "gpt2_encoder_json": str(root / "encoder.json"),
            "gpt2_vocab_bpe": str(root / "vocab.bpe")}


@pytest.fixture(scope="module")
def hubs(tmp_path_factory):
    """The JAX and the port's hub over one ``roberta_base`` (small widths)
    and the fixture's GPT-2 BPE and dictionary (with ``<mask>``)."""
    root = tmp_path_factory.mktemp("hub")
    bpe_cfg = gpt2_assets(root)
    jd, pd = JaxDictionary.load(str(root / "dict.txt")), Dictionary.load(str(root / "dict.txt"))
    for d in (jd, pd):
        d.add_symbol("<mask>")
    jm, params, cfg = jax_model("roberta_base", seed=7, vocab_size=len(pd))
    jhub = jax_hub.RobertaHubInterface(jm, jax.tree_util.tree_map(jnp.asarray, params), jd,
                                       jax_build_bpe(bpe_cfg))
    return jhub, roberta_hub.RobertaHubInterface(port_model(cfg, params), pd, build_bpe(bpe_cfg))


SENTENCES = ("hello world", "hello there world peace", "peace")


def test_hub_encode_fill_mask_features_and_predict_match_jax(hubs):
    """Token ids, decode, ``fill_mask`` (top 5 tokens identical, their
    probabilities within 1e-5), features of a padded batch and ``predict``
    through a 3-class head drawn from the same seed, against JAX."""
    jhub, hub = hubs
    rows = [hub.encode(s) for s in SENTENCES]
    for s, r in zip(SENTENCES, rows):
        np.testing.assert_array_equal(r, jhub.encode(s))
        assert hub.decode(r) == jhub.decode(r) == s
    masked = rows[1].copy()
    masked[2] = hub.dictionary.index("<mask>")
    for pos in (2, 3):
        got, want = hub.fill_mask(masked, pos, topk=5), jhub.fill_mask(masked, pos, topk=5)
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([p for _, p in got], [p for _, p in want], **TOL)
    batch = np.full((len(rows), max(map(len, rows))), hub.dictionary.pad(), np.int32)
    for i, r in enumerate(rows):
        batch[i, :len(r)] = r
    np.testing.assert_allclose(hub.extract_features(batch), jhub.extract_features(batch), **TOL)
    for h in (hub, jhub):
        h.register_classification_head("nli", 3, seed=11)
    np.testing.assert_allclose(hub.predict("nli", batch), jhub.predict("nli", batch), **TOL)


@pytest.mark.parametrize("words", [None, ["hel", "lo", "world"]])
def test_hub_word_alignment_matches_jax(hubs, words):
    """``align_bpe_to_words`` and the word-pooled features, a word over one
    BPE token and a BPE token over two words."""
    jhub, hub = hubs
    sentence = "hello world"
    toks = hub.encode(sentence)
    w = words or sentence.split()
    assert hub.align_bpe_to_words(toks, w) == jhub.align_bpe_to_words(toks, w)
    labels, feats = hub.extract_features_aligned_to_words(sentence, words)
    want_labels, want = jhub.extract_features_aligned_to_words(sentence, words)
    assert labels == want_labels
    np.testing.assert_allclose(feats, want, **TOL)


def test_an_unaligned_bpe_token_inside_a_sentence_fails_in_both(hubs):
    """A bare space token between two words aligns to no word, and
    ``align_features_to_words`` drops its row and fails its own mass check,
    in JAX (``models/roberta_hub.py:170-192``) as in the port (ROADMAP C)."""
    jhub, hub = hubs
    space = hub.dictionary.index(str(hub.bpe.encoder["Ġ"]))
    toks = np.array([0, hub.encode("hello")[1], space, hub.encode("world")[1], 2], np.int32)
    alignment = hub.align_bpe_to_words(toks, ["hello", "world"])
    assert alignment == jhub.align_bpe_to_words(toks, ["hello", "world"]) == [[1], [3]]
    for h in (hub, jhub):
        with pytest.raises(AssertionError):
            h.align_features_to_words(h.extract_features(toks)[0], alignment)


# ---------------------------------------------------- XLM-initialised MT

@pytest.mark.parametrize("init_decoder", [False, True])
def test_xlm_merge_matches_jax(init_decoder):
    """The XLM's embeddings and layers written into a transformer at the
    same widths: every tensor equal to the JAX merge's (the decoder's
    embeddings too with ``init_decoder``)."""
    xlm, xlm_params, _ = jax_model("xlm_base", seed=5)
    mt_cfg = jax_mt.TransformerMTConfig(
        src_vocab_size=40, tgt_vocab_size=40, encoder_embed_dim=32, encoder_ffn_dim=64,
        encoder_layers=2, encoder_heads=4, decoder_embed_dim=32, decoder_ffn_dim=64,
        decoder_layers=1, decoder_heads=4, encoder_normalize_before=False)
    jmt = jax_mt.TransformerModel(mt_cfg)
    src = jnp.asarray(TOKENS)
    mt_params = seeded_tree(jax.jit(lambda k: jmt.init(k, src, src))(jax.random.PRNGKey(0)), 6)
    want = jax_hub.init_transformer_from_pretrained_xlm(mt_params, xlm_params, init_decoder)
    got = roberta_hub.init_transformer_from_pretrained_xlm(
        convert.params_from_flax(mt_params, "transformer"),
        convert.params_from_flax(xlm_params, "masked_lm"), init_decoder)
    want = convert.params_from_flax(want, "transformer")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["encoder.layers.1.fc1.weight"],
                       convert.params_from_flax(xlm_params, "masked_lm")["layers.1.fc1.weight"])
    with pytest.raises(ValueError, match="no XLM parameters matched"):
        roberta_hub.init_transformer_from_pretrained_xlm(
            {"decoder.layer_norm.weight": torch.ones(3)},
            {"layers.0.fc1.weight": torch.ones(2)})


# --------------------------------------------------- sentence prediction

def test_sentence_prediction_on_a_masked_lm_is_refused_by_both(data):
    """``--task sentence_prediction --arch roberta_base``: the JAX criterion
    asks ``MaskedLMModel`` for a ``classify`` method it has not
    (``chimera_st_tpu/criterions/sentence_prediction.py:30``); the port
    refuses the model at build, naming ROADMAP C."""
    cfg = {"_name": "sentence_prediction", "data": str(data["glue"])}
    model_cfg = {"arch": "roberta_base", **SMALL}
    jtask = jax_setup_task(dict(cfg))
    jtask.load_dataset("valid")
    jm = jtask.build_model(dict(model_cfg))
    batch = next(iter(jtask.make_batch_iterator(jtask.dataset("valid"), max_sentences=4)
                      .next_epoch_itr(shuffle=False)))
    crit = jtask.build_criterion({"_name": "sentence_prediction"})
    with pytest.raises(AttributeError, match="classify"):
        crit(jm, None, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        setup_task(dict(cfg)).build_model(dict(model_cfg), device="cpu")


def test_xlm_hub_at_two_layers_matches_jax(tmp_path):
    """The ``xlm`` preset at its widths (1,280, FFN 5,120, 16 heads of 80,
    the head dim K1 and K3 took last) cut to 2 layers, through both hubs:
    the features of a padded batch and ``fill_mask`` against JAX, fp32 (1e-4
    of the features' scale: sums over 1,280 and 5,120 terms)."""
    bpe_cfg = gpt2_assets(tmp_path)
    jd, pd = JaxDictionary.load(str(tmp_path / "dict.txt")), Dictionary.load(
        str(tmp_path / "dict.txt"))
    for d in (jd, pd):
        d.add_symbol("<mask>")
    cfg = JR.ARCHITECTURES.get("xlm")[1]({"vocab_size": len(pd), "layers": 2, "dropout": 0.0})
    assert (cfg["embed_dim"], cfg["ffn_dim"], cfg["heads"]) == (1280, 5120, 16)
    jm = jax_mlm.build_masked_lm(cfg)
    params = seeded_tree(jax.jit(lambda k: jm.init(k, jnp.asarray(TOKENS)))(
        jax.random.PRNGKey(0)), 13)
    jhub = jax_hub.RobertaHubInterface(jm, jax.tree_util.tree_map(jnp.asarray, params), jd,
                                       jax_build_bpe(bpe_cfg))
    hub = roberta_hub.RobertaHubInterface(port_model(cfg, params), pd, build_bpe(bpe_cfg))
    rows = [hub.encode(s) for s in SENTENCES]
    batch = np.full((len(rows), max(map(len, rows))), pd.pad(), np.int32)
    for i, r in enumerate(rows):
        batch[i, :len(r)] = r
    want = jhub.extract_features(batch)
    np.testing.assert_allclose(hub.extract_features(batch), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    masked = rows[1].copy()
    masked[2] = pd.index("<mask>")
    got, ref = hub.fill_mask(masked, 2, topk=5), jhub.fill_mask(masked, 2, topk=5)
    assert [t for t, _ in got] == [t for t, _ in ref]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref], atol=1e-4)
