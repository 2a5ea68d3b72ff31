"""The port's subword encoders, tokenizers and scorers against the JAX
package on the CPU: every BPE name (``gpt2`` / ``gpt2_bpe``,
``subword_nmt``, ``fastbpe``, ``byte_bpe``, ``bert`` / ``hf_bert_bpe``,
``hf_byte_bpe``) and the ``moses`` / ``nltk`` tokenizers encode and decode a
fixture corpus to the same strings, from fixture vocabularies written here;
``chrf`` and ``cli.score`` print the JAX package's lines; the C++ BLEU
counter (``csrc/libbleu.cpp``, built with g++) counts what the Python
version counts, and a source g++ cannot compile raises.
"""

import json

import numpy as np
import pytest

from chimera_st_tpu.cli import score as jax_score
from chimera_st_tpu.data.encoders import build_bpe as jax_build_bpe
from chimera_st_tpu.data.encoders import build_tokenizer as jax_build_tokenizer
from chimera_st_tpu_torch import host_library
from chimera_st_tpu_torch.cli import score
from chimera_st_tpu_torch.data.encoders import build_bpe, build_tokenizer
from chimera_st_tpu_torch.scoring import bleu
from tests.test_torch_data import PIECES, write_spm_model
from tests.test_torch_masked_lm import gpt2_assets

CORPUS = ["hello world", "hello there , world peace !", "héllo wörld 42", "peace",
          "  there   hello ", "unknownword hello"]


def _bert_vocab(root):
    path = root / "vocab.txt"
    path.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world",
                               "wo", "##rld", "##llo", "he", "there", "peace", ",", "!",
                               "##s", "un", "##known", "##word"]) + "\n")
    return {"bpe_vocab_file": str(path)}


def _hf_byte_bpe(root):
    from tokenizers import ByteLevelBPETokenizer

    corpus = root / "corpus.txt"
    corpus.write_text("hello world\nhello there\nworld peace\n" * 20)
    tok = ByteLevelBPETokenizer()
    tok.train([str(corpus)], vocab_size=300, min_frequency=1, show_progress=False)
    tok.save_model(str(root))
    return {"bpe_vocab": str(root / "vocab.json"), "bpe_merges": str(root / "merges.txt")}


def _codes(root, columns):
    path = root / f"codes{columns}"
    merges = ["l l", "ll o</w>", "h e", "he llo</w>", "w o", "wo r", "wor l", "worl d</w>",
              "p e", "pe a", "pea c", "peac e</w>"]
    path.write_text("#version: 0.2\n" + "".join(m + (" 7" if columns == 3 else "") + "\n"
                                                for m in merges))
    return {"bpe_codes": str(path)}


def _byte_bpe(root):
    path = root / "bytes.model"
    write_spm_model(str(path), PIECES + [(c, -5.0, 1) for c in "lwpiknhé"])
    return {"sentencepiece_model_path": str(path)}


CONFIGS = {
    "gpt2": gpt2_assets, "gpt2_bpe": gpt2_assets,
    "subword_nmt": lambda r: _codes(r, 2), "fastbpe": lambda r: _codes(r, 3),
    "byte_bpe": _byte_bpe, "bert": _bert_vocab, "hf_bert_bpe": _bert_vocab,
    "hf_byte_bpe": _hf_byte_bpe,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bpe_strings_match_jax(name, tmp_path):
    """encode, decode and (where the encoder has it) ``is_beginning_of_word``
    of every corpus line equal to the JAX encoder's."""
    cfg = {"_name": name, **CONFIGS[name](tmp_path)}
    ours, ref = build_bpe(dict(cfg)), jax_build_bpe(dict(cfg))
    for line in CORPUS:
        enc = ours.encode(line)
        assert enc == ref.encode(line), (name, line)
        assert ours.decode(enc) == ref.decode(enc), (name, line)
        if hasattr(ref, "is_beginning_of_word"):
            for piece in enc.split()[:3]:
                assert ours.is_beginning_of_word(piece) == ref.is_beginning_of_word(piece)
    if name != "byte_bpe":  # the fixture's byte pieces leave most bytes unknown
        assert any(ours.decode(ours.encode(l)) == l for l in CORPUS)


@pytest.mark.parametrize("name", ["moses", "nltk"])
def test_tokenizers_match_jax(name):
    """The tokenizers' strings equal the JAX package's; ``nltk`` needs its
    ``punkt`` data, and without it both packages raise the same
    ``LookupError``."""
    cfg = {"_name": name, "source_lang": "en"}
    ours, ref = build_tokenizer(dict(cfg)), jax_build_tokenizer(dict(cfg))
    for line in CORPUS + ["It's a \"test\" (of 3.5 things)."]:
        try:
            want = ref.encode(line)
        except LookupError:
            with pytest.raises(LookupError):
                ours.encode(line)
            continue
        assert ours.encode(line) == want
        assert ours.decode(want) == ref.decode(want)


def test_native_bleu_counts_equal_the_python_counts():
    """The C++ counter's n-gram buckets equal ``ngram_stats``'s over random
    pairs, repeats, empty and unk-negated references included."""
    rng = np.random.default_rng(0)
    pairs = [([], [5]), ([5], []), ([4, 4, 4, 4], [4, 4]), ([-103, 7], [3, 7])]
    for _ in range(40):
        ref = rng.integers(4, 12, size=int(rng.integers(0, 30))).tolist()
        pred = rng.integers(4, 12, size=int(rng.integers(0, 30))).tolist()
        pairs.append((ref, pred))
    for ref, pred in pairs:
        assert bleu.ngram_stats_native(ref, pred) == bleu.ngram_stats(ref, pred), (ref, pred)


def test_a_failed_host_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_library.build(bad, "libbad", tmp_path / "build")


@pytest.mark.parametrize("scoring", ["sacrebleu", "chrf", "wer", "bleu"])
def test_score_cli_matches_jax(scoring, tmp_path, capsys):
    """``cli.score`` prints the JAX CLI's line; ``bleu`` scores lines of
    token ids in the port, where the JAX CLI raises (its token-id scorer
    has no ``add_string``: ROADMAP C), and its line is the Python
    counter's."""
    rng = np.random.default_rng(1)
    refs, hyps = [], []
    for _ in range(8):
        ref = rng.integers(4, 30, size=int(rng.integers(3, 14))).tolist()
        hyp = [t if rng.random() < 0.7 else int(rng.integers(4, 30)) for t in ref]
        refs.append(ref)
        hyps.append(hyp)
    words = scoring != "bleu"
    fmt = (lambda r: " ".join(f"w{t}" for t in r)) if words else (lambda r: " ".join(map(str, r)))
    (tmp_path / "ref.txt").write_text("".join(fmt(r) + "\n" for r in refs))
    (tmp_path / "hyp.txt").write_text("".join(fmt(h) + "\n" for h in hyps))
    argv = ["--sys", str(tmp_path / "hyp.txt"), "--ref", str(tmp_path / "ref.txt"),
            "--scoring", scoring]
    score.main(argv)
    got = capsys.readouterr().out
    if scoring == "bleu":
        with pytest.raises(AttributeError, match="add_string"):
            jax_score.main(argv)
        plain = bleu.Scorer({})
        plain.stat = bleu.BleuStat()
        for r, h in zip(refs, hyps):
            plain.stat += bleu.ngram_stats(r, h)
        assert got.strip() == plain.result_string()
        return
    jax_score.main(argv)
    assert got == capsys.readouterr().out and got.strip()


def test_gpt2_encoder_json_round_trip(tmp_path):
    """The GPT-2 BPE ids index ``encoder.json``; decode inverts encode."""
    cfg = gpt2_assets(tmp_path)
    enc = json.loads((tmp_path / "encoder.json").read_text())
    bpe = build_bpe(cfg)
    ids = bpe.encode("hello world")
    assert [bpe.decoder[int(i)] for i in ids.split()] == ["hello", "Ġworld"]
    assert all(bpe.decoder[int(i)] in enc for i in ids.split())
    assert bpe.decode(ids) == "hello world"
