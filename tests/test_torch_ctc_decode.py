"""The port's CTC decoding and WER against the JAX package's, on the host:
greedy collapse, prefix beam search with and without a seeded 3-gram ARPA
LM (hypotheses and scores identical), the ARPA reader's back-off scores,
``levenshtein`` and the ``wer`` scorer with each tokenizer setting."""

import numpy as np
import pytest

from chimera_st_tpu.criterions.ctc import ctc_greedy_decode as jax_greedy
from chimera_st_tpu.generation import ctc_decoder as jax_dec
from chimera_st_tpu.scoring import wer as jax_wer
from chimera_st_tpu_torch.criterions.ctc import ctc_greedy_decode
from chimera_st_tpu_torch.generation import ctc_decoder
from chimera_st_tpu_torch.scoring import build_scorer, wer

LETTERS = list("|abcdefghijklmnopqrstuvwxyz'")
# the fairseq letter dictionary's layout: 4 specials, then the letters
NAMES = ["<s>", "<pad>", "</s>", "<unk>"] + LETTERS


def seeded_arpa(path, seed=0, order=3):
    """A back-off n-gram LM in ARPA text over the letters: every unigram,
    seeded bigrams and trigrams, log10 probabilities and back-offs."""
    rng = np.random.default_rng(seed)
    grams = [[(w,) for w in LETTERS + ["<unk>"]]]
    for n in range(2, order + 1):
        grams.append(sorted({tuple(rng.choice(LETTERS, size=n)) for _ in range(60)}))
    lines = ["\\data\\"] + [f"ngram {n + 1}={len(g)}" for n, g in enumerate(grams)] + [""]
    for n, g in enumerate(grams):
        lines.append(f"\\{n + 1}-grams:")
        for toks in g:
            row = f"{-rng.uniform(0.2, 2.5):.4f}\t{' '.join(toks)}"
            if n + 1 < order:
                row += f"\t{-rng.uniform(0.0, 0.8):.4f}"
            lines.append(row)
        lines.append("")
    path.write_text("\n".join(lines + ["\\end\\", ""]))
    return str(path)


def frames(seed, T=40):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, len(NAMES))) * 2.0
    logits[:, 0] += 1.5  # the blank leads, as in a trained model
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


@pytest.mark.parametrize("lm", [False, True], ids=["no_lm", "arpa_3gram"])
@pytest.mark.parametrize("beam", [1, 8, 50])
def test_decodes_match_jax(tmp_path, beam, lm):
    """Greedy at beam 1, prefix beam above it (with the LM at weight 0.8):
    the best hypothesis and its score of every utterance equal JAX's."""
    arpa = seeded_arpa(tmp_path / "lm.arpa") if lm else None
    for seed in range(4):
        lp = frames(seed)
        if beam == 1:
            assert ctc_greedy_decode(lp, 0) == jax_greedy(lp, 0)
            continue
        kw = dict(beam_size=beam, blank=0, lm_weight=0.8, token_strings=NAMES)
        got = ctc_decoder.ctc_beam_search(lp, lm=ctc_decoder.ArpaLM(arpa) if arpa else None, **kw)
        want = jax_dec.ctc_beam_search(lp, lm=jax_dec.ArpaLM(arpa) if arpa else None, **kw)
        assert [h for h, _ in got] == [h for h, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=0)


def test_arpa_scores_match_jax(tmp_path):
    arpa = seeded_arpa(tmp_path / "lm.arpa", seed=3)
    got, want = ctc_decoder.ArpaLM(arpa), jax_dec.ArpaLM(arpa)
    rng = np.random.default_rng(1)
    for _ in range(200):
        ctx = list(rng.choice(LETTERS, size=int(rng.integers(0, 4))))
        tok = str(rng.choice(LETTERS + ["zz"]))
        assert got.score(ctx, tok) == want.score(ctx, tok)


def test_levenshtein_and_wer_match_jax():
    rng = np.random.default_rng(2)
    words = ["the", "cat", "sat", "on", "a", "mat", "Mat,", "THE"]
    for _ in range(50):
        a = list(rng.choice(words, size=int(rng.integers(0, 9))))
        b = list(rng.choice(words, size=int(rng.integers(0, 9))))
        assert wer.levenshtein(a, b) == jax_wer.levenshtein(a, b)
    for cfg in ({}, {"wer_lowercase": True}, {"wer_tokenizer": "13a", "wer_remove_punct": True},
                {"wer_char_level": True}):
        ours, theirs = build_scorer({"_name": "wer", **cfg}), jax_wer.WerScorer(cfg)
        for _ in range(20):
            ref = " ".join(rng.choice(words, size=int(rng.integers(1, 8))))
            hyp = " ".join(rng.choice(words, size=int(rng.integers(0, 8))))
            ours.add_string(ref, hyp)
            theirs.add_string(ref, hyp)
        assert ours.score() == theirs.score()
        assert ours.result_string() == theirs.result_string()
    with pytest.raises(ValueError, match="unsupported"):
        wer.EvaluationTokenizer("nope")
