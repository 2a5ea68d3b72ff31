"""Beam-search parity of the PyTorch port with the JAX package on the CPU:
``SequenceGenerator.generate_audio`` on the ``TINY`` model, beam 3, the
lazy-reorder path of both (un-repeated encoder K/V, ancestry map).

The random TINY decoder repeats one token, so its weights are scaled up
(x4) until hypotheses differ, and the eos embedding row is enlarged in one
case so that some hypotheses end before the eos-forcing step. Every beam,
not only the best, must agree: tokens and lengths exactly, scores to 1e-4
(fp32 through two encoder stacks and up to 16 decode steps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu_torch.generation.beam_search import _top_k
from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
from tests.test_interlingua_model import TINY
from tests.test_torch_models import flax_init, numpy_tree, port_model

CASES = {
    # eos forced at max_decode_len for every sentence
    "global_max_len": dict(eos_scale=1.0, settings=dict(min_len=2, len_penalty=0.5),
                           src_lengths=None),
    # per-sentence max_lens 12 / 7 / 9 from a * src_len, natural eos too
    "per_sentence_max_len": dict(eos_scale=1.5,
                                 settings=dict(min_len=2, len_penalty=1.0, max_len_a=0.003,
                                               max_len_b=0),
                                 src_lengths=[4000, 2500, 3000]),
}


@pytest.fixture(scope="module")
def decoder_scaled():
    _, params = flax_init(TINY, seed=1)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * 4.0
        if "decoder" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path)
        else np.asarray(x), params)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_audio_matches_jax(decoder_scaled, case):
    spec = CASES[case]
    params = numpy_tree(decoder_scaled)
    emb = params["params"]["decoder"]["embed_tokens"]["embedding"].copy()
    emb[2] *= spec["eos_scale"]  # eos = 2
    params["params"]["decoder"]["embed_tokens"]["embedding"] = emb

    rng = np.random.default_rng(0)
    wav = rng.normal(size=(3, 4000)).astype(np.float32)
    mask = np.zeros((3, 4000), bool)
    mask[1, 2500:] = True
    mask[2, 3000:] = True
    src_lengths = spec["src_lengths"]
    common = dict(beam_size=3, max_decode_len=16, **spec["settings"])

    jax_gen = JaxGenerator(JaxModel(TINY), JaxSettings(**common))
    ref = jax_gen.generate_audio(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(wav), jnp.asarray(mask),
        None if src_lengths is None else jnp.asarray(src_lengths))
    ref_tokens, ref_scores, ref_lens = map(np.asarray, ref)

    gen = SequenceGenerator(port_model(TINY, params), GeneratorSettings(**common))
    tokens, scores, lens = gen.generate_audio(
        torch.from_numpy(wav), torch.from_numpy(mask),
        None if src_lengths is None else torch.tensor(src_lengths))

    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=1e-4, rtol=1e-4)
    # the search is not degenerate: the beams of a sentence differ
    assert len({tuple(t) for t in tokens.numpy().reshape(-1, 16)}) > 3

    hyps = SequenceGenerator.to_hypotheses(tokens, scores, lens, nbest=2)
    assert len(hyps) == 3 and len(hyps[0]) == 2
    assert hyps[0][0]["tokens"][-1] == gen.eos
    assert hyps[0][0]["score"] == pytest.approx(float(scores[0, 0]))


def test_decode_past_max_target_positions_clamps_like_jax(decoder_scaled):
    """max_target_positions 8 and 12 decode steps: steps 8-11 lie past the
    position table, whose last row the JAX step's gather clamps to; the
    port's decoder does the same, so every token equals the JAX
    generator's (scores 1e-4)."""
    cfg = dataclasses.replace(TINY, max_target_positions=8)
    params = numpy_tree(decoder_scaled)
    rng = np.random.default_rng(4)
    wav = rng.normal(size=(2, 4000)).astype(np.float32)
    mask = np.zeros((2, 4000), bool)
    mask[1, 3000:] = True
    common = dict(beam_size=3, max_decode_len=12, min_len=11, len_penalty=1.0)
    ref = JaxGenerator(JaxModel(cfg), JaxSettings(**common)).generate_audio(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(wav), jnp.asarray(mask))
    ref_tokens, ref_scores, ref_lens = map(np.asarray, ref)
    tokens, scores, lens = SequenceGenerator(port_model(cfg, params), GeneratorSettings(
        **common)).generate_audio(torch.from_numpy(wav), torch.from_numpy(mask))
    assert (ref_lens == 12).all()
    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=1e-4, rtol=1e-4)


def test_top_k_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` prefers the lower index among equal values; the
    port's top-k does the same."""
    x = np.array([[0.5, 1.0, 0.5, 1.0, -2.0, 0.5]], np.float32)
    values, idx = _top_k(torch.from_numpy(x), 4)
    ref_values, ref_idx = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))


# ---- the options the generate CLI's single-model beam path forwards: the text
# branch, forced prefixes, n-gram bans and the temperature

OPTION_CASES = {
    "plain": dict(settings=dict(min_len=2, len_penalty=1.0)),
    # row 1 forces two tokens, row 2 one (pad forces nothing), row 0 none
    "prefix_tokens": dict(settings=dict(min_len=2, len_penalty=1.0),
                          prefix=[[1, 1, 1], [7, 9, 1], [5, 1, 1]]),
    # a forced eos ends the hypothesis at once
    "prefix_with_eos": dict(settings=dict(min_len=1, len_penalty=1.0),
                            prefix=[[6, 2], [7, 1], [1, 1]]),
    "no_repeat_bigram": dict(settings=dict(min_len=2, no_repeat_ngram_size=2)),
    "no_repeat_trigram": dict(settings=dict(min_len=2, no_repeat_ngram_size=3,
                                            len_penalty=0.5)),
    "temperature": dict(settings=dict(min_len=2, temperature=0.6, len_penalty=1.5)),
    "everything": dict(settings=dict(min_len=3, temperature=1.7, no_repeat_ngram_size=2,
                                     unk_penalty=0.4, max_len_a=1.5, max_len_b=2,
                                     min_len_a=0.5, min_len_b=1),
                       prefix=[[4, 1], [1, 1], [8, 8]], src_lengths=True),
}


def _run_both(decoder_scaled, spec, audio: bool):
    params = numpy_tree(decoder_scaled)
    common = dict(beam_size=3, max_decode_len=12, **spec["settings"])
    jax_gen = JaxGenerator(JaxModel(TINY), JaxSettings(**common))
    gen = SequenceGenerator(port_model(TINY, params), GeneratorSettings(**common))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    prefix = spec.get("prefix")
    jprefix = None if prefix is None else jnp.asarray(prefix, jnp.int32)
    tprefix = None if prefix is None else torch.tensor(prefix)
    if audio:
        rng = np.random.default_rng(3)
        wav = rng.normal(size=(3, 3000)).astype(np.float32)
        mask = np.zeros((3, 3000), bool)
        mask[1, 1800:] = True
        ref = jax_gen.generate_audio(jparams, jnp.asarray(wav), jnp.asarray(mask),
                                     prefix_tokens=jprefix)
        got = gen.generate_audio(torch.from_numpy(wav), torch.from_numpy(mask),
                                 prefix_tokens=tprefix)
    else:
        src = np.array([[4, 5, 6, 7, 8, 9, 2, 1], [10, 11, 2, 1, 1, 1, 1, 1],
                        [12, 13, 14, 15, 2, 1, 1, 1]], np.int64)
        lengths = [7, 3, 5] if spec.get("src_lengths") else None
        ref = jax_gen.generate_text(
            jparams, jnp.asarray(src, jnp.int32),
            src_lengths=None if lengths is None else jnp.asarray(lengths),
            prefix_tokens=jprefix)
        got = gen.generate_text(torch.from_numpy(src),
                                None if lengths is None else torch.tensor(lengths),
                                prefix_tokens=tprefix)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got], gen


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_generate_text_options_match_jax(decoder_scaled, case):
    spec = OPTION_CASES[case]
    (ref_tokens, ref_scores, ref_lens), (tokens, scores, lens), gen = _run_both(
        decoder_scaled, spec, audio=False)
    np.testing.assert_array_equal(lens, ref_lens)
    np.testing.assert_array_equal(tokens, ref_tokens)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=1e-4)
    prefix = spec.get("prefix")
    if prefix is not None:
        # the best hypothesis (a forced prefix leaves fewer than K live beams
        # at first, so the later ones may hold banned candidates)
        for b, row in enumerate(prefix):
            for p, tok in enumerate(row):
                if tok == gen.pad:
                    break
                assert tokens[b, 0, p] == tok
                if tok == gen.eos:
                    assert lens[b, 0] == p + 1
                    break
    n = spec["settings"].get("no_repeat_ngram_size", 0)
    if n:
        for b in range(3):
            for k in range(3):
                hyp = [gen.eos] + tokens[b, k, :lens[b, k]].tolist()  # the bos seed counts
                grams = [tuple(hyp[i:i + n]) for i in range(len(hyp) - n + 1)]
                assert len(grams) == len(set(grams)), (b, k, hyp)


@pytest.mark.parametrize("case", ["prefix_tokens", "no_repeat_bigram", "temperature"])
def test_generate_audio_options_match_jax(decoder_scaled, case):
    (ref_tokens, ref_scores, ref_lens), (tokens, scores, lens), _ = _run_both(
        decoder_scaled, OPTION_CASES[case], audio=True)
    np.testing.assert_array_equal(lens, ref_lens)
    np.testing.assert_array_equal(tokens, ref_tokens)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=1e-4)


def test_options_change_the_search(decoder_scaled):
    """The cases above are no accident of options that do nothing."""
    outs = {case: _run_both(decoder_scaled, OPTION_CASES[case], audio=False)[1]
            for case in ("plain", "no_repeat_bigram", "temperature", "prefix_tokens")}
    plain = outs["plain"]
    assert not np.array_equal(outs["no_repeat_bigram"][0], plain[0])
    assert not np.allclose(outs["temperature"][1], plain[1], atol=1e-3)
    assert not np.array_equal(outs["prefix_tokens"][0][1:], plain[0][1:])
    np.testing.assert_array_equal(outs["prefix_tokens"][0][0], plain[0][0])  # row 0: no prefix


@pytest.mark.parametrize("n,i", [(1, 0), (1, 4), (2, 1), (2, 5), (3, 2), (3, 6), (4, 3), (4, 7)])
def test_ngram_bans_match_a_direct_count(n, i):
    """``_ngram_bans`` against a plain Python scan of every hypothesis."""
    from chimera_st_tpu_torch.generation.beam_search import _ngram_bans

    rng = np.random.default_rng(10 * n + i)
    B, K, V = 2, 3, 5
    seq = rng.integers(0, V, size=(B, K, 9))
    bans = _ngram_bans(torch.from_numpy(seq), i, n, V).numpy()
    for b in range(B):
        for k in range(K):
            hyp = seq[b, k, :i + 1].tolist()
            tail = hyp[len(hyp) - (n - 1):] if n > 1 else []
            want = {hyp[j + n - 1] for j in range(len(hyp) - n + 1)
                    if hyp[j:j + n - 1] == tail}
            assert set(np.nonzero(bans[b, k])[0].tolist()) == want, (b, k, hyp)
