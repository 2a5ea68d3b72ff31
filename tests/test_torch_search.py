"""The port's search strategies and diverse beam groups against the JAX
package's on the CPU: the ``TINY`` model, its decoder sharpened (x4) so that
hypotheses differ, the same weights in both packages, beam 4, fp32. Every
beam must agree: tokens and lengths exactly, scores within 1e-5 (plus 1e-5
relative: fp32 through two encoder stacks and 12 decode steps).

Also: the constraint packers element by element, and the port's plain beam
search against the dynamic-Python oracle ``tests/beam_oracle.py`` on the
cases of ``tests/test_generate_golden.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.generation import search_strategies as jax_ss
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu_torch.checkpoint.torch_import import import_interlingua_state_dict
from chimera_st_tpu_torch.generation import search_strategies as ss
from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel
from tests.beam_oracle import oracle_beam
from tests.test_interlingua_model import TINY
from tests.test_torch_models import flax_init, numpy_tree, port_config, port_model
from tests.torch_reference import TorchChimera

TOL = dict(atol=1e-5, rtol=1e-5)
BEAM, MAX_LEN = 4, 12
# per sentence: two phrases of target tokens (TINY's vocabulary is 20)
PHRASES = [[[7, 9], [12]], [[5], [14, 6]], [[11, 4], [8]]]


@pytest.fixture(scope="module")
def models():
    _, params = flax_init(TINY, seed=1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * 4.0
        if "decoder" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path)
        else np.asarray(x), params)
    params = numpy_tree(params)
    rng = np.random.default_rng(3)
    wav = rng.normal(size=(3, 4000)).astype(np.float32)
    mask = np.zeros((3, 4000), bool)
    mask[1, 2600:] = True
    mask[2, 3100:] = True
    return dict(jax_params=jax.tree_util.tree_map(jnp.asarray, params),
                port=port_model(TINY, params), wav=wav, mask=mask)


def _prefix_allowed_jax(alive_seq, step):
    """Tokens allowed after an odd token: the even ones (and eos)."""
    last = jax.lax.dynamic_slice_in_dim(alive_seq, step, 1, axis=2)  # [B, K, 1]
    V = TINY.tgt_vocab_size
    tok = jnp.arange(V)[None, None, :]
    return jnp.where(last % 2 == 1, (tok % 2 == 0) | (tok == 2), True)


def _prefix_allowed_port(alive_seq, step):
    last = alive_seq[:, :, step:step + 1]
    tok = torch.arange(TINY.tgt_vocab_size)[None, None, :]
    return torch.where(last % 2 == 1, (tok % 2 == 0) | (tok == 2), True)


def strategies(name):
    """(JAX strategy, port strategy, settings) of one case."""
    if name == "ordered_constraints":
        return (jax_ss.LexicallyConstrainedSearch(jax_ss.pack_constraints(PHRASES)),
                ss.LexicallyConstrainedSearch(ss.pack_constraints(PHRASES)), {})
    if name == "unordered_constraints":
        return (jax_ss.UnorderedLexicallyConstrainedSearch(
                    jax_ss.pack_constraint_phrases(PHRASES)),
                ss.UnorderedLexicallyConstrainedSearch(ss.pack_constraint_phrases(PHRASES)), {})
    if name == "prefix_constrained":
        return (jax_ss.PrefixConstrainedSearch(_prefix_allowed_jax),
                ss.PrefixConstrainedSearch(_prefix_allowed_port), {})
    if name == "diverse_siblings":
        return None, None, dict(diversity_rate=0.5)
    if name == "diverse_groups":
        return None, None, dict(diverse_beam_groups=2, diverse_beam_strength=0.5)
    if name == "diverse_groups_strong":
        return None, None, dict(diverse_beam_groups=4, diverse_beam_strength=2.0,
                                len_penalty=0.5)
    raise KeyError(name)


CASES = ["ordered_constraints", "unordered_constraints", "prefix_constrained",
         "diverse_siblings", "diverse_groups", "diverse_groups_strong"]


@pytest.mark.parametrize("case", CASES)
def test_search_matches_jax(models, case):
    jax_strategy, port_strategy, extra = strategies(case)
    common = dict(beam_size=BEAM, max_decode_len=MAX_LEN, min_len=2, len_penalty=1.0)
    common.update(extra)
    ref = JaxGenerator(JaxModel(TINY), JaxSettings(**common), strategy=jax_strategy
                       ).generate_audio(models["jax_params"], jnp.asarray(models["wav"]),
                                        jnp.asarray(models["mask"]))
    ref_tokens, ref_scores, ref_lens = map(np.asarray, ref)
    gen = SequenceGenerator(models["port"], GeneratorSettings(**common), strategy=port_strategy)
    tokens, scores, lens = gen.generate_audio(torch.from_numpy(models["wav"]),
                                              torch.from_numpy(models["mask"]))
    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(scores.numpy(), ref_scores, **TOL)
    # the search is not degenerate: the beams of a sentence differ
    assert len({tuple(t) for t in tokens.numpy().reshape(-1, MAX_LEN)}) > 3
    if case.endswith("_constraints"):
        finished = ref_scores > -1e6
        for b, phrases in enumerate(PHRASES):
            for k in range(BEAM):
                if finished[b, k]:
                    hyp = list(tokens[b, k, :int(lens[b, k])].numpy())
                    for p in phrases:
                        assert any(hyp[j:j + len(p)] == p for j in range(len(hyp))), (b, k, p)


def test_bank_stripe_pick_matches_jax():
    """The dynamic-beam-allocation order on seeded pools with score ties,
    dead candidates and several banks."""
    rng = np.random.default_rng(5)
    pool = rng.integers(-6, 0, size=(4, 15)).astype(np.float32)
    pool[rng.random((4, 15)) < 0.2] = -1e7
    banks = rng.integers(0, 4, size=(4, 15)).astype(np.int32)
    want = np.asarray(jax_ss._bank_stripe_pick(jnp.asarray(pool), jnp.asarray(banks), 8))
    got = ss._bank_stripe_pick(torch.from_numpy(pool), torch.from_numpy(banks), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packer", ["pack_constraints", "pack_constraint_phrases"])
@pytest.mark.parametrize("phrases", [PHRASES, [[[3, 4, 5]], [], [[6], [7], [8, 9]]], [[], []]],
                         ids=["two_each", "ragged", "empty"])
def test_packers_match_jax(packer, phrases):
    want = np.asarray(getattr(jax_ss, packer)(phrases, pad=1))
    got = getattr(ss, packer)(phrases, pad=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_unordered_advance_matches_jax():
    """One transition of the unordered constraint state for every (state,
    token) of a small table: continuing, falling off, starting, finishing."""
    phrases = [[[4, 5, 6], [7, 1, 1], [4, 9, 1]]]
    jax_s = jax_ss.UnorderedLexicallyConstrainedSearch(jnp.asarray(phrases, jnp.int32))
    port_s = ss.UnorderedLexicallyConstrainedSearch(torch.tensor(phrases, dtype=torch.int32))
    masks, curs, poss, toks = np.meshgrid([0, 1, 2, 5], [-1, 0, 2], [0, 1, 2], [4, 5, 6, 7, 9],
                                          indexing="ij")
    planes = [x.reshape(1, -1).astype(np.int32) for x in (masks, curs, poss, toks)]
    want = jax_s._advance(*(jnp.asarray(p) for p in planes))
    got = port_s._advance(*(torch.from_numpy(p).long() for p in planes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the port's plain beam search against the dynamic-Python oracle, on the
# golden decode's model and utterances (tests/test_generate_golden.py)

@pytest.fixture(scope="module")
def golden():
    torch.manual_seed(7)
    tref = TorchChimera(TINY).eval()
    with torch.no_grad():
        tref.decoder.embed_tokens.weight.mul_(4.0)
    rng = np.random.default_rng(11)
    wavs = [(rng.normal(size=int(n)) * 0.1).astype(np.float32)
            for n in rng.integers(350, 700, size=6)]
    rng = np.random.default_rng(21)
    srcs = [np.concatenate([rng.integers(4, TINY.src_vocab_size, size=int(n)), [2]])
            for n in rng.integers(3, 7, size=4)]
    expected = {"audio": [], "text": []}
    with torch.no_grad():
        mems = [("audio", tref.encode_audio(torch.tensor(w[None, :]),
                                            torch.zeros(1, len(w), dtype=torch.bool)))
                for w in wavs]
        mems += [("text", tref.encode_text(torch.tensor(s[None, :]))) for s in srcs]
        for branch, mem in mems:
            def lp(prefixes, mem=mem):
                logits = tref.decode(torch.tensor(prefixes),
                                     mem.repeat(prefixes.shape[0], 1, 1))[:, -1, :]
                return torch.log_softmax(logits.double(), -1).numpy()

            expected[branch].append(oracle_beam(lp, 3, 8, min_len=1, len_penalty=1.5))
    model = ChimeraInterlinguaModel(port_config(TINY), device="cpu")
    model.load_state_dict(import_interlingua_state_dict(tref.state_dict()), strict=True)
    return model.eval(), wavs, srcs, expected


@pytest.mark.parametrize("branch", ["audio", "text"])
def test_port_beam_search_matches_oracle(golden, branch):
    """Batched, mixed lengths padded to a common length (audio: 6 wavs;
    text: 4 source sentences): every beam's tokens equal the oracle's;
    scores within 1e-2 (2e-2 on text), fp32 vs the float64 oracle, as the
    JAX golden test holds them."""
    model, wavs, srcs, expected = golden
    gen = SequenceGenerator(model, GeneratorSettings(beam_size=3, max_decode_len=8,
                                                     len_penalty=1.5, min_len=1))
    if branch == "audio":
        T = max(len(w) for w in wavs)
        audio = np.zeros((len(wavs), T), np.float32)
        mask = np.ones((len(wavs), T), bool)
        for i, w in enumerate(wavs):
            audio[i, :len(w)] = w
            mask[i, :len(w)] = False
        tokens, scores, lens = gen.generate_audio(torch.from_numpy(audio),
                                                  torch.from_numpy(mask))
    else:
        src = np.full((len(srcs), max(len(x) for x in srcs)), 1, np.int64)
        for i, x in enumerate(srcs):
            src[i, :len(x)] = x
        tokens, scores, lens = gen.generate_text(torch.from_numpy(src))
    tol = 1e-2 if branch == "audio" else 2e-2
    for b, want in enumerate(expected[branch]):
        for k in range(3):
            want_tokens, want_score = want[k]
            np.testing.assert_array_equal(tokens[b, k, :int(lens[b, k])].numpy(), want_tokens,
                                          err_msg=f"{branch} {b} hypothesis {k}")
            assert abs(float(scores[b, k]) - want_score) < tol
