"""The port's ensemble, reference scorer, alignments, unknown-word
replacement and int8 KV cache against the JAX package's, on the CPU: the
``TINY`` model with weights carried over by ``convert.py``, fp32. Tokens and
lengths exactly, scores and weights within 1e-5 (plus 1e-5 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.generation.ensemble import EnsembleSequenceGenerator as JaxEnsemble
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.generation.scorer import SequenceScorer as JaxScorer
from chimera_st_tpu.generation.unk_replace import load_align_dict as jax_load_align_dict
from chimera_st_tpu.generation.unk_replace import replace_unk_tokens as jax_replace_unk
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu_torch.generation.ensemble import EnsembleSequenceGenerator
from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
from chimera_st_tpu_torch.generation.scorer import SequenceScorer
from chimera_st_tpu_torch.generation.unk_replace import load_align_dict, replace_unk_tokens
from chimera_st_tpu_torch.models.layers import int8_cached_attention, quantize_rows
from tests.test_interlingua_model import TINY
from tests.test_torch_models import flax_init, numpy_tree, port_model

TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 12


def _sharpened(params, scale, jitter_seed=None):
    """Decoder kernels x ``scale``; with ``jitter_seed`` every leaf also
    times (1 + 0.3 N(0, 1)) from a numpy seed (a second model without a
    second flax init)."""
    rng = None if jitter_seed is None else np.random.default_rng(jitter_seed)

    def leaf(path, x):
        x = np.asarray(x)
        if "decoder" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path):
            x = x * scale
        if rng is not None:
            x = (x * (1.0 + 0.3 * rng.normal(size=x.shape))).astype(x.dtype)
        return x

    return numpy_tree(jax.tree_util.tree_map_with_path(leaf, params))


@pytest.fixture(scope="module")
def models():
    _, base = flax_init(TINY, seed=1)
    params = [_sharpened(base, 4.0), _sharpened(base, 3.0, jitter_seed=6)]
    rng = np.random.default_rng(9)
    wav = rng.normal(size=(3, 4000)).astype(np.float32)
    mask = np.zeros((3, 4000), bool)
    mask[1, 2700:] = True
    mask[2, 3300:] = True
    return dict(params=params, jax=[jax.tree_util.tree_map(jnp.asarray, p) for p in params],
                port=[port_model(TINY, p) for p in params], wav=wav, mask=mask,
                src=np.array([[5, 9, 4, 7, 2, 1], [11, 6, 2, 1, 1, 1], [8, 13, 12, 10, 4, 2]],
                             np.int32),
                target=np.array([[6, 9, 3, 2, 1], [4, 2, 1, 1, 1], [7, 3, 3, 12, 2]], np.int32))


def _assert_same(got, want):
    tokens, scores, lens = got
    want_tokens, want_scores, want_lens = map(np.asarray, want)
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_allclose(scores.numpy(), want_scores, **TOL)


@pytest.mark.parametrize("branch", ["audio", "text"])
def test_two_model_ensemble_matches_jax(models, branch):
    common = dict(beam_size=3, max_decode_len=MAX_LEN, min_len=2, len_penalty=1.2,
                  temperature=0.8, max_len_a=0.002, max_len_b=2)
    jax_ens = JaxEnsemble([JaxModel(TINY), JaxModel(TINY)], models["jax"], JaxSettings(**common))
    ens = EnsembleSequenceGenerator(models["port"], GeneratorSettings(**common))
    if branch == "audio":
        lengths = np.array([4000, 2700, 3300])
        want = jax_ens.generate_audio(jnp.asarray(models["wav"]), jnp.asarray(models["mask"]),
                                      jnp.asarray(lengths))
        got = ens.generate_audio(torch.from_numpy(models["wav"]),
                                 torch.from_numpy(models["mask"]), torch.from_numpy(lengths))
    else:
        lengths = np.array([5, 3, 6])
        want = jax_ens.generate_text(jnp.asarray(models["src"]), jnp.asarray(lengths))
        got = ens.generate_text(torch.from_numpy(models["src"]).long(),
                                torch.from_numpy(lengths))
    _assert_same(got, want)
    # the ensemble is neither of its members
    single = SequenceGenerator(models["port"][0], GeneratorSettings(**common))
    alone = (single.generate_audio(torch.from_numpy(models["wav"]),
                                   torch.from_numpy(models["mask"]), torch.from_numpy(lengths))
             if branch == "audio" else
             single.generate_text(torch.from_numpy(models["src"]).long(),
                                  torch.from_numpy(lengths)))
    assert not torch.equal(alone[1], got[1])


def test_ensemble_refuses_single_model_options(models):
    for extra, match in ((dict(kv_cache_int8=True), "--kv-cache-int8"),
                         (dict(sampling=True), "--sampling"),
                         (dict(diverse_beam_groups=2), "--diverse-beam-groups"),
                         (dict(diversity_rate=0.5), "--diversity-rate"),
                         (dict(retain_dropout=True), "--retain-dropout")):
        with pytest.raises(NotImplementedError, match=match):
            EnsembleSequenceGenerator(models["port"], GeneratorSettings(**extra))


@pytest.mark.parametrize("branch", ["audio", "text"])
def test_sequence_scorer_matches_jax(models, branch):
    scorer = JaxScorer(JaxModel(TINY))
    port = SequenceScorer(models["port"][0])
    target = models["target"]
    if branch == "audio":
        want = scorer.score_audio(models["jax"][0], jnp.asarray(models["wav"]),
                                  jnp.asarray(models["mask"]), jnp.asarray(target))
        got = port.score_audio(torch.from_numpy(models["wav"]), torch.from_numpy(models["mask"]),
                               torch.from_numpy(target).long())
    else:
        want = scorer.score_text(models["jax"][0], jnp.asarray(models["src"]),
                                 jnp.asarray(target))
        got = port.score_text(torch.from_numpy(models["src"]).long(),
                              torch.from_numpy(target).long())
    assert sorted(got) == sorted(want)
    for key in ("positional_scores", "score", "total_logprob"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))


def test_scorer_retain_dropout_repeats_with_its_seed(models):
    from tests.test_torch_sampling import _dropout_model

    model = _dropout_model(models["params"][0], 0.3)
    target = torch.from_numpy(models["target"]).long()
    src = torch.from_numpy(models["src"]).long()
    a = SequenceScorer(model, retain_dropout=True, seed=3).score_text(src, target)
    b = SequenceScorer(model, retain_dropout=True, seed=3).score_text(src, target)
    c = SequenceScorer(model, retain_dropout=True, seed=4).score_text(src, target)
    plain = SequenceScorer(model).score_text(src, target)
    assert torch.equal(a["score"], b["score"])
    assert not torch.equal(a["score"], c["score"]) and not torch.equal(a["score"], plain["score"])


def test_cross_attention_weights_match_jax(models):
    jm = JaxModel(TINY)
    enc, enc_mask = jm.apply(models["jax"][0], jnp.asarray(models["src"]),
                             method=JaxModel.encode_text)
    prev = np.concatenate([np.full((3, 1), 2, np.int32), models["target"][:, :-1]], axis=1)
    want = jm.apply(models["jax"][0], jnp.asarray(prev), enc, enc_mask,
                    method=lambda m, t, e, em: m.decoder.cross_attention_weights(t, e, em))
    model = models["port"][0]
    with torch.inference_mode():
        penc, pmask = model.encode_text(torch.from_numpy(models["src"]).long())
        got = model.decoder.cross_attention_weights(torch.from_numpy(prev).long(), penc, pmask)
    # the memory bank: interlingua_length slots
    assert got.shape == want.shape == (3, 5, TINY.interlingua_length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the audio path's memory bank has no mask
    enc, _ = jm.apply(models["jax"][0], jnp.asarray(models["wav"]), jnp.asarray(models["mask"]),
                      method=JaxModel.encode_audio)
    want = jm.apply(models["jax"][0], jnp.asarray(prev), enc, None,
                    method=lambda m, t, e, em: m.decoder.cross_attention_weights(t, e, em))
    with torch.inference_mode():
        penc, _ = model.encode_audio(torch.from_numpy(models["wav"]),
                                     torch.from_numpy(models["mask"]))
        got = model.decoder.cross_attention_weights(torch.from_numpy(prev).long(), penc, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_replace_unk_tokens_equals_jax(tmp_path):
    (tmp_path / "lex.txt").write_text("haus house\nhund dog\nbad\n")
    for path in (None, True, str(tmp_path / "lex.txt")):
        assert load_align_dict(path) == jax_load_align_dict(path)
    table = load_align_dict(str(tmp_path / "lex.txt"))
    cases = [
        (["<unk>", "the", "<unk>", "runs"], ["der", "hund", "haus"], [1, 0, 2, 9]),
        (["a", "<unk>"], ["katze"], [0, 5]),
        (["<unk>", "<unk>", "<unk>"], ["baum", "auto"], [1]),
        (["<unk>"], [], [0]),
    ]
    for hyp, src, align in cases:
        for lexicon in ({}, table):
            assert replace_unk_tokens(hyp, src, align, lexicon, "<unk>") == \
                jax_replace_unk(hyp, src, align, lexicon, "<unk>")


def test_int8_rows_round_half_to_even_as_jax():
    """Rows with values exactly at .5 steps of their scale round to even in
    both packages."""
    x = np.array([[[127.0, 0.5, 1.5, -2.5, 3.5, -0.5, 2.49, 60.5]]], np.float32)
    q, s = quantize_rows(torch.from_numpy(x))
    r = x.astype(np.float32)
    js = np.maximum(np.abs(r).max(axis=(1, 2)), 1e-8) / np.float32(127.0)
    jq = np.asarray(jnp.round(jnp.asarray(r) / jnp.asarray(js)[:, None, None]).astype(jnp.int8))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js.astype(np.float32))
    assert q.numpy().tolist()[0][0][1:6] == [0, 2, -2, 4, 0]


def test_int8_cache_attention_close_to_full_precision():
    """One step over a random int8 cache at a random ancestry against the
    fp32 plain attention over the dequantised cache."""
    from chimera_st_tpu_torch.ops.decode_attention import decode_attention_plain

    g = torch.Generator().manual_seed(0)
    N, H, L, D, beam, idx = 6, 2, 9, 8, 3, 6
    q, k_new, v_new = (torch.randn(N, H, D, generator=g) for _ in range(3))
    kf, vf = torch.randn(N, H, L, D, generator=g), torch.randn(N, H, L, D, generator=g)
    anc = torch.randint(0, beam, (L + 1, N), generator=g, dtype=torch.int32)
    kq, ks = zip(*(quantize_rows(kf[:, :, t]) for t in range(L)))
    vq, vs = zip(*(quantize_rows(vf[:, :, t]) for t in range(L)))
    k8, v8 = torch.stack(kq, 2), torch.stack(vq, 2)
    k_s, v_s = torch.stack(ks, 1), torch.stack(vs, 1)
    out = int8_cached_attention(q, k_new, v_new, k8, v8, k_s, v_s, anc, idx, beam)
    kd, vd = k8.float() * k_s[:, None, :, None], v8.float() * v_s[:, None, :, None]
    ref = decode_attention_plain(q, k_new, v_new, kd, vd, anc, idx, beam)
    assert float((out - ref).abs().max()) < 0.05
    assert k8.dtype == torch.int8 and int(k8[:, :, idx].abs().max()) == 127


@pytest.mark.parametrize("branch", ["audio", "text"])
def test_int8_kv_cache_matches_jax(models, branch):
    common = dict(beam_size=3, max_decode_len=MAX_LEN, min_len=2, len_penalty=1.0,
                  kv_cache_int8=True)
    jax_gen = JaxGenerator(JaxModel(TINY), JaxSettings(**common))
    gen = SequenceGenerator(models["port"][0], GeneratorSettings(**common))
    if branch == "audio":
        want = jax_gen.generate_audio(models["jax"][0], jnp.asarray(models["wav"]),
                                      jnp.asarray(models["mask"]))
        got = gen.generate_audio(torch.from_numpy(models["wav"]),
                                 torch.from_numpy(models["mask"]))
    else:
        want = jax_gen.generate_text(models["jax"][0], jnp.asarray(models["src"]))
        got = gen.generate_text(torch.from_numpy(models["src"]).long())
    _assert_same(got, want)
