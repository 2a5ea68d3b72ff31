"""The port's non-autoregressive models (``models/nat_*.py``, ``crf.py``)
against the JAX package on the CPU: for each of the six models the training
forward and the decode (CMLM mask-predict with and without a length beam,
the vanilla / iterative NAT's translate and length beam, the NAT-CRF's
Viterbi, Levenshtein and insertion refinement with the eos penalty, forced
rounds and history), the CRF's log-likelihood and Viterbi, the iterative
NAT's corruption driven by the keep-masks JAX drew, the edit operators on
hand-made canvases, and the bidirectional decoder at a canvas of 4, below
the JAX gate of K1 (the port runs K1 there).

Weights: a flax init's tree, every leaf a seeded numpy draw
(``test_torch_transformer.seeded_tree``), carried across by ``convert.py``.
Widths: 2 + 2 layers, 32 wide, 4 heads, vocabularies 23 / 29, canvases of
16. Tolerances: fp32 1e-5 (absolute and relative); tokens, lengths and
step counts identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.models import crf as jax_crf
from chimera_st_tpu.models import nat_cmlm as jax_cmlm
from chimera_st_tpu.models import nat_insertion as jax_ins
from chimera_st_tpu.models import nat_levenshtein as jax_lev
from chimera_st_tpu.models import nat_vanilla as jax_nat
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.config.registry import ARCHITECTURES, MODELS
from chimera_st_tpu_torch.models import NAT_ARCHITECTURES, crf, layers, nat_levenshtein
from tests.test_torch_transformer import seeded_tree

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(src_vocab_size=23, tgt_vocab_size=29, encoder_embed_dim=32, encoder_ffn_dim=64,
             encoder_layers=2, encoder_heads=4, decoder_embed_dim=32, decoder_ffn_dim=64,
             decoder_layers=2, decoder_heads=4, dropout=0.0)
L = 16
SRC = np.array([[4, 5, 6, 7, 8, 9, 2, 1], [10, 11, 2, 1, 1, 1, 1, 1],
                [12, 13, 14, 15, 16, 2, 1, 1]], np.int32)
# a canvas of each kind: bos / eos framed with pads inside the batch
CANVAS = np.array([[0, 3, 3, 3, 3, 2, 1, 1, 1, 1], [0, 7, 3, 9, 2, 1, 1, 1, 1, 1],
                   [0, 3, 3, 3, 3, 3, 3, 3, 3, 2]], np.int32)
TARGET = np.array([[0, 5, 6, 7, 8, 2, 1, 1, 1, 1], [0, 7, 8, 9, 2, 1, 1, 1, 1, 1],
                   [0, 4, 5, 6, 7, 8, 9, 10, 11, 2]], np.int32)

# name (the port's model and converter table) -> (JAX class, JAX config)
MODELS_UNDER_TEST = {
    "cmlm_transformer": (jax_cmlm.CMLMTransformer,
                         jax_cmlm.CMLMConfig(**SMALL, max_predicted_length=20)),
    "nonautoregressive_transformer": (jax_nat.NATransformer,
                                      jax_nat.NATConfig(**SMALL, max_predicted_length=20)),
    "iterative_nonautoregressive_transformer": (
        jax_nat.NATransformer, jax_nat.NATConfig(**SMALL, max_predicted_length=20,
                                                 train_steps=3)),
    "nacrf_transformer": (jax_nat.NATransformer,
                          jax_nat.NATConfig(**SMALL, max_predicted_length=20, crf_lowrank=4,
                                            crf_beam=8)),
    "levenshtein_transformer": (jax_lev.LevenshteinTransformer,
                                jax_lev.LevenshteinConfig(**SMALL, max_ins=8)),
    "insertion_transformer": (jax_ins.InsertionTransformer, jax_ins.InsertionConfig(**SMALL)),
}


def jax_init(name, seed=0):
    cls, cfg = MODELS_UNDER_TEST[name]
    model = cls(cfg)
    src, canvas = jnp.asarray(SRC), jnp.asarray(CANVAS)
    key = jax.random.PRNGKey(0)
    # jitted: one compile instead of one per operation of an eager init
    if cls is jax_nat.NATransformer:
        params = jax.jit(lambda k: model.init(k, src, canvas, method=cls.init_everything))(key)
    elif cls is jax_lev.LevenshteinTransformer:
        params = jax.jit(lambda k: model.init(k, src, canvas, canvas, canvas))(key)
    else:
        params = jax.jit(lambda k: model.init(k, src, canvas))(key)
    return model, seeded_tree(params, seed)


def japply(jm, params, *args, method=None, **kw):
    """``jm.apply`` jitted: one compile instead of one per operation."""
    return jax.jit(lambda p: jm.apply(p, *args, method=method, **kw))(params)


def port_model(name, jax_model, params):
    port = MODELS.get(name)(dataclasses.asdict(jax_model.cfg), device="cpu").eval()
    assert convert.model_kind(port) == name
    port.load_state_dict(convert.params_from_flax(params, name), strict=True)
    return port


@pytest.fixture(scope="module", params=sorted(MODELS_UNDER_TEST))
def pair(request):
    jm, params = jax_init(request.param)
    return request.param, jm, jax.tree_util.tree_map(jnp.asarray, params), \
        port_model(request.param, jm, params)


def t(a):
    return torch.from_numpy(np.asarray(a)).long()


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_training_forward_matches_jax(pair):
    name, jm, params, model = pair
    cls = type(jm)
    src, canvas = jnp.asarray(SRC), jnp.asarray(CANVAS)
    with torch.no_grad():
        if name == "levenshtein_transformer":
            want = japply(jm, params, src, canvas, jnp.asarray(TARGET), canvas)
            got = model(t(SRC), t(CANVAS), t(TARGET), t(CANVAS))
        elif name == "nacrf_transformer":
            want = japply(jm, params, src, canvas, jnp.asarray(TARGET),
                          method=cls.crf_loglikelihood)
            got = model.crf_loglikelihood(t(SRC), t(CANVAS), t(TARGET))
        elif name == "iterative_nonautoregressive_transformer":
            # the keep-masks JAX drew: fold_in(key, s) of its step s
            key = jax.random.PRNGKey(5)
            want = japply(jm, params, src, canvas, key, method=cls.forward_iterative)
            masks = [torch.from_numpy(np.asarray(jax.random.bernoulli(
                jax.random.fold_in(key, s), jm.cfg.dae_ratio, CANVAS.shape))) for s in range(2)]
            got = model.forward_iterative(t(SRC), t(CANVAS), keep_masks=masks)
            assert got[0].shape == (3, *CANVAS.shape, 29)
        elif name == "insertion_transformer":
            want, got = (japply(jm, params, src, canvas),), (model(t(SRC), t(CANVAS)),)
        else:
            want, got = japply(jm, params, src, canvas), model(t(SRC), t(CANVAS))
    for g, w in zip(got, want):
        close(g, w)


def _decode_cases(name):
    """(JAX method name, keyword arguments) of each decode of the model."""
    if name == "cmlm_transformer":
        return [("mask_predict", dict(iterations=4, max_len=L, return_history=True)),
                ("mask_predict_with_length_beam", dict(beam=3, iterations=3, max_len=L))]
    if name == "levenshtein_transformer":
        return [("refine", dict(iterations=5, max_len=L, eos_penalty=1.5)),
                ("refine", dict(iterations=5, max_len=L, eos_penalty=0.5,
                                return_history=True))]
    if name == "insertion_transformer":
        return [("refine", dict(iterations=6, max_len=L, return_history=True))]
    return [("translate", dict(max_len=L, iterations=2, return_history=True)),
            ("translate_with_length_beam", dict(beam=3, max_len=L, iterations=2,
                                                return_candidates=True))]


def test_decode_matches_jax(pair):
    """Tokens, lengths, history and step counts identical; the length-beam
    candidates' scores within 1e-5."""
    name, jm, params, model = pair
    for method, kw in _decode_cases(name):
        want = japply(jm, params, jnp.asarray(SRC), method=getattr(type(jm), method), **kw)
        with torch.no_grad():
            got = getattr(model, method)(t(SRC), **kw)
        assert len(got) == len(want), (method, kw)
        for g, w in zip(got, want):
            if w.dtype == jnp.float32:
                close(g, w)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{method} {kw}")


def test_refinement_stops_early_unless_forced(monkeypatch):
    """The host's "any canvas changed" read ends Levenshtein refinement
    after the first round without change; forced, every round runs; the
    tokens agree either way."""
    jm, params = jax_init("levenshtein_transformer", seed=2)
    model = port_model("levenshtein_transformer", jm, params)
    rounds, real = [], nat_levenshtein.refine_rounds

    def noted(*args, **kwargs):
        out = real(*args, **kwargs)
        rounds.append(out[3])
        return out

    monkeypatch.setattr(nat_levenshtein, "refine_rounds", noted)
    with torch.no_grad():
        free = model.refine(t(SRC), iterations=12, max_len=L, return_history=True)
        forced = model.refine(t(SRC), iterations=12, max_len=L, force_iterations=True)
    assert rounds[1] == 12
    assert rounds[0] == min(12, int(free[3].max()) + 1) < 12
    np.testing.assert_array_equal(free[0].numpy(), forced[0].numpy())


def test_crf_loglikelihood_and_viterbi_match_jax():
    """``DynamicCRF`` alone on seeded emissions, with a beam that does and
    one that does not cover the vocabulary; a padded tail is carried."""
    rng = np.random.default_rng(3)
    V, R = 12, 4
    emissions = rng.normal(size=(3, 7, V)).astype(np.float32) * 2
    targets = rng.integers(0, V, size=(3, 7)).astype(np.int32)
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = mask[2, 6:] = False
    for beam in (5, 12):
        jm = jax_crf.DynamicCRF(V, low_rank=R, beam=beam)
        params = seeded_tree({"params": {
            "E1": np.zeros((V, R), np.float32), "E2": np.zeros((V, R), np.float32)}}, 4)
        port = crf.DynamicCRF(V, R, beam, device="cpu")
        port.load_state_dict({k: torch.from_numpy(v) for k, v in params["params"].items()})
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        want = japply(jm, jp, jnp.asarray(emissions), jnp.asarray(targets), jnp.asarray(mask),
                      method=jax_crf.DynamicCRF.loglikelihood)
        close(port.loglikelihood(torch.from_numpy(emissions), t(targets),
                                 torch.from_numpy(mask)), want)
        want = japply(jm, jp, jnp.asarray(emissions), jnp.asarray(mask),
                      method=jax_crf.DynamicCRF.decode)
        got = port.decode(torch.from_numpy(emissions), torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["delete", "insert", "insert_capped"])
def test_edit_operators_on_hand_made_canvases(case):
    """``apply_del_words`` / ``apply_ins_placeholders`` against JAX and
    against the expected canvas: bos / eos survive deletion, pads count as
    deleted, insertions past the width are capped."""
    tokens = np.array([[0, 5, 6, 7, 2, 1, 1, 1], [0, 8, 2, 1, 1, 1, 1, 1],
                       [0, 4, 5, 6, 7, 8, 9, 2]], np.int32)
    if case == "delete":
        pred = np.zeros(tokens.shape, bool)
        pred[0, [0, 2, 4, 6]] = pred[1, 1] = pred[2, 3:6] = True
        want = jax_lev.apply_del_words(jnp.asarray(tokens), jnp.asarray(pred))
        got = nat_levenshtein.apply_del_words(t(tokens), torch.from_numpy(pred))
        expect = [[0, 5, 7, 2, 1, 1, 1, 1], [0, 2, 1, 1, 1, 1, 1, 1], [0, 4, 5, 9, 2, 1, 1, 1]]
    else:
        ins = np.zeros((3, 7), np.int32)
        ins[0, 0], ins[0, 2], ins[1, 0] = 2, 1, 1
        ins[2, 0] = 3 if case == "insert_capped" else 0
        want = jax_lev.apply_ins_placeholders(jnp.asarray(tokens), jnp.asarray(ins))
        got = nat_levenshtein.apply_ins_placeholders(t(tokens), t(ins))
        expect = [[0, 3, 3, 5, 6, 3, 7, 2], [0, 3, 8, 2, 1, 1, 1, 1], [0, 4, 5, 6, 7, 8, 9, 2]]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_bidirectional_decoder_below_the_jax_k1_gate(monkeypatch):
    """A canvas of 4: the JAX gate sends T < 8 to its XLA path; the port
    sends every non-causal self-attention of the decoder to K1 (here its
    plain version, 2 layers), with the same outputs."""
    jm, params = jax_init("cmlm_transformer", seed=6)
    model = port_model("cmlm_transformer", jm, params)
    calls = []
    real = layers.encoder_attention

    def counted(q, k, v, mask=None):
        calls.append(q.shape)
        return real(q, k, v, mask)

    monkeypatch.setattr(layers, "encoder_attention", counted)
    canvas = np.array([[3, 3, 3, 1], [3, 3, 1, 1], [3, 3, 3, 3]], np.int32)
    want = japply(jm, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(SRC),
                  jnp.asarray(canvas))
    with torch.no_grad():
        got = model(t(SRC), t(canvas))
    close(got[0], want[0])
    assert [s[1] for s in calls] == [8, 8, 4, 4]  # encoder layers, then the decoder's
    with pytest.raises(ValueError, match="no incremental decode step"):
        model.backbone.decoder.step(t(canvas[:, :1]), 0, [], None, None, None, 1)


@pytest.mark.parametrize("arch", sorted(NAT_ARCHITECTURES))
def test_preset_matches_jax(arch):
    """Each of the 12 architecture names: the same model name and the same
    defaults."""
    from chimera_st_tpu.config.registry import ARCHITECTURES as JAX_ARCHITECTURES

    jax_model, jax_preset = JAX_ARCHITECTURES.get(arch)
    model, preset = ARCHITECTURES.get(arch)
    assert model == jax_model
    given = {"dropout": 0.25, "arch": arch}
    assert preset(dict(given)) == jax_preset(dict(given))
    assert preset({}) == jax_preset({})
    assert len(NAT_ARCHITECTURES) == 12
