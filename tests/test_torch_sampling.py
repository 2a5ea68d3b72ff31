"""Sampling and retained dropout in the port, on the CPU.

The port's random draws cannot equal ``jax.random``'s, so parity is held
where it is defined: the top-k and top-p filters equal the JAX package's
value for value; sampling at top-k 1 (deterministic) equals the JAX
generator's sampling at top-k 1 token for token and is the greedy decode of
the model; the draws' frequencies fit the filtered softmax (chi-square at a
fixed seed); a seed repeats and another seed differs. Retained dropout at
rate 0 equals plain decoding, and its masks repeat with the seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from chimera_st_tpu.generation import sampling as jax_sampling
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu_torch.generation import sampling
from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel
from tests.test_interlingua_model import TINY
from tests.test_torch_models import flax_init, numpy_tree, port_config, port_model

MAX_LEN = 12


@pytest.fixture(scope="module")
def models():
    _, params = flax_init(TINY, seed=2)
    params = numpy_tree(jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * 3.0
        if "decoder" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path)
        else np.asarray(x), params))
    rng = np.random.default_rng(8)
    wav = rng.normal(size=(3, 4000)).astype(np.float32)
    mask = np.zeros((3, 4000), bool)
    mask[1, 2500:] = True
    mask[2, 3300:] = True
    return dict(params=params, jax_params=jax.tree_util.tree_map(jnp.asarray, params),
                port=port_model(TINY, params), wav=torch.from_numpy(wav),
                mask=torch.from_numpy(mask), wav_np=wav, mask_np=mask)


def _logprobs(seed, shape=(6, 40)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 2.0
    return np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("k", [1, 3, 10, 40])
def test_filter_topk_equals_jax(k):
    lp = _logprobs(k)
    want = np.asarray(jax_sampling._filter_topk(jnp.asarray(lp), k))
    got = sampling._filter_topk(torch.from_numpy(lp), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.05, 0.3, 0.75, 0.95])
def test_filter_topp_equals_jax(p):
    lp = _logprobs(int(p * 100))
    want = np.asarray(jax_sampling._filter_topp(jnp.asarray(lp), p))
    got = sampling._filter_topp(torch.from_numpy(lp), p).numpy()
    np.testing.assert_array_equal(got, want)
    # chained as the decode chains them
    want = np.asarray(jax_sampling._filter_topp(jax_sampling._filter_topk(jnp.asarray(lp), 12),
                                                p))
    got = sampling._filter_topp(sampling._filter_topk(torch.from_numpy(lp), 12), p).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p", [0.0, 0.8])
def test_draw_frequencies_fit_the_filtered_softmax(top_p):
    """60,000 draws of one row (top-k 6, then top-p) at a fixed seed: the
    counts of the kept tokens fit their renormalised probabilities (chi-square,
    p > 0.001) and no filtered-out token is ever drawn."""
    lp = torch.from_numpy(_logprobs(17, (1, 12)))
    filtered = sampling._filter_topp(sampling._filter_topk(lp, 6), top_p)
    kept = (filtered[0] > -1e6).numpy()
    n = 60_000
    draws = sampling.draw(filtered.expand(n, -1), torch.Generator().manual_seed(3)).numpy()
    counts = np.bincount(draws, minlength=12)
    assert counts[~kept].sum() == 0
    probs = torch.softmax(filtered[0].double(), -1).numpy()[kept]
    chi2, pvalue = stats.chisquare(counts[kept], probs / probs.sum() * n)
    assert pvalue > 1e-3, (chi2, pvalue, counts)


def test_topk_1_sampling_equals_jax_and_greedy(models):
    """Top-k 1: the one kept token is drawn whatever the draw, so the port's
    samples equal the JAX generator's (tokens, lengths; scores 1e-5), and
    each token is the argmax of the model's teacher-forced log-probs."""
    common = dict(beam_size=2, max_decode_len=MAX_LEN, min_len=3, len_penalty=1.0,
                  sampling=True, sampling_topk=1, seed=4)
    ref = JaxGenerator(JaxModel(TINY), JaxSettings(**common)).generate_audio(
        models["jax_params"], jnp.asarray(models["wav_np"]), jnp.asarray(models["mask_np"]))
    ref_tokens, ref_scores, ref_lens = map(np.asarray, ref)
    model = models["port"]
    tokens, scores, lens = SequenceGenerator(model, GeneratorSettings(**common)).generate_audio(
        models["wav"], models["mask"])
    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=1e-5, rtol=1e-5)
    with torch.inference_mode():
        enc, enc_mask = model.encode_audio(models["wav"], models["mask"])
        best = tokens[:, 0]
        prev = torch.cat([torch.full_like(best[:, :1], 2), best[:, :-1]], dim=1)
        lp = torch.log_softmax(model.decode(prev, enc, enc_mask), -1)
    for b in range(3):
        n = int(lens[b, 0])
        for t in range(n):
            row = lp[b, t].clone()
            row[1] = -1e9  # pad
            if t + 1 <= 3:
                row[2] = -1e9  # eos below min_len
            if t == n - 1 and int(best[b, t]) == 2 and t + 1 > MAX_LEN - 1:
                continue  # eos forced at the last step
            assert int(row.argmax()) == int(best[b, t]), (b, t)


def test_sampling_repeats_with_its_seed(models):
    """top-k 5 / top-p 0.9 sampling: one seed gives the same samples twice
    (and on a second call of the same generator object, the call's own
    stream); another seed gives other samples."""
    settings = dict(beam_size=4, max_decode_len=MAX_LEN, sampling=True, sampling_topk=5,
                    sampling_topp=0.9)

    def run(seed, calls=1):
        gen = SequenceGenerator(models["port"], GeneratorSettings(seed=seed, **settings))
        return [gen.generate_audio(models["wav"], models["mask"]) for _ in range(calls)]

    (a,), (b,) = run(11), run(11)
    (c,) = run(12)
    first, second = run(11, calls=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(first[0], a[0])
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(first[0], second[0])
    tokens, scores, lens = a
    assert tokens.shape == (3, 4, MAX_LEN)
    assert (scores[:, :-1] >= scores[:, 1:]).all()  # sorted best first
    assert len({tuple(t) for t in tokens.reshape(-1, MAX_LEN).tolist()}) > 4


def test_sampling_conflicts_raise(models):
    for extra in (dict(diversity_rate=0.5), dict(diverse_beam_groups=2),
                  dict(no_repeat_ngram_size=2)):
        with pytest.raises(ValueError, match="--sampling is mutually exclusive"):
            SequenceGenerator(models["port"], GeneratorSettings(sampling=True, **extra))
    with pytest.raises(NotImplementedError, match="--kv-cache-int8"):
        SequenceGenerator(models["port"], GeneratorSettings(sampling=True, kv_cache_int8=True))
    with pytest.raises(ValueError, match="mutually exclusive search modes"):
        SequenceGenerator(models["port"], GeneratorSettings(diversity_rate=0.5,
                                                            diverse_beam_groups=2))


def _dropout_model(params, rate, attention_rate=None):
    attention_rate = rate if attention_rate is None else attention_rate
    cfg = dataclasses.replace(
        port_config(TINY), dropout=rate, attention_dropout=attention_rate,
        activation_dropout=rate, w2v2_dropout=rate, w2v2_attention_dropout=attention_rate,
        w2v2_activation_dropout=rate)
    from chimera_st_tpu_torch.convert import params_from_flax

    model = ChimeraInterlinguaModel(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    return model.eval()


def test_retain_dropout_at_rate_0_equals_plain_decoding(models):
    settings = dict(beam_size=3, max_decode_len=MAX_LEN, min_len=2)
    model = _dropout_model(models["params"], 0.0)
    want = SequenceGenerator(model, GeneratorSettings(**settings)).generate_audio(
        models["wav"], models["mask"])
    got = SequenceGenerator(model, GeneratorSettings(retain_dropout=True, **settings)
                            ).generate_audio(models["wav"], models["mask"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not model.training  # back in eval mode


def test_retain_dropout_repeats_with_its_seed(models):
    """Dropout 0.3 everywhere: the same seed gives the same hypotheses and
    scores, another seed other ones, and both differ from plain decoding."""
    model = _dropout_model(models["params"], 0.3)
    settings = dict(beam_size=3, max_decode_len=MAX_LEN, min_len=2, retain_dropout=True)

    def run(seed):
        return SequenceGenerator(model, GeneratorSettings(seed=seed, **settings)).generate_audio(
            models["wav"], models["mask"])

    a, b, c = run(5), run(5), run(6)
    plain = SequenceGenerator(model, GeneratorSettings(beam_size=3, max_decode_len=MAX_LEN,
                                                       min_len=2)).generate_audio(
        models["wav"], models["mask"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], c[1]) and not torch.equal(a[1], plain[1])
    assert not torch.equal(a[0], c[0])
    assert not model.training


def test_retain_dropout_needs_a_model_with_dropout():
    from chimera_st_tpu_torch.models.s2t_transformer import build_s2t_transformer

    model = build_s2t_transformer("s2t_transformer_s", {
        "tgt_vocab_size": 12, "encoder_embed_dim": 16, "encoder_ffn_dim": 32,
        "encoder_layers": 1, "decoder_layers": 1, "decoder_embed_dim": 16,
        "decoder_ffn_dim": 32, "conv_channels": 8}, device="cpu")
    with pytest.raises(NotImplementedError, match="--retain-dropout"):
        SequenceGenerator(model, GeneratorSettings(retain_dropout=True))


# beam 1 and sampling: the JAX step's encoder K/V batch equals its query batch,
# so its cross-attention takes the dropping branch; beam 3 takes the grouped one
RETAIN_MODES = {
    "beam3": dict(beam_size=3, min_len=2),
    "beam1": dict(beam_size=1, min_len=2),
    "sampling": dict(beam_size=2, min_len=2, sampling=True, sampling_topk=1),
}


def _routes(monkeypatch):
    """Counts the calls of the K1 and K3 wrappers from the model's layers."""
    from chimera_st_tpu_torch.models import layers

    calls = {"encoder_attention": 0, "decode_attention": 0}
    for name in calls:
        real = getattr(layers, name)

        def counted(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(layers, name, counted)
    return calls


@pytest.mark.parametrize("mode", ["beam1", "sampling"])
def test_retain_dropout_at_beam_1_and_sampling(models, monkeypatch, mode):
    """Beam 1 and sampling (top-k 1): retained dropout at rate 0 gives the
    plain decode's results through the same K1 and K3 calls; at rate 0.3 a
    seed repeats, another seed differs, and both differ from plain."""
    settings = dict(max_decode_len=MAX_LEN, **RETAIN_MODES[mode])
    calls = _routes(monkeypatch)

    def run(model, **extra):
        before = dict(calls)
        out = SequenceGenerator(model, GeneratorSettings(**settings, **extra)).generate_audio(
            models["wav"], models["mask"])
        return out, {k: calls[k] - before[k] for k in calls}

    model = _dropout_model(models["params"], 0.0)
    (want, plain_calls), (got, kept_calls) = run(model), run(model, retain_dropout=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kept_calls == plain_calls and all(plain_calls.values())
    model = _dropout_model(models["params"], 0.3)
    (a, _), (b, _), (c, _) = (run(model, retain_dropout=True, seed=s) for s in (5, 5, 6))
    plain, _ = run(model)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], c[1]) and not torch.equal(a[1], plain[1])
    assert not model.training


@pytest.mark.parametrize("mode, drops", [("beam3", False), ("beam1", True), ("sampling", True)])
def test_retained_cross_attention_dropout_follows_jax(models, mode, drops):
    """Only attention dropout (0.5), the decode in training mode from a
    fixed encoder output: the step drops cross-attention probabilities at
    beam 1 and in sampling, as the JAX step's ungrouped branch, and nothing
    in grouped beam search (the cached self-attention never drops)."""
    from chimera_st_tpu_torch.generation.generator import dropout_mode, seeded_generator

    model = _dropout_model(models["params"], 0.0, attention_rate=0.5)
    settings = GeneratorSettings(max_decode_len=MAX_LEN, **RETAIN_MODES[mode])
    gen = SequenceGenerator(model, settings)
    with torch.inference_mode():
        enc = model.encode_audio(models["wav"], models["mask"])

    def decode(**kw):
        if settings.sampling:
            kw["sample_generator"] = seeded_generator(4, 1, "cpu")
        return gen.generate_from_encoder(*enc, **kw)

    plain = decode()
    with dropout_mode(model, True):
        kept = decode(dropout_generator=seeded_generator(5, 1, "cpu", stream=1))
    assert (not torch.equal(kept[1], plain[1])) == drops
