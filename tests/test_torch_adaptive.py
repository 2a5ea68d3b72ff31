"""The port's adaptive softmax, character embedder and ``adaptive_loss``
against the JAX package on the CPU: ``AdaptiveSoftmax.log_prob`` / ``nll``
through ``TransformerLM``, the spelling table and ``CharacterTokenEmbedder``,
two Adam updates of a tiny ``transformer_lm_wiki103`` (``adaptive_loss``)
and of a character-input LM (``lm_cross_entropy``) from the same weights,
``eval_lm``'s perplexity and a JAX-written wiki103 ``.ckpt``; and the fused
decode of an adaptive LM, where the port adds the adaptive softmax's
log-probabilities and the JAX package the tied projection's (ROADMAP C).

Widths: 2 layers, 32 wide, 4 heads, cutoffs (8, 16) over a 29-word
dictionary; weights are seeded numpy draws over a flax init's tree.
Tolerances (fp32): outputs 1e-5; the updates as ``tests/test_torch_mt.py``
holds them (losses 1e-5 relative, parameters 1e-4 of the learning rate plus
two fp32 roundings); the CLI's printed loss identical to its 4 decimals."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import save_state as jax_save_state
from chimera_st_tpu.cli import eval_lm as jax_eval_lm
import chimera_st_tpu.criterions  # noqa: F401 — registration
from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.models.character_embedder import build_word_to_char as jax_word_to_char
from chimera_st_tpu.optim import build_lr_schedule as jax_schedule
from chimera_st_tpu.optim import build_optimizer as jax_optimizer
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.cli import eval_lm, generate, preprocess
from chimera_st_tpu_torch.generation import ensemble
from chimera_st_tpu_torch.generation.ensemble import EnsembleSequenceGenerator
from chimera_st_tpu_torch.generation.generator import GeneratorSettings
from chimera_st_tpu_torch.models.character_embedder import build_word_to_char
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.tasks import setup_task
from chimera_st_tpu_torch.train import TrainStep
from tests.test_torch_transformer import PREV, SMALL, SRC, port_mt_model, seeded_tree

TOL = dict(atol=1e-5, rtol=1e-5)
WIDTHS = dict(embed_dim=32, ffn_dim=64, layers=2, heads=4, dropout=0.0, attention_dropout=0.0,
              activation_dropout=0.0)
CUTOFFS = (8, 16)
MODELS = {
    "wiki103": {"arch": "transformer_lm_wiki103", "adaptive_softmax_cutoffs": CUTOFFS},
    "char": {"arch": "transformer_lm", "character_embeddings": True,
             "character_filters": ((1, 8), (2, 16), (3, 8)), "max_char_len": 12},
    "char_adaptive": {"arch": "transformer_lm", "character_embeddings": True,
                      "character_filters": ((1, 8), (2, 8)), "max_char_len": 12,
                      "adaptive_softmax_cutoffs": CUTOFFS},
}


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    """A binarized monolingual corpus over 25 words (the port's preprocess
    --only-source) and both packages' language-modeling tasks on it."""
    root = tmp_path_factory.mktemp("lm")
    rng = np.random.default_rng(11)
    for split, n in (("train", 20), ("test", 30)):
        rows = [" ".join(f"w{i}" for i in rng.zipf(1.5, size=int(rng.integers(3, 15))) % 25)
                for _ in range(n)]
        (root / f"{split}.txt").write_text("\n".join(rows) + "\n")
    preprocess.main(["--only-source", "--trainpref", str(root / "train.txt"), "--testpref",
                     str(root / "test.txt"), "--destdir", str(root / "bin")])
    cfg = {"_name": "language_modeling", "data": str(root / "bin"), "tokens_per_sample": 12}
    return dict(bin=root / "bin", jax=jax_setup_task(dict(cfg)), port=setup_task(dict(cfg)))


def _models(lm_data, name, seed=3):
    """(JAX model, seeded flax tree, port model with those weights) of
    MODELS[name], built by each package's task."""
    cfg = dict(MODELS[name], **WIDTHS)
    jm = lm_data["jax"].build_model(dict(cfg))
    tokens = jnp.asarray(PREV % len(lm_data["port"].target_dictionary))
    params = seeded_tree(jm.init(jax.random.PRNGKey(0), tokens), seed)
    model = lm_data["port"].build_model(dict(cfg), device="cpu", train=True)
    model.load_state_dict(convert.params_from_flax(params, convert.model_kind(model)),
                          strict=True)
    return jm, params, model


def _batch(task, n=4):
    return next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=n)
                     .next_epoch_itr(shuffle=False)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_nll_match_jax(lm_data, name):
    """The LM's output (log-probabilities where it has an adaptive softmax:
    each row sums to 1) and the clustered NLL of every target."""
    jm, params, model = _models(lm_data, name)
    model.eval()
    batch = _batch(lm_data["port"])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jm.apply(jp, jnp.asarray(batch["net_tokens"])))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["net_tokens"]).long())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if model.adaptive_softmax is None:
        return
    np.testing.assert_allclose(torch.logsumexp(got, -1).numpy(), 0.0, atol=1e-5)
    assert model.adaptive_softmax.bounds == CUTOFFS + (len(lm_data["port"].target_dictionary),)
    want_nll = np.asarray(jm.apply(jp, jnp.asarray(batch["net_tokens"]),
                                   jnp.asarray(batch["target"]),
                                   method=jax_mt.TransformerLM.adaptive_nll))
    with torch.no_grad():
        got_nll = model.adaptive_nll(torch.from_numpy(batch["net_tokens"]).long(),
                                     torch.from_numpy(batch["target"]).long())
    np.testing.assert_allclose(got_nll.numpy(), want_nll, **TOL)
    # every cluster has targets here, and the NLL is -log_prob at the target
    tgt = torch.from_numpy(batch["target"]).long()
    assert {0, 1, 2} <= set(np.digitize(batch["target"].ravel(), CUTOFFS).tolist())
    np.testing.assert_allclose(got_nll.numpy(),
                               -got.gather(-1, tgt[..., None])[..., 0].numpy(), **TOL)


def test_spelling_table_matches_jax(lm_data):
    d = lm_data["port"].target_dictionary
    for max_len in (3, 12):
        np.testing.assert_array_equal(build_word_to_char(d, max_len),
                                      jax_word_to_char(lm_data["jax"].target_dictionary,
                                                       max_len))
    table = build_word_to_char(d, 12)
    assert not table[: d.nspecial].any() and table[d.nspecial:, 0].all()


@pytest.mark.parametrize("name, criterion", [("wiki103", "adaptive_loss"),
                                             ("char", "lm_cross_entropy"),
                                             ("char_adaptive", "adaptive_loss")])
def test_two_updates_match_jax(lm_data, name, criterion):
    """Two Adam updates (lr 1e-3, the clip 1.0) of one batch each, from the
    same weights: loss, gnorm and every parameter after each."""
    jm, params, model = _models(lm_data, name)
    opt_cfg = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
    sched_cfg = {"_name": "fixed", "lr": 1e-3}
    crit = {"_name": criterion, "padding_idx": lm_data["port"].target_dictionary.pad()}
    tx = jax_optimizer(opt_cfg, jax_schedule(sched_cfg), clip_norm=1.0)
    jax_step = make_train_step(jm, JAX_CRITERIONS.get(criterion)(dict(crit)), tx,
                               lr_schedule=jax_schedule(sched_cfg), donate=False)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = TrainStep(model, lm_data["port"].build_criterion(dict(crit)),
                     build_optimizer(opt_cfg, model.parameters(), clip_norm=1.0),
                     build_lr_schedule(sched_cfg), compute_dtype=torch.float32)
    batches = list(iter(lm_data["port"].make_batch_iterator(
        lm_data["port"].dataset("train"), max_sentences=3).next_epoch_itr(shuffle=False)))[:2]
    kind = convert.model_kind(model)
    for update, batch in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "id"}
        state, want = jax_step(state, jb, jax.random.PRNGKey(update))
        got = step([batch])
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        want_params = convert.params_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                                               kind)
        for k, w in want_params.items():
            np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(), atol=1e-4 * 1e-3,
                                       rtol=2.0 ** -22, err_msg=f"update {update}: {k}")


def _save_jax(path, name, params):
    model_cfg = {k: v for k, v in dict(MODELS[name], **WIDTHS).items()}
    jax_save_state(str(path), SimpleNamespace(step=0, params=params, opt_state=None),
                   {"model_cfg": model_cfg}, save_optimizer=False)
    return model_cfg


def test_jax_wiki103_checkpoint_loads_and_eval_lm_matches(lm_data, tmp_path, capsys):
    """A JAX-written ``transformer_lm_wiki103`` ``.ckpt``: the port rebuilds
    it from its stored arch (``load_language_model``) with the same outputs,
    and ``eval_lm`` prints the JAX CLI's line (JAX's eval_lm is given the
    arch, which it otherwise replaces with ``transformer_lm``)."""
    jm, params, _ = _models(lm_data, "wiki103")
    ckpt = tmp_path / "wiki103.ckpt"
    _save_jax(ckpt, "wiki103", params)
    lm = generate.load_language_model(str(ckpt), lm_data["port"], torch.float32, "cpu")
    assert lm.adaptive_softmax is not None
    tokens = PREV % len(lm_data["port"].target_dictionary)
    with torch.no_grad():
        got = lm(torch.from_numpy(tokens).long())
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    argv = [str(lm_data["bin"]), "--path", str(ckpt), "--tokens-per-sample", "12",
            "--batch-size", "4", "--dtype", "float32"]
    jax_eval_lm.main(argv + ["--arch", "transformer_lm_wiki103"])
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    stats = eval_lm.main(argv + ["--device", "cpu"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line == want_line and np.isfinite(stats["perplexity"])


def test_fused_adaptive_lm_adds_its_adaptive_log_probs(lm_data, monkeypatch):
    """Shallow fusion with a ``transformer_lm_wiki103`` LM: each step adds
    ``lm_weight`` times the adaptive softmax's log-probabilities, which sum
    to 1 over the vocabulary; the JAX package would add the log-softmax of
    the decoder's tied projection, which the adaptive model never trained
    (ROADMAP C), and that differs."""
    vocab = len(lm_data["port"].target_dictionary)
    jm, params, lm = _models(lm_data, "wiki103", seed=5)
    lm.eval()
    mt_jax = jax_mt.TransformerModel(jax_mt.TransformerMTConfig(
        **dict(SMALL, src_vocab_size=vocab, tgt_vocab_size=vocab)))
    mt = port_mt_model(mt_jax, seeded_tree(mt_jax.init(
        jax.random.PRNGKey(0), jnp.asarray(SRC % vocab), jnp.asarray(PREV % vocab)), 3))
    settings = GeneratorSettings(beam_size=2, max_decode_len=6)
    captured = {}

    def first_step(step_fn, ancestry, *, batch_size, beam_size, **kw):
        tokens = torch.full((batch_size * beam_size, 1), 2, dtype=torch.long)
        captured["scores"], _ = step_fn(tokens, 0, ancestry)
        return captured["scores"]

    monkeypatch.setattr(ensemble, "beam_search", first_step)
    src = torch.from_numpy(SRC % vocab).long()
    EnsembleSequenceGenerator([mt], settings, lm=(lm, 0.5)).generate_text(src)
    fused = captured["scores"]
    EnsembleSequenceGenerator([mt], settings).generate_text(src)
    alone = captured["scores"]
    n = src.shape[0] * 2
    with torch.no_grad():
        caches = lm.decoder.init_cache(n, 6)
        anc = torch.zeros((7, n), dtype=torch.int32)
        feats = lm.decoder.step(torch.full((n, 1), 2), 0, caches, None, None, anc, 2,
                                features_only=True)
        adaptive = lm.adaptive_softmax.log_prob(feats)
        caches = lm.decoder.init_cache(n, 6)
        tied = torch.log_softmax(lm.decoder.step(torch.full((n, 1), 2), 0, caches, None, None,
                                                 anc, 2).float(), -1)
    np.testing.assert_allclose(fused.numpy(), (alone + 0.5 * adaptive).numpy(), **TOL)
    np.testing.assert_allclose(torch.logsumexp(adaptive, -1).numpy(), 0.0, atol=1e-5)
    assert not torch.allclose(adaptive, tied, atol=1e-3)
    # the first step's features are the full forward's at position 0
    with torch.no_grad():
        full = lm(torch.full((n, 1), 2))[:, 0]
    np.testing.assert_allclose(adaptive.numpy(), full.numpy(), **TOL)
