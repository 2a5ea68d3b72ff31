"""GPT-2 of the PyTorch port (``chimera_st_tpu_torch/models/hf_gpt2.py``)
against the JAX package's ``GPT2LM`` and against a ``transformers``
``GPT2LMHeadModel`` built from a config (no weights are downloaded), on the
CPU at 2 layers, width 64, 4 heads, T 16: logits within 1e-5 (fp32), the
four presets' fields, the HF state-dict importer, the converter both ways,
and one Adam update through ``TrainStep`` against the JAX train step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.criterions import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.models import hf_gpt2 as jax_gpt2
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.models import hf_gpt2
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.tasks import language_modeling  # noqa: F401 (registers the criterion)
from chimera_st_tpu_torch.config.registry import CRITERIONS
from chimera_st_tpu_torch.train import TrainStep

import chimera_st_tpu.tasks.language_modeling  # noqa: F401,E402

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(vocab_size=96, n_positions=32, n_embd=64, n_layer=2, n_head=4, dropout=0.0)
TOKENS = np.random.default_rng(0).integers(3, 96, size=(2, 16)).astype(np.int64)


@pytest.fixture(scope="module")
def weights():
    """A flax tree of the small GPT-2 (its init's shapes) with seeded
    values, so that no layer is the identity."""
    jm = jax_gpt2.GPT2LM(jax_gpt2.GPT2Config(**SMALL))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(TOKENS, jnp.int32))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: (1.0 + 0.1 * rng.normal(size=s.shape) if "scale" in
                         jax.tree_util.keystr(path) else 0.2 * rng.normal(size=s.shape)
                         ).astype(np.float32), shapes)
    return jm, tree


def port_model(tree):
    model = hf_gpt2.build_hf_gpt2(dict(SMALL), device="cpu")
    model.load_state_dict(convert.params_from_flax(tree, "hf_gpt2"), strict=True)
    return model.eval()


def test_logits_match_jax_and_the_converter_round_trips(weights):
    jm, tree = weights
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                               jnp.asarray(TOKENS, jnp.int32)))
    model = port_model(tree)
    with torch.no_grad():
        got = model(torch.from_numpy(TOKENS))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 96)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    back = convert.params_to_flax(model.state_dict(), "hf_gpt2")
    flat = jax.tree_util.tree_leaves_with_path(tree["params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_logits_match_a_transformers_model_from_its_state_dict(weights):
    """``import_hf_gpt2_state_dict`` reads ``GPT2LMHeadModel.state_dict()``
    (HF's [in, out] Conv1D layout kept) without importing transformers; the
    JAX importer reads the same dict, and all three agree."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(vocab_size=96, n_positions=32, n_embd=64, n_layer=2,
                                  n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(cfg).eval()
    with torch.no_grad():  # away from the initialiser's small scales
        for p in hf.parameters():
            p.add_(0.05 * torch.randn_like(p))
        want = hf(torch.from_numpy(TOKENS)).logits.numpy()
    sd = hf.state_dict()
    model = hf_gpt2.build_hf_gpt2(dict(SMALL), device="cpu").eval()
    model.load_state_dict(hf_gpt2.import_hf_gpt2_state_dict(sd), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(TOKENS)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jm, _ = weights
    ref = np.asarray(jm.apply(jax_gpt2.import_hf_gpt2_state_dict(sd),
                              jnp.asarray(TOKENS, jnp.int32)))
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError, match="unread"):
        hf_gpt2.import_hf_gpt2_state_dict({**sd, "transformer.extra.weight": torch.zeros(1)})


@pytest.mark.parametrize("arch", sorted(hf_gpt2.ARCHITECTURES))
def test_presets_match_jax(arch):
    from chimera_st_tpu.config.registry import ARCHITECTURES as JAX_ARCHITECTURES

    model_name, preset = hf_gpt2.ARCHITECTURES[arch]
    jax_model_name, jax_preset = JAX_ARCHITECTURES.get(arch)
    assert model_name == jax_model_name == "hf_gpt2"
    for overrides in ({}, {"embed_dim": 32, "layers": 3, "heads": 2, "tgt_vocab_size": 10}):
        want = jax_gpt2.build_hf_gpt2(jax_preset(dict(overrides))).cfg
        got = hf_gpt2.gpt2_config(preset(dict(overrides)))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.vocab_size == 50257 and got.n_positions == 1024


def test_one_update_matches_the_jax_train_step(weights):
    jm, tree = weights
    rng = np.random.default_rng(2)
    target = rng.integers(3, 96, size=(2, 16)).astype(np.int64)
    target[1, 12:] = 1
    batch = {"net_tokens": TOKENS, "target": target,
             "ntokens": float((target != 1).sum()), "nsentences": 2}
    # eps 1e-3: the key bias's gradient is round-off (softmax ignores it),
    # which a small eps would blow up to +-lr in either package
    opt_cfg = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
    sched_cfg = {"_name": "inverse_sqrt", "lr": 1e-3, "warmup_updates": 0}
    crit_cfg = {"_name": "lm_cross_entropy", "padding_idx": 1}
    sched = jax_build_lr_schedule(sched_cfg)
    tx = jax_build_optimizer(opt_cfg, sched, clip_norm=0.0)
    step_j = make_train_step(jm, JAX_CRITERIONS.get("lm_cross_entropy")(crit_cfg), tx,
                             lr_schedule=sched, donate=False)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, tree), tx)
    state, want = step_j(state, {k: jnp.asarray(v) for k, v in batch.items()
                                 if k != "nsentences"}, jax.random.PRNGKey(0))
    model = port_model(tree).train()
    step = TrainStep(model, CRITERIONS.get("lm_cross_entropy")(crit_cfg),
                     build_optimizer(opt_cfg, model.parameters()),
                     build_lr_schedule(sched_cfg), compute_dtype=torch.float32)
    got = step([batch])
    for k in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    updated = convert.params_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                                       "hf_gpt2")
    for k, w in updated.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(), atol=1e-7,
                                   rtol=1e-5, err_msg=k)
        assert not np.array_equal(w.numpy(), convert.params_from_flax(tree, "hf_gpt2")[k].numpy())
