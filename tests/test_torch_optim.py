"""The port's optimizers and learning-rate schedules against the JAX
package's (optax) on the CPU: the eight ``--optimizer`` choices, plain,
with ``--weight-decay``, with ``--clip-norm`` and under a ``--fix-*`` mask,
three updates from the same gradients on the TINY interlingua model's
parameter tree (every parameter after each update within 1e-4 of the
learning rate plus two fp32 roundings, as ``test_torch_mt.py`` holds Adam),
the optax tree the port writes (every state leaf within 1e-5 of its
tensor's largest value, the layout equal) and its restore both ways, a
skipped update, and the seven ``--lr-scheduler`` choices at steps 0..N as
an int and as a tensor (within 1e-6, relative: optax's are fp32).

The weights come from a seeded torch reference through the JAX package's
fairseq importer and the optax chains run eagerly: nothing for XLA to
compile but the small update ops."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from chimera_st_tpu.checkpoint import torch_import as jax_import
from chimera_st_tpu.optim import build_lr_schedule as jax_schedule
from chimera_st_tpu.optim import build_optimizer as jax_optimizer
from chimera_st_tpu.optim import freeze as jax_freeze
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer, freeze
from chimera_st_tpu_torch.optim.lr_schedulers import PlateauSchedule
from chimera_st_tpu_torch.optim.optimizers import Adafactor, Optimizer
from chimera_st_tpu_torch.train import global_norm
from tests.test_interlingua_model import TINY
from tests.test_torch_checkpoint import fairseq_state_dict
from tests.test_torch_models import port_config
from tests.test_torch_train_store import _assert_trees, _flat

LR = 1e-2
SCHED = {"_name": "fixed", "lr": LR}
OPTIMIZERS = {
    "adam": {"_name": "adam", "adam_betas": "(0.9, 0.98)"},
    "adafactor": {"_name": "adafactor"},
    "adagrad": {"_name": "adagrad"},
    "adadelta": {"_name": "adadelta"},
    "sgd": {"_name": "sgd", "momentum": 0.9},
    "nag": {"_name": "nag"},
    "adamax": {"_name": "adamax"},
    "lamb": {"_name": "lamb"},
}
# variant -> (extra optimizer config, clip norm, --fix-* flags)
VARIANTS = {
    "plain": ({}, 0.0, ()),
    "weight_decay": ({"weight_decay": 0.01}, 0.0, ()),
    "clip": ({}, 0.5, ()),
    "freeze": ({}, 0.5, ("fix_wav2vec", "fix_decoder")),
}


@pytest.fixture(scope="module")
def tree():
    params = {"params": jax_import.import_interlingua_state_dict(fairseq_state_dict(TINY, 2)[1])}
    return jax.tree_util.tree_map(np.asarray, params)


def _grads(params, n, seed=3, scale=0.1):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * scale)
                                   .astype(np.float32), params) for _ in range(n)]


def _port(params, opt_cfg, clip, fixes, min_dim=None):
    model = ChimeraInterlinguaModel(port_config(TINY), device="cpu")
    model.load_state_dict(convert.params_from_flax(params), strict=True)
    trained, frozen = freeze.wrap_freeze(model, fixes)
    axes = convert.checkpoint_axes(model)
    if min_dim is None:
        opt = build_optimizer(opt_cfg, trained, clip_norm=clip, frozen=frozen, checkpoint_axes=axes)
    else:
        class SmallAdafactor(Adafactor):
            MIN_DIM_SIZE_TO_FACTOR = min_dim

        opt = Optimizer(SmallAdafactor(trained, axes), clip, frozen)
    return model, opt, trained, frozen


def _jax_tx(params, opt_cfg, clip, fixes, min_dim=None):
    sched = jax_schedule(SCHED)
    if min_dim is None:
        tx = jax_optimizer(opt_cfg, sched, clip_norm=clip)
    else:  # optax.adafactor factoring small dims, the chain otherwise the JAX package's
        tx = optax.adafactor(learning_rate=sched, min_dim_size_to_factor=min_dim)
        tx = optax.chain(optax.clip_by_global_norm(clip), tx) if clip else tx
    return jax_freeze.wrap_freeze(tx, params, fixes)


CASES = [(o, v, None) for o in OPTIMIZERS for v in VARIANTS] + [
    ("adafactor", "plain", 8), ("adafactor", "freeze", 8)]


@pytest.mark.parametrize("name, variant, min_dim", CASES,
                         ids=[f"{o}-{v}" + ("-factored" if m else "") for o, v, m in CASES])
def test_updates_and_optax_tree_match_jax(tree, name, variant, min_dim):
    """Three updates through optax (the JAX CLI's chain) and through the
    port: every parameter after each; the optax tree the port writes equals
    the JAX one; the port loads the JAX tree and JAX loads the port's."""
    extra, clip, fixes = VARIANTS[variant]
    opt_cfg = dict(OPTIMIZERS[name], **extra)
    params = tree
    grads = _grads(params, 3)
    tx = _jax_tx(params, opt_cfg, clip, fixes, min_dim)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    s_j = tx.init(p_j)
    model, opt, trained, frozen = _port(params, opt_cfg, clip, fixes, min_dim)
    schedule = build_lr_schedule(SCHED)
    named = dict(model.named_parameters())
    for step, g in enumerate(grads):
        u, s_j = tx.update(jax.tree_util.tree_map(jnp.asarray, g), s_j, p_j)
        p_j = optax.apply_updates(p_j, u)
        for key, t in convert.params_from_flax(g).items():
            named[key].grad = t
        opt.step(schedule(step), global_norm([p.grad for p in named.values()]))
        want = dict(_flat(jax.tree_util.tree_map(np.asarray, p_j)))
        got = dict(_flat(convert.params_to_flax(model.state_dict())))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=1e-4 * LR, rtol=2.0 ** -22,
                                       err_msg=f"update {step}: " + "/".join(path))
    want_tree = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(s_j))
    got_tree = opt.state_to_optax(model, 3)
    _assert_trees(got_tree, want_tree, of_max=1e-5)
    # the JAX-written tree into a fresh port optimizer, the port's into JAX
    fresh_model, fresh, _, _ = _port(params, opt_cfg, clip, fixes, min_dim)
    assert fresh.load_optax(want_tree, fresh_model) == 3
    _assert_trees(fresh.state_to_optax(fresh_model, 3), want_tree)
    back = serialization.from_state_dict(tx.init(p_j), got_tree)
    _assert_trees(jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(back)),
                  got_tree)
    # frozen parameters hold no state
    for p in frozen:
        assert p not in opt.optimizer.state


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_a_nonfinite_update_changes_nothing(tree, name):
    """A skipped update (the step's ``skip`` scalar on the device) leaves
    every parameter, every state tensor and the count as they were."""
    model, opt, trained, _ = _port(tree, OPTIMIZERS[name], 0.5, ())
    named = dict(model.named_parameters())
    g = _grads(tree, 1)[0]
    for key, t in convert.params_from_flax(g).items():
        named[key].grad = t
    opt.step(LR, global_norm([p.grad for p in named.values()]))
    before_p = {k: v.clone() for k, v in model.state_dict().items()}
    before_s = opt.state_to_optax(model, 1)
    for p in named.values():
        p.grad = torch.full_like(p, float("nan"))
    norm = global_norm([p.grad for p in named.values()])
    opt.step(LR, norm, skip=~torch.isfinite(norm))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before_p[k]), k
    _assert_trees(opt.state_to_optax(model, 1), before_s)


def test_a_tree_of_another_optimizer_raises(tree):
    model, opt, _, _ = _port(tree, OPTIMIZERS["adagrad"], 0.0, ())
    for cfg in (OPTIMIZERS["adamax"], dict(OPTIMIZERS["adagrad"], weight_decay=0.1)):
        other_model, other, _, _ = _port(tree, cfg, 0.0, ())
        with pytest.raises(ValueError, match="layout"):
            other.load_optax(opt.state_to_optax(model, 0), other_model)


SCHEDULES = {
    "fixed": {"lr": 0.25, "warmup_updates": 3},
    "inverse_sqrt": {"lr": 5e-4, "warmup_updates": 4},
    "cosine": {"lr": 1e-4, "max_lr": 1e-3, "warmup_updates": 2, "lr_period_updates": 5,
               "t_mult": 2.0, "lr_shrink": 0.5},
    "polynomial_decay": {"lr": 1e-3, "warmup_updates": 3, "total_num_update": 12,
                         "end_learning_rate": 1e-5, "power": 2.0},
    "tri_stage": {"lr": 1e-3, "max_update": 20, "init_lr_scale": 0.05,
                  "final_lr_scale": 0.02},
    "triangular": {"lr": 1e-4, "max_lr": 1e-3, "lr_period_updates": 6, "lr_shrink": 0.5,
                   "shrink_min": True},
    "reduce_lr_on_plateau": {"lr": 1e-3, "warmup_updates": 4},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    cfg = dict(SCHEDULES[name], _name=name)
    want = jax_schedule(dict(cfg))
    got = build_lr_schedule(dict(cfg))
    steps = list(range(25))
    w = np.asarray([float(want(s)) for s in steps])
    np.testing.assert_allclose([got(s) for s in steps], w, rtol=1e-6, atol=0)
    t = got(torch.arange(25))
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=0)
    if name == "cosine":  # the one-cycle form
        cfg = {"_name": "cosine", "lr": 1e-5, "max_lr": 1e-3, "warmup_updates": 3,
               "max_update": 15}
        w = [float(jax_schedule(cfg)(s)) for s in steps]
        np.testing.assert_allclose([build_lr_schedule(cfg)(s) for s in steps], w, rtol=1e-6)


def test_plateau_shrinks_as_jax_and_round_trips():
    """``step_val`` over a metric series shrinks as the JAX schedule does;
    ``state_dict`` restores the scale, best and bad count."""
    from chimera_st_tpu.optim.lr_schedulers import PlateauSchedule as JaxPlateau

    cfg = {"lr": 1e-3, "lr_shrink": 0.5, "lr_patience": 1}
    got, want = PlateauSchedule(cfg), JaxPlateau(cfg)
    for v in (3.0, 2.5, 2.6, 2.7, 2.2, 2.3, 2.4, 2.5):
        assert got.step_val(v) == want.step_val(v)
        assert got.state_dict() == want.state_dict()
        np.testing.assert_allclose(got(7), float(want(7)), rtol=1e-6)
    assert got.scale == 0.25
    again = PlateauSchedule(cfg)
    again.load_state_dict(got.state_dict())
    assert again.state_dict() == got.state_dict() and again(7) == got(7)
    assert not again.step_val(None)


def test_trainer_saves_the_plateau_state_and_restores_it_unless_reset(tree):
    """``reduce_lr_on_plateau``'s state rides in the checkpoint's extra state
    under ``lr_scheduler`` (the JAX trainer's key) and comes back on
    restore, but not under ``--reset-lr-scheduler``."""
    from chimera_st_tpu_torch.train import Trainer

    model, opt, _, _ = _port(tree, OPTIMIZERS["adam"], 0.0, ())
    sched = build_lr_schedule({"_name": "reduce_lr_on_plateau", "lr": 1e-3, "lr_patience": 0})
    trainer = Trainer(model, None, opt, sched, torch.float32)
    for v in (3.0, 3.5):
        sched.step_val(v)
    extra = trainer.extra_state()
    assert extra["lr_scheduler"] == {"scale": 0.1, "best": 3.0, "bad": 0}
    for load, scale in ((False, 1.0), (True, 0.1)):
        fresh = Trainer(model, None, opt, build_lr_schedule({"_name": "reduce_lr_on_plateau",
                                                             "lr": 1e-3}), torch.float32)
        fresh.load_extra_state(extra, load_lr_scheduler=load)
        assert fresh.lr_schedule.scale == scale
        np.testing.assert_allclose(fresh.lr_schedule(5), 1e-3 * scale)
