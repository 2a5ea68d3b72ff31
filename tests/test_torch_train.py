"""Parity of the port's triplet fine-tune step with the JAX package on the
CPU: criterions, gradients, schedule, optimizer and the accumulated update.

The model is ``TINY`` with every dropout at 0, its weights made by flax and
carried across; the batches are collated by the port's triplet task on
``make_triplet_dir``. Tolerances (fp32):

- losses and logged scalars: 1e-5 relative;
- gradients: 1e-5 of each tensor's largest gradient (reductions run in
  another order in the two frameworks; see ``_assert_grads_match`` for the
  key projections' biases);
- parameters after an Adam update: 1e-4 of the learning rate, plus two
  fp32 roundings of the parameter (2^-22 relative). The first updates of
  Adam are about lr * g / (|g| + eps), whose slope in g is up to 1 / eps:
  with the default eps 1e-8 the round-off of a gradient near eps could
  flip its update. The test raises ``adam_eps`` to 1e-3, which bounds that
  slope, so the update differs by at most the gradient's difference / eps.

The model is cut to one layer per stack to keep the JAX compiles short.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chimera_st_tpu.checkpoint import torch_import as jax_import
from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.criterions import label_smoothed_nll_loss as _jax_registers  # noqa: F401
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer, clip_by_global_norm_
from chimera_st_tpu_torch.tasks import setup_task
from chimera_st_tpu_torch.train import TrainStep, microbatch_grad, prepare_batch, valid_step
from tests.synthetic_data import make_triplet_dir
from tests.test_interlingua_model import TINY
from tests.test_torch_checkpoint import fairseq_state_dict
from tests.test_torch_models import numpy_tree, port_model

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, w2v2_dropout=0.0,
                  w2v2_attention_dropout=0.0, w2v2_activation_dropout=0.0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's triplet task on a seeded fixture, the model config sized
    to its dictionaries, and one collated batch of 4."""
    root = tmp_path_factory.mktemp("triplet")
    make_triplet_dir(str(root), n=8, seed=3)
    task = setup_task({"_name": "triplet", "data": str(root), "config_yaml": "config_wave.yaml"})
    batch = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=4)
                      .next_epoch_itr(shuffle=False)))
    cfg = dataclasses.replace(TINY, tgt_vocab_size=len(task.target_dictionary),
                              src_vocab_size=len(task.source_dictionary), w2v2_layers=1,
                              encoder_layers=1, interlingua_layers=1, decoder_layers=1,
                              **NO_DROPOUT)
    return task, cfg, batch


@pytest.fixture(scope="module")
def weights(data):
    """Seeded weights of the torch reference model through the JAX
    package's fairseq importer (numpy: nothing for XLA to compile)."""
    _, cfg, _ = data
    return {"params": jax_import.import_interlingua_state_dict(fairseq_state_dict(cfg, 2)[1])}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if k not in ("nsentences",) and not isinstance(v, str)}


def port(cfg, params, **overrides):
    return port_model(dataclasses.replace(cfg, **overrides), params).train()


CRIT_CASES = {
    "recipe": {"label_smoothing": 0.1, "loss_ratio": (1.0, 1.0, 1.0)},
    "ramp_sentence_avg": {"label_smoothing": 0.2, "loss_ratio": (1.0, 0.5, 2.0),
                          "contrastive_increase_until": 10, "sentence_avg": True},
    "kd_ratio": {"label_smoothing": 0.1, "loss_ratio": (1.0, 0.0, 0.0), "kd_ratio": (0.25, 2.0)},
    "sample_contrastive": {"_name": "triplet_st_mt_samplecontrastive",
                           "loss_ratio": (0.0, 1.0, 1.0)},
}


def jax_criterion(cfg, crit_cfg, num_updates):
    """The JAX criterion, jitted (one XLA compile instead of one a
    primitive): (params, batch) -> (loss, sample size, logging)."""
    crit = JAX_CRITERIONS.get(crit_cfg["_name"])({**crit_cfg, "padding_idx": 1})
    return jax.jit(lambda p, b: crit(JaxModel(cfg), p, b, num_updates=num_updates, train=False))


@pytest.mark.parametrize("case", sorted(CRIT_CASES))
def test_criterion_matches_jax(data, weights, case):
    """Loss, sample size and every logged scalar of one collated batch,
    at update 3 (inside the contrastive ramp)."""
    task, cfg, batch = data
    crit_cfg = {"_name": "triplet_st_mt_contrastive", **CRIT_CASES[case]}
    want_loss, want_ss, want = jax_criterion(cfg, crit_cfg, 3)(weights, jax_batch(batch))
    crit = task.build_criterion(crit_cfg)
    loss, ss, got = crit(port(cfg, weights), prepare_batch(batch, "cpu"), None, 3)
    assert float(ss) == float(want_ss)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(torch.as_tensor(got[k]).detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)


def _assert_grads_match(got, want_tree, what):
    """Every tensor within 1e-5 of its largest gradient. A key projection's
    bias shifts a softmax row by a constant, so its exact gradient is 0 and
    both frameworks return round-off of sums as large as the projection
    weight's gradient: it is held to 1e-5 of that."""
    want = params_from_flax(numpy_tree(want_tree))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        scale = np.abs(want[k[:-len("bias")] + "weight"].numpy()).max() \
            if k.endswith("k_proj.bias") else np.abs(w).max()
        np.testing.assert_allclose(got[k], w, atol=1e-5 * scale, rtol=0, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("fmult", [1.0, 0.0])
def test_every_parameter_gradient_matches_jax(data, weights, fmult):
    """d(loss)/d(parameter) for every parameter, ST + MT + contrastive
    (loss ratio 1 1 1, label smoothing 0.1), against jax.grad of the JAX
    criterion on the same weights; feature_grad_mult 1 (the extractor
    trains) and 0 (its gradients are zero)."""
    task, cfg, batch = data
    cfg = dataclasses.replace(cfg, feature_grad_mult=fmult)
    crit_cfg = {"_name": "triplet_st_mt_contrastive", **CRIT_CASES["recipe"]}
    jax_crit = JAX_CRITERIONS.get(crit_cfg["_name"])({**crit_cfg, "padding_idx": 1})
    want = jax.jit(jax.grad(lambda p, b: jax_crit(JaxModel(cfg), p, b, num_updates=0,
                                                  train=False)[0]))(weights, jax_batch(batch))
    model = port(cfg, weights)
    microbatch_grad(model, task.build_criterion(crit_cfg), prepare_batch(batch, "cpu"), None, 0)
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for k, p in model.named_parameters()}
    _assert_grads_match(got, want, f"feature_grad_mult {fmult}")
    extractor = [k for k in got if ".feature_extractor." in k]
    assert extractor and all((np.abs(got[k]).max() == 0) == (fmult == 0) for k in extractor)


@pytest.mark.parametrize("sched_cfg", [
    {"_name": "inverse_sqrt", "lr": 1e-4, "warmup_updates": 25},
    {"_name": "inverse_sqrt", "lr": 5e-4, "warmup_updates": 4, "warmup_init_lr": 1e-7},
    {"_name": "inverse_sqrt", "lr": 2e-3, "warmup_updates": 0},
    {"_name": "fixed", "lr": 0.25, "warmup_updates": 3},
])
def test_lr_schedules_match_jax(sched_cfg):
    want, got = jax_build_lr_schedule(sched_cfg), build_lr_schedule(sched_cfg)
    for step in list(range(60)) + [1000, 25_000, 100_000]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=str(step))


def test_adamw_and_clip_match_optax():
    """One decoupled-decay Adam update after a global-norm clip that
    triggers, against optax.chain(clip_by_global_norm, adamw); 1e-6."""
    rng = np.random.default_rng(0)
    p = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    g = [rng.normal(size=x.shape).astype(np.float32) * 3 for x in p]
    cfg = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "weight_decay": 0.01}
    sched = jax_build_lr_schedule({"_name": "fixed", "lr": 0.1})
    tx = jax_build_optimizer(cfg, sched, clip_norm=1.0)
    upd, _ = tx.update([jnp.asarray(x) for x in g], tx.init([jnp.asarray(x) for x in p]),
                       [jnp.asarray(x) for x in p])
    want = optax.apply_updates([jnp.asarray(x) for x in p], upd)
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p]
    for t, x in zip(params, g):
        t.grad = torch.from_numpy(x.copy())
    opt = build_optimizer(cfg, params, clip_norm=1.0)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    norm = torch.linalg.vector_norm(torch.stack([t.grad.norm() for t in params]))
    assert norm > 1.0
    opt.step(0.1, norm)
    for t, w in zip(params, want):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), atol=1e-6)
    # below the threshold the clip leaves gradients as they are
    small = [torch.full((3,), 0.1)]
    clip_by_global_norm_(small, 1.0, torch.linalg.vector_norm(small[0]))
    assert torch.equal(small[0], torch.full((3,), 0.1))


def _micro_batches(batch):
    """The collated batch of 4 as two micro-batches of 2 rows (the same
    padded shapes), ``ntokens`` counted per half."""
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        half = {k: v[rows] for k, v in batch.items() if isinstance(v, np.ndarray)}
        half["ntokens"] = float((half["target"] != 1).sum())
        half["nsentences"] = 2
        halves.append(half)
    return halves


OPT_CFG = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
SCHED_CFG = {"_name": "inverse_sqrt", "lr": 1e-3, "warmup_updates": 1}
CLIP = 2.0


def test_accumulated_updates_match_jax(data, weights):
    """Two updates of two micro-batches each (accumulation 2): loss, gnorm,
    update count and every parameter after the first (lr 0: parameters
    unchanged) and after the second (lr 1e-3, the clip triggering) against
    ``make_train_step``."""
    task, cfg, batch = data
    crit_cfg = {"_name": "triplet_st_mt_contrastive", **CRIT_CASES["recipe"]}
    micro = _micro_batches(batch)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]
               if k != "nsentences"}
    sched = jax_build_lr_schedule(SCHED_CFG)
    tx = jax_build_optimizer(OPT_CFG, sched, clip_norm=CLIP)
    jax_step = make_train_step(JaxModel(cfg), JAX_CRITERIONS.get(crit_cfg["_name"])(
        {**crit_cfg, "padding_idx": 1}), tx, accum_steps=2, lr_schedule=sched, donate=False)
    state = create_train_state(weights, tx)

    model = port(cfg, weights)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = TrainStep(model, task.build_criterion(crit_cfg),
                     build_optimizer(OPT_CFG, model.parameters(), clip_norm=CLIP),
                     build_lr_schedule(SCHED_CFG), compute_dtype=torch.float32)
    for update in range(2):
        state, want = jax_step(state, stacked, jax.random.PRNGKey(update))
        got = step(micro)
        assert step.num_updates == int(state.step) == update + 1
        for k in ("loss", "st_loss", "mt_loss", "contrastive_loss", "sample_size_total", "gnorm",
                  "lr"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        assert got["nonfinite_grad"] == float(want["nonfinite_grad"]) == 0.0
        want_params = params_from_flax(numpy_tree(state.params))
        lr = max(got["lr"], SCHED_CFG["lr"])
        for k, w in want_params.items():
            p = model.state_dict()[k]
            np.testing.assert_allclose(p.numpy(), w.numpy(), atol=1e-4 * lr, rtol=2.0 ** -22,
                                       err_msg=f"update {update}: {k}")
            if update == 0:
                assert torch.equal(p, before[k]), k
    assert want["gnorm"] > CLIP


def test_nonfinite_batch_changes_nothing(data, weights):
    """A NaN in one micro-batch's audio: gnorm not finite, parameters,
    Adam's state and the update count exactly as before; the next finite
    update goes on from there."""
    task, cfg, batch = data
    model = port(cfg, weights)
    step = TrainStep(model, task.build_criterion(CRIT_CASES["recipe"] | {
        "_name": "triplet_st_mt_contrastive"}), build_optimizer(OPT_CFG, model.parameters()),
        build_lr_schedule(SCHED_CFG), compute_dtype=torch.float32)
    step([batch])
    step([batch])
    params = {k: v.clone() for k, v in model.state_dict().items()}
    opt_state = {i: {k: v.clone() for k, v in s.items()}
                 for i, s in enumerate(step.optimizer.optimizer.state.values())}
    bad = dict(batch, audio=batch["audio"].copy())
    bad["audio"][1, 5] = np.nan
    metrics = step([batch, bad])
    assert metrics["nonfinite_grad"] == 1.0 and not math.isfinite(metrics["gnorm"])
    assert step.num_updates == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for i, s in enumerate(step.optimizer.optimizer.state.values()):
        for k, v in s.items():
            assert torch.equal(v, opt_state[i][k]), (i, k)
    assert step([batch])["nonfinite_grad"] == 0.0 and step.num_updates == 3


def test_valid_step_and_train_mode_build(data, weights):
    """``build_model(train=True)``: train mode, fp32 parameters; bf16 raises.
    ``valid_step``: the criterion in eval mode, the model's mode restored.
    ``w2v2_remat`` recomputes each trunk layer in the backward with the
    forward's dropout masks: the same loss and gradients as without it."""
    task, cfg, batch = data
    arch = {"arch": "s2t_transformer_w2v2_interlingua_base", **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("w2v2_extractor_mode", "share_decoder_input_output_embed")}}
    model = task.build_model(arch, device="cpu", train=True)
    assert model.training and all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="fp32"):
        task.build_model(arch, dtype=torch.bfloat16, device="cpu", train=True)
    model.load_state_dict(port(cfg, weights).state_dict())
    crit = task.build_criterion({"_name": "triplet_st_mt_contrastive"})
    b = prepare_batch(batch, "cpu")
    logged = valid_step(model, crit, b)
    assert model.training
    with torch.no_grad():
        _, _, want = crit(model.eval(), b)
    assert logged == {k: float(v) for k, v in want.items()}
    dropouts = dict(w2v2_dropout=0.1, w2v2_attention_dropout=0.1, w2v2_activation_dropout=0.1)
    grads, losses, calls = [], [], []
    for remat in (False, True):
        m = port(cfg, weights, w2v2_remat=remat, **dropouts)
        layer0, n = m.encoder.wav2vec_model.encoder.layers[0], [0]
        forward = layer0.forward

        def counted(*args, _forward=forward, _n=n, **kwargs):
            _n[0] += 1  # a module hook would not see the recompute
            return _forward(*args, **kwargs)

        layer0.forward = counted
        loss, _, _ = crit(m, b, torch.Generator().manual_seed(5))
        loss.backward()
        losses.append(float(loss.detach()))
        calls.append(n[0])
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
    assert calls == [1, 2]  # the recompute ran
    assert losses[0] == losses[1]
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k
