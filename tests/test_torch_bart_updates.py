"""Two accumulated fp32 updates of each new task x criterion in the port
against the JAX package's ``make_train_step`` on the CPU: BART under
``denoising`` and ``multilingual_denoising``, mBART under
``translation_from_pretrained_bart`` (label-smoothed cross entropy),
``transformer`` under ``translation_multi_simple_epoch``, BART's head under
``sentence_prediction``, ``sentence_ranking`` and ``composite_loss``, and
the multilingual transformer under ``multilingual_translation`` with
``multilingual_label_smoothed_cross_entropy`` on a batch of the second pair
(``fr-en``, whose ``task_name`` reaches the criterion). The micro-batches
array for array, then loss, sample size, gnorm, lr and every parameter
after each update.

The multilingual decoders keep attention and activation dropout 0.1 in
both packages whatever the config says (ROADMAP C), so that case runs
without dropout on both sides: the JAX criterion deterministic, the port's
decoder rates set to 0 on the instance.

Data and widths: ``tests/test_torch_bart_train.py``'s (2 + 2 layers, 32
wide, 4 heads, every dropout 0). Tolerances: parameters 1e-4 of the
learning rate plus two fp32 roundings (2^-22 relative); losses, gnorm and
lr 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.convert import model_kind, params_from_flax
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.train import TrainStep
from tests.test_torch_bart import WIDTHS, data  # noqa: F401 — the data fixture
from tests.test_torch_bart_train import NO_DROPOUT, TASKS, task_pair
from tests.test_torch_models import numpy_tree

LR = 1e-3
OPT_CFG = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
SCHED_CFG = {"_name": "inverse_sqrt", "lr": LR, "warmup_updates": 2}
CASES = {case: (case, None) for case in TASKS if case != "denoising_insert_rotate"}
CASES["composite_loss"] = ("sentence_prediction", {
    "_name": "composite_loss", "underlying": [{"_name": "sentence_prediction", "weight": 0.5},
                                              {"_name": "sentence_prediction", "weight": 2.0}]})


def _micro_batches(task, case):
    """Two micro-batches of three rows each of the split's first batch of
    six (of the second pair for the multilingual task)."""
    itr = task.make_batch_iterator(task.dataset("train"), max_sentences=6)
    batch = next(b for b in itr.next_epoch_itr(shuffle=False)
                 if b.get("task_name", "fr-en") == "fr-en" and len(b["id"]) == 6)
    micro = []
    for rows in (slice(0, 3), slice(3, 6)):
        half = {k: v[rows] for k, v in batch.items() if isinstance(v, np.ndarray)}
        half["ntokens"] = float((half["target"] != 1).sum()) if "target" in half else 3.0
        half["nsentences"] = 3
        if "task_name" in batch:
            half["task_name"] = batch["task_name"]
        micro.append(half)
    return micro


def _jax_init(jm, micro):
    b = {k: jnp.asarray(v) for k, v in micro.items() if isinstance(v, np.ndarray)}
    if "candidate_tokens" in b:
        src = prev = b["candidate_tokens"][:, 0]
    else:
        src, prev = b["src_tokens"], b["prev_output_tokens"]
    cls = type(jm)
    kw = {"method": cls.init_everything} if hasattr(cls, "init_everything") else {}
    return jax.jit(lambda k: jm.init(k, src, prev, **kw))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_updates_match_jax_train_step(data, case):
    task_case, crit_cfg = CASES[case]
    task, jax_task = task_pair(data, task_case)
    _, _, model_cfg, default_crit = TASKS[task_case]
    crit_cfg = {**(crit_cfg or default_crit), "label_smoothing": 0.1}
    micro = _micro_batches(task, case)
    for a, b in zip(micro, _micro_batches(jax_task, case)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model_cfg = {**model_cfg, **WIDTHS, **NO_DROPOUT}
    jm = jax_task.build_model(dict(model_cfg))
    weights = jax.tree_util.tree_map(np.asarray, _jax_init(jm, micro[0]))
    model = task.build_model(dict(model_cfg), device="cpu", train=True)
    kind = model_kind(model)
    model.load_state_dict(params_from_flax(weights, kind), strict=True)
    jax_crit = JAX_CRITERIONS.get(crit_cfg["_name"])({**crit_cfg, "padding_idx": 1})
    pair = micro[0].get("task_name")
    if pair is not None:
        assert pair == "fr-en"
        inner = jax_crit

        def jax_crit(model_, params, batch, rngs=None, num_updates=None, train=True):
            return inner(model_, params, {**batch, "task_name": pair}, rngs, num_updates,
                         train=False)

        for m in model.decoders.modules():
            for attr in ("dropout", "activation_dropout"):
                if isinstance(getattr(m, attr, None), float):
                    setattr(m, attr, 0.0)
    sched = jax_build_lr_schedule(SCHED_CFG)
    tx = jax_build_optimizer(OPT_CFG, sched)
    jax_step = make_train_step(jm, jax_crit, tx, accum_steps=2, lr_schedule=sched, donate=False)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, weights), tx)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]
               if k not in ("nsentences", "task_name")}  # "id" first, as the JAX trainer's
    step = TrainStep(model, task.build_criterion(crit_cfg),
                     build_optimizer(OPT_CFG, list(model.parameters())),
                     build_lr_schedule(SCHED_CFG), compute_dtype=torch.float32)
    for update in range(2):
        state, want = jax_step(state, stacked, jax.random.PRNGKey(update))
        got = step(micro)
        for k in ("loss", "sample_size_total", "gnorm", "lr"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        lr = max(got["lr"], LR)
        for k, w in params_from_flax(numpy_tree(state.params), kind).items():
            np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(),
                                       atol=1e-4 * lr, rtol=2.0 ** -22,
                                       err_msg=f"update {update}: {k}")
