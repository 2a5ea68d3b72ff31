"""Two accumulated updates of each non-autoregressive criterion in the port
against the JAX package's ``make_train_step`` on the CPU:
``levenshtein_loss`` (Levenshtein), ``nat_loss`` (CMLM under
``random_mask``), ``nacrf_loss`` (NAT-CRF under ``full_mask``) and
``insertion_loss`` (``translation_ins``): the micro-batches array for array,
then loss, sample size, gnorm, lr and every parameter after each update.

Data and widths: ``tests/test_torch_nat_train.py``'s fixture (2 + 2
layers, 32 wide, 4 heads, every dropout 0). Tolerances: parameters 1e-4 of
the learning rate plus two fp32 roundings (2^-22 relative); losses, gnorm
and lr 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chimera_st_tpu.criterions.nat_loss  # noqa: F401 — registers the JAX criterions
import chimera_st_tpu.models.nat_insertion  # noqa: F401 — registers insertion_loss
from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.train import TrainStep
from tests.test_torch_models import numpy_tree
from tests.test_torch_nat_train import (  # noqa: F401 — the data fixture
    LR,
    OPT_CFG,
    SCHED_CFG,
    WIDTHS,
    _tasks,
    data,
)

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
# criterion -> (task, --noise, arch, extra model config)
CRITERIA = {
    "levenshtein_loss": ("translation_lev", "levenshtein", "levenshtein_transformer",
                         {"max_ins": 8}),
    "nat_loss": ("translation_lev", "random_mask", "cmlm_transformer",
                 {"max_predicted_length": 16}),
    "nacrf_loss": ("translation_lev", "full_mask", "nacrf_transformer",
                   {"max_predicted_length": 16, "crf_lowrank": 4, "crf_beam": 8}),
    "insertion_loss": ("translation_ins", "levenshtein", "insertion_transformer", {}),
}


def _micro_batches(task):
    """Two micro-batches of three rows each of the split's first batch."""
    batch = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=6)
                      .next_epoch_itr(shuffle=False)))
    micro = []
    for rows in (slice(0, 3), slice(3, 6)):
        half = {k: v[rows] for k, v in batch.items() if isinstance(v, np.ndarray)}
        half["ntokens"] = float((half["target"] != 1).sum())
        half["nsentences"] = 3
        micro.append(half)
    return micro


def _jax_init(jm, micro):
    b = {k: jnp.asarray(v) for k, v in micro.items() if isinstance(v, np.ndarray)}
    cls = type(jm)
    if cls.__name__ == "LevenshteinTransformer":
        args = (b["src_tokens"], b["ins_input"], b["masked_tgt"], b["del_input"])
    elif cls.__name__ == "InsertionTransformer":
        args = (b["src_tokens"], b["ins_input"])
    else:
        args = (b["src_tokens"], b["masked_target"])
    kw = {"method": cls.init_everything} if hasattr(cls, "init_everything") else {}
    return jax.jit(lambda k: jm.init(k, *args, **kw))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("criterion", sorted(CRITERIA))
def test_two_updates_match_jax_train_step(data, criterion):
    """Two updates of two micro-batches each: loss, gnorm, lr and every
    parameter after each update against ``make_train_step``, from the same
    weights (a flax init at key 0)."""
    name, noise, arch, extra = CRITERIA[criterion]
    task, jax_task = _tasks(data, name, noise)
    micro = _micro_batches(task)
    for a, b in zip(micro, _micro_batches(jax_task)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model_cfg = {"arch": arch, **WIDTHS, **NO_DROPOUT, **extra}
    jm = jax_task.build_model(dict(model_cfg))
    weights = jax.tree_util.tree_map(np.asarray, _jax_init(jm, micro[0]))
    model = task.build_model(dict(model_cfg), device="cpu", train=True)
    model.load_state_dict(params_from_flax(weights, arch), strict=True)
    crit_cfg = {"_name": criterion, "label_smoothing": 0.1}
    sched = jax_build_lr_schedule(SCHED_CFG)
    tx = jax_build_optimizer(OPT_CFG, sched)
    jax_step = make_train_step(jm, JAX_CRITERIONS.get(criterion)({**crit_cfg, "padding_idx": 1}),
                               tx, accum_steps=2, lr_schedule=sched, donate=False)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, weights), tx)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]
               if k not in ("nsentences", "id")}
    step = TrainStep(model, task.build_criterion(crit_cfg),
                     build_optimizer(OPT_CFG, list(model.parameters())),
                     build_lr_schedule(SCHED_CFG), compute_dtype=torch.float32)
    for update in range(2):
        state, want = jax_step(state, stacked, jax.random.PRNGKey(update))
        got = step(micro)
        for k in ("loss", "sample_size_total", "gnorm", "lr"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        lr = max(got["lr"], LR)
        for k, w in params_from_flax(numpy_tree(state.params), arch).items():
            np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(),
                                       atol=1e-4 * lr, rtol=2.0 ** -22,
                                       err_msg=f"update {update}: {k}")
