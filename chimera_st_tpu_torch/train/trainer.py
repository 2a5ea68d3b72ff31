"""Trainer: the update loop's bookkeeping around ``TrainStep`` (counterpart
of chimera_st_tpu/train/trainer.py).

- ``train_step(microbatches, seed)``: one accumulated update, then
  ``_record_update``: the criterion's loss-like keys over the sample size in
  bits into the metrics, the other numeric keys as they are, the gradient
  norm, the learning rate of ``schedule(updates - 1)`` and the ``ups`` /
  ``wps`` rates. On a skipped (non-finite) update it names the parameters
  whose gradient is not finite.
- ``valid_step(batch)``: the criterion's logging in eval mode.
- ``extra_state`` / ``load_extra_state``: the meters, the training time and
  the iterator position, restored as three independent concerns
  (``--reset-meters``, ``--reset-dataloader``; the lr schedules ported keep
  no state).
- ``host_state`` / ``load_params`` / ``load_opt_state``: the interlingua
  model's parameters and Adam state as the JAX checkpoint's trees
  (``convert``).

The port's step reads the host once an update, so the JAX trainer's
deferred-metrics dispatch (``async_depth`` > 0) is not ported.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..checkpoint.store import TrainState
from ..logging import metrics as metrics_mod
from .train_step import TrainStep, prepare_batch, valid_step

logger = logging.getLogger(__name__)


def nonfinite_grad_names(model: torch.nn.Module) -> List[str]:
    """Names of the parameters whose gradient holds a NaN or an infinity."""
    return [n for n, p in model.named_parameters()
            if p.grad is not None and not bool(torch.isfinite(p.grad).all())]


class Trainer:
    def __init__(self, model, criterion: Callable, optimizer, lr_schedule: Callable[[int], float],
                 compute_dtype=torch.bfloat16, async_depth: int = 0):
        if async_depth > 0:
            raise NotImplementedError("--async-dispatch above 0 (deferred metrics) is not "
                                      "ported yet (ROADMAP A10b); pass --async-dispatch 0")
        self.model, self.criterion, self.optimizer = model, criterion, optimizer
        self.lr_schedule = lr_schedule
        self.step = TrainStep(model, criterion, optimizer, lr_schedule, compute_dtype)
        self.cumulative_training_time = 0.0

    @property
    def num_updates(self) -> int:
        return self.step.num_updates

    def set_num_updates(self, n: int) -> None:
        self.step.num_updates = int(n)

    # ------------------------------------------------------------- stepping

    def train_step(self, microbatches: List[Dict[str, Any]], seed: int = 0) -> Dict[str, Any]:
        """One optimizer update over ``microbatches``; ``seed`` keys its
        dropout masks."""
        t0 = time.time()
        m = self.step(microbatches, seed)
        self.cumulative_training_time += time.time() - t0
        out = {k: v for k, v in m.items()
               if k not in ("lr", "nonfinite_grad", "sample_size_total", "gnorm")}
        return self._record_update(out, m["gnorm"], not m["nonfinite_grad"],
                                   m["sample_size_total"], self.num_updates)

    def _record_update(self, out, gnorm, finite, total_ss, num_updates):
        """Bookkeeping of one completed update; ``num_updates`` is the count
        after it."""
        out = dict(out)
        out["gnorm"] = gnorm
        if not finite:
            bad = nonfinite_grad_names(self.model)
            logger.warning(
                f"non-finite gradient norm at update {num_updates}; "
                f"update skipped; non-finite leaves: {bad[:8]}"
                + (f" (+{len(bad) - 8} more)" if len(bad) > 8 else "")
            )
            out["nonfinite_grad"] = 1.0
        if self.lr_schedule is not None:
            out["lr"] = float(self.lr_schedule(max(num_updates - 1, 0)))
        ss = max(total_ss, 1.0)
        # every criterion's loss-like keys reach the metrics
        skip_keys = {"gnorm", "lr", "nonfinite_grad", "sample_size",
                     "sample_size_total", "ntokens", "nsentences"}
        for key, v in sorted(out.items()):
            if key in skip_keys:
                continue
            if key.endswith("loss") or key.endswith("_nll"):
                metrics_mod.log_scalar(key, float(v) / ss / np.log(2), ss, round=3)
            elif np.ndim(v) == 0 and np.issubdtype(np.asarray(v).dtype, np.number):
                metrics_mod.log_scalar(key, float(v), priority=200, round=3)
        metrics_mod.log_scalar("gnorm", out["gnorm"], priority=400, round=3)
        if "lr" in out:
            metrics_mod.log_scalar("lr", out["lr"], priority=300)
        metrics_mod.log_speed("ups", 1.0, priority=100)
        if "ntokens" in out:
            metrics_mod.log_speed("wps", float(out["ntokens"]), priority=90)
        return out

    def valid_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """The criterion's logging on ``batch`` in eval mode, at the
        training compute dtype."""
        with self.step.autocast():
            return valid_step(self.model, self.criterion,
                              prepare_batch(batch, self.step.device))

    # ----------------------------------------------------------- persistence

    def host_state(self, save_optimizer: bool = True) -> TrainState:
        """Parameters and (unless not wanted) Adam state as the JAX
        checkpoint's trees, copied to the host once."""
        from ..convert import params_to_flax

        params = params_to_flax(self.model.state_dict())
        opt = self.optimizer.state_to_optax(self.model, self.num_updates) if save_optimizer \
            else None
        return TrainState(self.num_updates, params, opt)

    def load_params(self, tree: Dict[str, Any]) -> None:
        from ..convert import params_from_flax

        self.model.load_state_dict(params_from_flax(tree), strict=True)

    def load_opt_state(self, tree: Dict[str, Any]) -> None:
        self.optimizer.load_optax(tree, self.model)

    def extra_state(self, epoch_itr=None, val_loss=None, best=None) -> Dict[str, Any]:
        ex: Dict[str, Any] = {
            "metrics": metrics_mod.state_dict(),
            "previous_training_time": self.cumulative_training_time,
            "val_loss": val_loss,
            "best": best,
        }
        if epoch_itr is not None:
            ex["train_iterator"] = epoch_itr.state_dict()
        return ex

    def load_extra_state(self, extra: Dict[str, Any], epoch_itr=None,
                         load_meters: bool = True) -> None:
        """Restores the meters and the training time (unless
        ``--reset-meters``) and the iterator position (given ``epoch_itr``,
        i.e. unless ``--reset-dataloader``)."""
        if load_meters and "metrics" in extra:
            try:
                metrics_mod.load_state_dict(extra["metrics"])
            except Exception:  # metrics format drift is non-fatal
                logger.warning("could not restore metrics state")
        if load_meters:
            self.cumulative_training_time = extra.get("previous_training_time", 0.0)
        if epoch_itr is not None and "train_iterator" in extra:
            epoch_itr.load_state_dict(extra["train_iterator"])
