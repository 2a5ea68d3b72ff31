"""Trainer: the update loop's bookkeeping around ``TrainStep`` (counterpart
of chimera_st_tpu/train/trainer.py).

- ``train_step(microbatches, seed)``: one accumulated update, then
  ``_record_update``: the criterion's loss-like keys over the sample size in
  bits into the metrics, the other numeric keys as they are, the gradient
  norm, the learning rate of ``schedule(updates - 1)`` and the ``ups`` /
  ``wps`` rates. On a skipped (non-finite) update it names the parameters
  whose gradient is not finite.
- ``async_depth`` > 0 (``--async-dispatch``): ``train_step`` only queues
  the update on the device and returns None; the results wait, and
  ``drain_metrics`` reads them all at once and records them in order. At
  most ``async_depth`` updates are in flight: one more waits for the
  oldest. ``num_updates`` counts every queued update until a drain
  reconciles it with the skipped ones, as the JAX trainer's mirror does.
  The learning rate and the criterion's update count come from the step's
  exact count on the device, as the JAX step's do, so the logged lines,
  the parameters and the count equal depth 0, a skipped update included.
  The one thing keyed by the mirror is the dropout seed the CLI passes
  (``--seed`` + ``num_updates``, as the JAX CLI passes it): with dropout
  on, the updates queued behind a skipped one draw the masks of the next
  count until a drain, in both packages.
- ``valid_step(batch)``: the criterion's logging in eval mode (a joint
  task's batch carries its ``task_name`` to the criterion).
- ``extra_state`` / ``load_extra_state``: the meters, the training time,
  ``reduce_lr_on_plateau``'s state (``lr_scheduler``) and the iterator
  position, restored as independent concerns (``--reset-meters``,
  ``--reset-lr-scheduler``, ``--reset-dataloader``).
- ``host_state`` / ``load_params`` / ``load_opt_state``: the model's
  parameters and optimizer state as the JAX checkpoint's trees, through
  the converter table of its type (``convert.model_kind``: the interlingua
  model, ``transformer``, ``transformer_lm`` or ``transformer_lm_char``) and
  the optimizer's optax layout (``convert.OPTAX_CHAINS``). Under tensor
  parallelism the shards are gathered over the ``model`` ranks on save and
  split again on load (collectives: every rank calls them; the lead rank
  writes).
- ``mesh`` (several ranks): ``TrainStep``'s batch split and all-reduce.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.store import TrainState
from ..logging import metrics as metrics_mod
from .train_step import TrainStep, prepare_batch, valid_step

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, model, criterion: Callable, optimizer, lr_schedule: Callable[[int], float],
                 compute_dtype=torch.bfloat16, async_depth: int = 0, mesh=None,
                 pad: Optional[int] = None):
        self.model, self.criterion, self.optimizer = model, criterion, optimizer
        self.lr_schedule = lr_schedule
        self.step = TrainStep(model, criterion, optimizer, lr_schedule, compute_dtype,
                              mesh=mesh, pad=pad)
        self.cumulative_training_time = 0.0
        self.async_depth = int(async_depth)
        self._deferred: List[Dict[str, Any]] = []
        self._waited = 0  # deferred updates known to be done on the device
        self._base_updates = 0  # the exact count before the first deferred update

    @property
    def num_updates(self) -> int:
        return self.step.num_updates

    def set_num_updates(self, n: int) -> None:
        self.step.num_updates = int(n)

    # ------------------------------------------------------------- stepping

    def train_step(self, microbatches: List[Dict[str, Any]], seed: int = 0):
        """One optimizer update over ``microbatches``; ``seed`` keys its
        dropout masks. -> its recorded metrics, or None when the update is
        deferred (``async_depth`` > 0)."""
        t0 = time.time()
        if self.async_depth > 0 and not self._deferred:
            self._base_updates = self.num_updates
        pending = self.step.dispatch(microbatches, seed)
        self.cumulative_training_time += time.time() - t0
        if self.async_depth > 0:
            if pending["values"].is_cuda:
                pending["done"] = torch.cuda.Event()
                pending["done"].record()
            self._deferred.append(pending)
            if len(self._deferred) - self._waited > self.async_depth:
                done = self._deferred[self._waited].get("done")
                if done is not None:
                    done.synchronize()
                self._waited += 1
            return None
        return self._record_update(self.step.collect(pending), self.num_updates)

    def drain_metrics(self):
        """Reads every deferred update's results and records them in the
        order they were queued; reconciles ``num_updates`` with the skipped
        ones. -> the last update's metrics, or None if none was deferred."""
        if not self._deferred:
            return None
        entries, self._deferred, self._waited = self._deferred, [], 0
        n, out = self._base_updates, None
        for pending in entries:
            m = self.step.collect(pending)
            n += 0 if m["nonfinite_grad"] else 1
            out = self._record_update(m, n)
        if n != self.num_updates:
            raise AssertionError(f"update count {self.num_updates} after a drain, {n} applied")
        return out

    def _record_update(self, m: Dict[str, Any], num_updates: int) -> Dict[str, Any]:
        """Bookkeeping of one completed update from its collected metrics
        ``m``; ``num_updates`` is the count after it."""
        out = {k: v for k, v in m.items()
               if k not in ("lr", "nonfinite_grad", "sample_size_total", "nonfinite_names")}
        if m["nonfinite_grad"]:
            bad = m["nonfinite_names"]
            logger.warning(
                f"non-finite gradient norm at update {num_updates}; "
                f"update skipped; non-finite leaves: {bad[:8]}"
                + (f" (+{len(bad) - 8} more)" if len(bad) > 8 else "")
            )
            out["nonfinite_grad"] = 1.0
        if self.lr_schedule is not None:
            out["lr"] = float(self.lr_schedule(max(num_updates - 1, 0)))
        ss = max(m["sample_size_total"], 1.0)
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
        """Parameters and (unless not wanted) optimizer state as the JAX
        checkpoint's trees, copied to the host once."""
        from ..convert import model_kind, params_to_flax
        from ..parallel.partition import gather_state_dict

        params = params_to_flax(gather_state_dict(self.model, self.model.state_dict()),
                                model_kind(self.model))
        opt = self.optimizer.state_to_optax(self.model, self.num_updates) if save_optimizer \
            else None
        return TrainState(self.num_updates, params, opt)

    def load_params(self, tree: Dict[str, Any]) -> None:
        from ..convert import model_kind, params_from_flax
        from ..parallel.partition import shard_state_dict

        self.model.load_state_dict(
            shard_state_dict(self.model, params_from_flax(tree, model_kind(self.model))),
            strict=True)

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
        if hasattr(self.lr_schedule, "state_dict"):
            # reduce_lr_on_plateau's scale, best metric and bad count
            ex["lr_scheduler"] = self.lr_schedule.state_dict()
        return ex

    def load_extra_state(self, extra: Dict[str, Any], epoch_itr=None,
                         load_meters: bool = True, load_lr_scheduler: bool = True) -> None:
        """Restores the meters and the training time (unless
        ``--reset-meters``), a stateful schedule's state (unless
        ``--reset-lr-scheduler``) and the iterator position (given
        ``epoch_itr``, i.e. unless ``--reset-dataloader``)."""
        if load_meters and "metrics" in extra:
            try:
                metrics_mod.load_state_dict(extra["metrics"])
            except Exception:  # metrics format drift is non-fatal
                logger.warning("could not restore metrics state")
        if load_meters:
            self.cumulative_training_time = extra.get("previous_training_time", 0.0)
        if (load_lr_scheduler and "lr_scheduler" in extra
                and hasattr(self.lr_schedule, "load_state_dict")):
            self.lr_schedule.load_state_dict(extra["lr_scheduler"])
        if epoch_itr is not None and "train_iterator" in extra:
            epoch_itr.load_state_dict(extra["train_iterator"])
