"""Learning-rate schedules (counterpart of chimera_st_tpu/optim/
lr_schedulers.py): functions update count -> lr, registered by name, value
for value the JAX package's: ``fixed``, ``inverse_sqrt``, ``cosine``,
``polynomial_decay``, ``tri_stage``, ``triangular`` and
``reduce_lr_on_plateau``.

The step evaluates a schedule at the number of updates applied so far, as
optax does at the optimizer's count before it increments: with a warm-up,
the first update runs at ``warmup_init_lr`` (0 unless set). A schedule
takes the count as a Python int (-> a float) or as an integer tensor (the
train step's count on the device; -> an fp64 tensor there, computed
without reading the device).

``reduce_lr_on_plateau`` (``PlateauSchedule``) keeps host state: the train
CLI calls ``step_val`` after each validation, and the state goes into the
checkpoint's extra state under ``lr_scheduler``. The step takes the
learning rate from the schedule at every update, so a shrink needs no other
hook (the JAX trainer re-jits its apply step).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..config.registry import LR_SCHEDULERS, register_lr_scheduler


def _warmup_init(cfg: Dict, warmup: int, lr: float) -> float:
    """The CLI's -1 sentinel: 0 with a warm-up, else lr."""
    init = float(cfg.get("warmup_init_lr", -1))
    if init < 0:
        init = 0.0 if warmup > 0 else lr
    return init


def _on_count(fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable:
    """A schedule of an fp64 count tensor -> one that takes an int (and
    returns a float) or an integer tensor (and returns an fp64 tensor on
    its device)."""

    def sched(step):
        if torch.is_tensor(step):
            return fn(step.double())
        return float(fn(torch.tensor(float(step), dtype=torch.float64)))

    return sched


@register_lr_scheduler("fixed")
def fixed(cfg: Dict) -> Callable[[int], float]:
    lr = float(cfg.get("lr", 0.25))
    warmup = int(cfg.get("warmup_updates", 0))
    init = _warmup_init(cfg, warmup, lr)

    def sched(s):
        if warmup <= 0:
            return torch.full_like(s, lr)
        return torch.where(s < warmup, init + (lr - init) * s.clamp(max=warmup) / warmup, lr)

    return _on_count(sched)


@register_lr_scheduler("inverse_sqrt")
def inverse_sqrt(cfg: Dict) -> Callable[[int], float]:
    """Linear warm-up from ``warmup_init_lr`` to ``lr`` over
    ``warmup_updates``, then ``lr * sqrt(warmup) / sqrt(step)``."""
    lr = float(cfg.get("lr", 5e-4))
    warmup = int(cfg.get("warmup_updates", 4000))
    init = _warmup_init(cfg, warmup, lr)
    lr_step = (lr - init) / max(warmup, 1)
    decay_factor = lr * math.sqrt(max(warmup, 1))

    def sched(s):
        return torch.where(s < warmup, init + s * lr_step,
                           decay_factor * s.clamp(min=1.0) ** -0.5)

    return _on_count(sched)


@register_lr_scheduler("cosine")
def cosine(cfg: Dict) -> Callable[[int], float]:
    """Cosine with warm restarts (JAX ``lr_schedulers.py:60-113``): each
    ``lr_period_updates`` period (by default ``max_update`` - warm-up)
    restarts the cosine between ``min_lr`` (default ``lr``) and ``max_lr``
    (default ``lr``), shrunk by ``lr_shrink ** i`` and stretched by
    ``t_mult ** i``; the warm-up starts at ``warmup_init_lr`` (the -1
    sentinel: ``lr``)."""
    lr = float(cfg.get("lr", 5e-4))
    max_lr = float(cfg.get("max_lr", lr))
    min_lr = float(cfg.get("min_lr", lr))
    warmup = int(cfg.get("warmup_updates", 0))
    warmup_init = float(cfg.get("warmup_init_lr", -1))
    if warmup_init < 0:
        warmup_init = lr
    period = float(cfg.get("lr_period_updates") or -1)
    if period <= 0:
        max_update = float(cfg.get("max_update") or 0)
        if max_update <= 0:
            raise ValueError("cosine needs --lr-period-updates or a positive --max-update "
                             "(the period is max_update - warmup_updates)")
        period = max(max_update - warmup, 1.0)
    t_mult = float(cfg.get("t_mult", 1.0))
    lr_shrink = float(cfg.get("lr_shrink", 0.1))
    lr_step = (max_lr - warmup_init) / warmup if warmup > 0 else 1.0

    def sched(s):
        curr = (s - warmup).clamp(min=0.0)
        if t_mult != 1.0:
            i = torch.floor(torch.log1p(-curr / period * (1.0 - t_mult)) / math.log(t_mult))
            t_i = t_mult ** i * period
            t_curr = curr - (1.0 - t_mult ** i) / (1.0 - t_mult) * period
        else:
            i = torch.floor(curr / period)
            t_i = period
            t_curr = curr - period * i
        shrink = lr_shrink ** i
        mn, mx = min_lr * shrink, max_lr * shrink
        cos = mn + 0.5 * (mx - mn) * (1.0 + torch.cos(math.pi * t_curr / t_i))
        return torch.where(s < warmup, warmup_init + s * lr_step, cos)

    return _on_count(sched)


@register_lr_scheduler("polynomial_decay")
def polynomial_decay(cfg: Dict) -> Callable[[int], float]:
    """Linear warm-up from 0, then ``(lr - end_learning_rate) * frac **
    power + end_learning_rate`` down to ``total_num_update``."""
    lr = float(cfg.get("lr", 5e-4))
    warmup = int(cfg.get("warmup_updates", 0))
    total = float(cfg.get("total_num_update") or 100000)
    end_lr = float(cfg.get("end_learning_rate", 0.0))
    power = float(cfg.get("power", 1.0))

    def sched(s):
        warm = lr * s.clamp(max=max(warmup, 1)) / max(warmup, 1)
        frac = ((total - s) / max(total - warmup, 1.0)).clamp(0.0, 1.0)
        return torch.where(s < warmup, warm, (lr - end_lr) * frac ** power + end_lr)

    return _on_count(sched)


@register_lr_scheduler("tri_stage")
def tri_stage(cfg: Dict) -> Callable[[int], float]:
    """Warm-up from ``lr * init_lr_scale``, hold at ``lr``, exponential decay
    to ``lr * final_lr_scale``, over ``phase_ratio`` of ``max_update``."""
    peak = float(cfg.get("lr", 5e-4))
    init_scale = float(cfg.get("init_lr_scale", 0.01))
    final_scale = float(cfg.get("final_lr_scale", 0.01))
    w, h, d = cfg.get("phase_ratio", None) or (0.1, 0.4, 0.5)
    total = float(cfg.get("max_update") or 0)
    if total <= 0:
        raise ValueError("tri_stage needs a positive --max-update (the schedule is "
                         "defined as fractions of the total update budget)")
    warmup, hold, decay = total * w, total * h, total * d
    init_lr = peak * init_scale

    def sched(s):
        lr_warm = init_lr + (peak - init_lr) * (s / max(warmup, 1)).clamp(max=1.0)
        in_decay = ((s - warmup - hold) / max(decay, 1)).clamp(0.0, 1.0)
        lr_decay = peak * torch.exp(math.log(final_scale) * in_decay)
        return torch.where(s < warmup, lr_warm,
                           torch.where(s < warmup + hold, torch.full_like(s, peak), lr_decay))

    return _on_count(sched)


@register_lr_scheduler("triangular")
def triangular(cfg: Dict) -> Callable[[int], float]:
    """Between ``lr`` and ``max_lr`` (default 10 ``lr``) and back each
    ``lr_period_updates``, the peak (and with ``shrink_min`` the floor)
    shrunk by ``lr_shrink`` each cycle."""
    min_lr = float(cfg.get("lr", 1e-5))
    max_lr = float(cfg.get("max_lr", min_lr * 10))
    period = float(cfg.get("lr_period_updates", 5000))
    stepsize = max(period / 2.0, 1.0)
    lr_shrink = float(cfg.get("lr_shrink", 0.1))
    shrink_min = bool(cfg.get("shrink_min", False))

    def sched(s):
        cycle = torch.floor(s / (2 * stepsize))
        shrink = lr_shrink ** cycle
        mx = max_lr * shrink
        mn = min_lr * shrink if shrink_min else torch.full_like(mx, min_lr)
        x = (s / stepsize - 2 * cycle - 1).abs()
        return mn + (mx - mn) * (1.0 - x).clamp(min=0.0)

    return _on_count(sched)


class PlateauSchedule:
    """``reduce_lr_on_plateau`` (JAX ``lr_schedulers.py:183-248``): ``lr``
    times a scale that shrinks by ``lr_shrink`` once a validation metric
    has failed to improve by ``lr_threshold`` more than ``lr_patience``
    times in a row; a linear warm-up from ``warmup_init_lr`` first."""

    def __init__(self, cfg: Dict):
        self.lr = float(cfg.get("lr", 5e-4))
        self.shrink = float(cfg.get("lr_shrink", 0.1))
        self.threshold = float(cfg.get("lr_threshold", 1e-4))
        self.patience = int(cfg.get("lr_patience", 0))
        self.maximize = bool(cfg.get("maximize_best_checkpoint_metric", False))
        self.warmup = int(cfg.get("warmup_updates", 0))
        self.warmup_init = _warmup_init(cfg, self.warmup, self.lr)
        self.scale = 1.0
        self._best: Optional[float] = None
        self._bad = 0
        self._sched = _on_count(self._at)

    def step_val(self, val_metric) -> bool:
        """After a validation: True where the scale shrank."""
        if val_metric is None:
            return False
        better = (self._best is None
                  or (self.maximize and val_metric > self._best + self.threshold)
                  or (not self.maximize and val_metric < self._best - self.threshold))
        if better:
            self._best, self._bad = val_metric, 0
            return False
        self._bad += 1
        if self._bad > self.patience:
            self.scale *= self.shrink
            self._bad = 0
            return True
        return False

    def state_dict(self) -> Dict:
        return {"scale": self.scale, "best": self._best, "bad": self._bad}

    def load_state_dict(self, d: Dict) -> None:
        self.scale = d.get("scale", 1.0)
        self._best = d.get("best")
        self._bad = d.get("bad", 0)

    def _at(self, s):
        lr = self.lr * self.scale
        if self.warmup > 0:
            warm = self.warmup_init + (lr - self.warmup_init) * s.clamp(max=self.warmup) \
                / self.warmup
            return torch.where(s < self.warmup, warm, lr)
        return torch.full_like(s, lr)

    def __call__(self, step):
        return self._sched(step)


@register_lr_scheduler("reduce_lr_on_plateau")
def reduce_lr_on_plateau(cfg: Dict) -> PlateauSchedule:
    return PlateauSchedule(cfg)


def build_lr_schedule(cfg: Dict) -> Callable[[int], float]:
    return LR_SCHEDULERS.get(cfg.get("_name", "fixed"))(cfg)
