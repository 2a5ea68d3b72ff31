"""Learning-rate schedules (counterpart of chimera_st_tpu/optim/
lr_schedulers.py): functions update count -> lr, registered by name.

The step evaluates a schedule at the number of updates applied so far, as
optax does at the optimizer's count before it increments: with a warm-up,
the first update runs at ``warmup_init_lr`` (0 unless set). A schedule
also takes the count as an integer tensor (the train step's count on the
device) and then returns an fp64 tensor there, without reading the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..config.registry import LR_SCHEDULERS, register_lr_scheduler


def _warmup_init(cfg: Dict, warmup: int, lr: float) -> float:
    """The CLI's -1 sentinel: 0 with a warm-up, else lr."""
    init = float(cfg.get("warmup_init_lr", -1))
    if init < 0:
        init = 0.0 if warmup > 0 else lr
    return init


@register_lr_scheduler("fixed")
def fixed(cfg: Dict) -> Callable[[int], float]:
    lr = float(cfg.get("lr", 0.25))
    warmup = int(cfg.get("warmup_updates", 0))
    init = _warmup_init(cfg, warmup, lr)

    def sched(step):
        if torch.is_tensor(step):
            s = step.double()
            if warmup <= 0:
                return torch.full_like(s, lr)
            return torch.where(s < warmup, init + (lr - init) * s.clamp(max=warmup) / warmup,
                               lr)
        if warmup > 0 and step < warmup:
            return init + (lr - init) * min(step, warmup) / warmup
        return lr

    return sched


@register_lr_scheduler("inverse_sqrt")
def inverse_sqrt(cfg: Dict) -> Callable[[int], float]:
    """Linear warm-up from ``warmup_init_lr`` to ``lr`` over
    ``warmup_updates``, then ``lr * sqrt(warmup) / sqrt(step)``."""
    lr = float(cfg.get("lr", 5e-4))
    warmup = int(cfg.get("warmup_updates", 4000))
    init = _warmup_init(cfg, warmup, lr)
    lr_step = (lr - init) / max(warmup, 1)
    decay_factor = lr * math.sqrt(max(warmup, 1))

    def sched(step):
        if torch.is_tensor(step):
            s = step.double()
            return torch.where(s < warmup, init + s * lr_step,
                               decay_factor * s.clamp(min=1.0) ** -0.5)
        if step < warmup:
            return init + step * lr_step
        return decay_factor * max(step, 1.0) ** -0.5

    return sched


def build_lr_schedule(cfg: Dict) -> Callable[[int], float]:
    return LR_SCHEDULERS.get(cfg.get("_name", "fixed"))(cfg)
