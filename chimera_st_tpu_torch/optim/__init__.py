"""Optimizers and learning-rate schedules of the triplet fine-tune
(counterpart of chimera_st_tpu/optim/, the parts the recipe uses)."""

from .lr_schedulers import build_lr_schedule
from .optimizers import Optimizer, build_optimizer, clip_by_global_norm_

__all__ = ["Optimizer", "build_lr_schedule", "build_optimizer", "clip_by_global_norm_"]
