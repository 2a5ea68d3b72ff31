"""The training step and the trainer (counterpart of chimera_st_tpu/train/)."""

from .train_step import (
    TrainStep,
    apply_gradients,
    global_norm,
    microbatch_grad,
    microbatch_seed,
    prepare_batch,
    valid_step,
)
from .trainer import Trainer

__all__ = ["TrainStep", "Trainer", "apply_gradients", "global_norm", "microbatch_grad",
           "microbatch_seed", "prepare_batch", "valid_step"]
