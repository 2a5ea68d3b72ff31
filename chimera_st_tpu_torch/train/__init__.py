"""The training step (counterpart of chimera_st_tpu/train/train_step.py).
The Trainer, the checkpoint write side and the train CLI wait for ROADMAP
A10."""

from .train_step import (
    TrainStep,
    apply_gradients,
    global_norm,
    microbatch_grad,
    prepare_batch,
    valid_step,
)

__all__ = ["TrainStep", "apply_gradients", "global_norm", "microbatch_grad", "prepare_batch",
           "valid_step"]
