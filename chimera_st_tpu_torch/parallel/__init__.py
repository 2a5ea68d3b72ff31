"""Several cards over ``torch.distributed`` (counterpart of
chimera_st_tpu/parallel/): rank grids, tensor parallelism and ZeRO-1, the
data-parallel gradient sum, the GPipe schedule and ring attention. Nothing
here imports ``jax``."""

from .mesh import Mesh, initialize_distributed, make_mesh, make_pipeline_mesh, spawn
from .partition import (
    TP_RULES,
    ZeroOptimizer,
    apply_tensor_parallel,
    gather_state_dict,
    shard_batch,
    shard_state_dict,
    split_batch,
)
from .pipeline import (
    make_layer_stage_fn,
    microbatch,
    pipeline_apply,
    pipeline_bubble_fraction,
    pipelined_layer_stack,
    stack_stage_params,
)
from .reducer import GradientReducer
from .ring_attention import ring_self_attention

__all__ = [
    "Mesh", "initialize_distributed", "make_mesh", "make_pipeline_mesh", "spawn", "TP_RULES",
    "ZeroOptimizer", "apply_tensor_parallel", "gather_state_dict", "shard_batch",
    "shard_state_dict", "split_batch", "make_layer_stage_fn", "microbatch", "pipeline_apply",
    "pipeline_bubble_fraction", "pipelined_layer_stack", "stack_stage_params",
    "ring_self_attention", "GradientReducer",
]
