"""Small helpers (counterpart of chimera_st_tpu/utils/): padding masks and
parameter counts."""

from .masking import lengths_to_padding_mask, padding_mask_to_lengths
from .trees import param_count, tree_size_bytes

__all__ = ["lengths_to_padding_mask", "padding_mask_to_lengths", "param_count",
           "tree_size_bytes"]
