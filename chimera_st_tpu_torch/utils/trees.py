"""Parameter counts (counterpart of chimera_st_tpu/utils/trees.py): over a
module's parameters or the tensors and arrays of a ``state_dict``-like
mapping, nested or flat."""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def param_count(tree: Any) -> int:
    """The number of elements of every tensor or array in ``tree``."""
    return sum(int(np.prod(x.shape)) for x in _leaves(tree))


def tree_size_bytes(tree: Any) -> int:
    """Their bytes in their own dtypes."""
    return sum(int(np.prod(x.shape)) * (x.element_size() if torch.is_tensor(x)
                                        else np.dtype(x.dtype).itemsize)
               for x in _leaves(tree))
