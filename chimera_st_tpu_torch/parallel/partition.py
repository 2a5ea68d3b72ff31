"""Tensor parallelism, ZeRO-1 and the batch split over the ranks of a mesh
(counterpart of chimera_st_tpu/parallel/partition.py).

The JAX package writes these as sharding annotations and lets XLA insert
the collectives; here they are explicit:

- ``TP_RULES`` (Megatron): the q / k / v projections and ``fc1`` split their
  output over the ``model`` ranks (column parallel: each rank holds a slice
  of the heads or of the hidden units), ``out_proj`` and ``fc2`` their input
  (row parallel), followed by an all-reduce over the ``model`` ranks and the
  bias. ``apply_tensor_parallel`` swaps those layers of a model for
  ``ColumnParallelLinear`` / ``RowParallelLinear``, which keep the
  parameter names; a layer whose heads or hidden units do not divide stays
  whole. ``gather_state_dict`` / ``shard_state_dict`` carry a state dict
  between the whole model and a rank's shards.
- ``ZeroOptimizer`` (``--zero-sharding os``): each data rank keeps the
  optimizer state of one slice of each parameter, on the first axis that
  divides by the data ranks (the JAX layout's rule; Adam is elementwise, so
  the axis does not change a number), steps that slice and all-gathers the
  updated parameter. A TP shard is sliced again, so the TP split stays.
- ``shard_batch``: every rank builds the same global batch (the JAX
  invariant of its ``lead_process`` CLI) and takes its data rank's slice of
  the leading axis, with ``ntokens`` / ``nsentences`` counted on the
  slice. Where the batch does not divide, or its ``ntokens`` is not the
  count of its target's non-pad tokens, every data rank keeps the whole
  batch at weight ``1 / data ranks``, so that the sums over the ranks are
  still the global batch's. ``BATCH_PATHS`` counts the batches of each
  path (``cli.generate``'s split too), and rank 0 logs a warning at the
  first batch run whole: the data ranks then repeat each other's work.
"""

from __future__ import annotations

import logging
import re
from collections import Counter
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .mesh import Mesh, all_reduce_, is_lead

logger = logging.getLogger(__name__)

# batches by path: "train_sliced" / "train_whole" (shard_batch),
# "decode_sliced" / "decode_whole" (cli.generate)
BATCH_PATHS: Counter = Counter()

# (state-dict name pattern, the axis split over the model ranks or None)
TP_RULES = [
    (r"(q_proj|k_proj|v_proj)\.weight$", 0),
    (r"(q_proj|k_proj|v_proj)\.bias$", 0),
    (r"out_proj\.weight$", 1),
    (r"out_proj\.bias$", None),
    (r"fc1\.weight$", 0),
    (r"fc1\.bias$", 0),
    (r"fc2\.weight$", 1),
    (r"fc2\.bias$", None),
]


def tp_axis(name: str) -> Optional[int]:
    for rx, axis in TP_RULES:
        if re.search(rx, name):
            return axis
    return None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (the input of
    a column-parallel layer is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        return all_reduce_(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _slice(t: torch.Tensor, axis: int, index: int, n: int) -> torch.Tensor:
    size = t.shape[axis] // n
    return t.narrow(axis, index * size, size)


class ColumnParallelLinear(nn.Module):
    """This rank's rows of a linear layer's output (``weight`` [out / n, in])."""

    def __init__(self, linear: nn.Linear, index: int, n: int, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(_slice(linear.weight.detach(), 0, index, n).clone())
        self.bias = None if linear.bias is None else nn.Parameter(
            _slice(linear.bias.detach(), 0, index, n).clone())

    def forward(self, x):
        return F.linear(_CopyToGroup.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's columns of a linear layer's input (``weight`` [out, in /
    n]); the partial products summed over the group, then the bias."""

    def __init__(self, linear: nn.Linear, index: int, n: int, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(_slice(linear.weight.detach(), 1, index, n).clone())
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def forward(self, x):
        y = _ReduceFromGroup.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def apply_tensor_parallel(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Splits the model's attention and feed-forward layers over the
    ``model`` ranks in place -> {parameter name: its split axis}."""
    from ..models.layers import MultiheadAttention

    n = mesh.shape.get("model", 1)
    if n == 1:
        return {}
    index, group = mesh.index("model"), mesh.group("model")
    for module in model.modules():
        if isinstance(module, MultiheadAttention) and module.num_heads % n == 0:
            for name in ("q_proj", "k_proj", "v_proj"):
                setattr(module, name, ColumnParallelLinear(getattr(module, name), index, n,
                                                           group))
            module.out_proj = RowParallelLinear(module.out_proj, index, n, group)
            module.num_heads //= n
        fc1, fc2 = getattr(module, "fc1", None), getattr(module, "fc2", None)
        if isinstance(fc1, nn.Linear) and isinstance(fc2, nn.Linear) \
                and fc1.out_features % n == 0:
            module.fc1 = ColumnParallelLinear(fc1, index, n, group)
            module.fc2 = RowParallelLinear(fc2, index, n, group)
    split = {name: tp_axis(name) for name, p in model.named_parameters()
             if isinstance(_owner(model, name), (ColumnParallelLinear, RowParallelLinear))}
    model.tp_split = {k: a for k, a in split.items() if a is not None}
    model.tp_mesh = mesh
    return model.tp_split


def _owner(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rpartition(".")[0])


def _gather(t: torch.Tensor, axis: int, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def gather_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A rank's state dict (or any tensors keyed by parameter name) -> the
    whole model's, gathered over the ``model`` ranks (collective)."""
    split = getattr(model, "tp_split", {})
    if not split:
        return dict(state)
    mesh = model.tp_mesh
    n, group = mesh.shape["model"], mesh.group("model")
    return {k: _gather(v, split[k], group, n) if k in split and v is not None else v
            for k, v in state.items()}


def shard_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The whole model's state dict -> this rank's shards."""
    split = getattr(model, "tp_split", {})
    if not split:
        return dict(state)
    mesh = model.tp_mesh
    n, index = mesh.shape["model"], mesh.index("model")
    return {k: _slice(v, split[k], index, n).clone() if k in split and v is not None else v
            for k, v in state.items()}


def zero_axis(shape: Tuple[int, ...], n_data: int) -> Optional[int]:
    """The first axis that divides by ``n_data`` (and is at least that
    long): the axis a parameter's optimizer state is split on."""
    for i, d in enumerate(shape):
        if d % n_data == 0 and d >= n_data:
            return i
    return None


class ZeroOptimizer:
    """ZeRO-1 over the ``data`` ranks around an ``optim.Optimizer``: the
    wrapped optimizer steps this rank's slice of each parameter (a
    parameter with no dividing axis whole), and the updated slices are
    all-gathered into the parameters. Checkpoints hold the whole state,
    gathered on save and sliced on load."""

    def __init__(self, optimizer, params: List[nn.Parameter], mesh: Mesh, build):
        """``build(shards) -> optim.Optimizer`` makes the wrapped optimizer
        over the slices (the same config as ``optimizer``'s)."""
        self.mesh = mesh
        self.n = mesh.shape.get("data", 1)
        self.index, self.group = mesh.index("data"), mesh.group("data")
        self.clip_norm, self.frozen = optimizer.clip_norm, optimizer.frozen
        self.params = list(params)
        self.axes, self.shards = [], []
        # adafactor's factored moments are not elementwise: they stay whole
        factored = type(optimizer.optimizer).__name__ == "Adafactor"
        for p in self.params:
            axis = None if factored else zero_axis(tuple(p.shape), self.n)
            self.axes.append(axis)
            self.shards.append(p if axis is None else
                               nn.Parameter(_slice(p.detach(), axis, self.index, self.n).clone()))
        self.inner = build(self.shards)
        self.optimizer = self.inner.optimizer

    def _trained(self):
        return self.params

    @property
    def layout(self):
        return self.inner.layout

    @property
    def decoupled(self):
        return self.inner.decoupled

    def step(self, lr, g_norm: torch.Tensor, skip: Optional[torch.Tensor] = None) -> None:
        from ..optim.optimizers import clip_by_global_norm_

        if self.clip_norm > 0:
            clip_by_global_norm_([p.grad for p in self.params], self.clip_norm, g_norm)
        for p, shard, axis in zip(self.params, self.shards, self.axes):
            if axis is not None:
                shard.grad = _slice(p.grad, axis, self.index, self.n).contiguous()
        saved, self.inner.clip_norm = self.inner.clip_norm, 0.0
        try:
            self.inner.step(lr, g_norm, skip)
        finally:
            self.inner.clip_norm = saved
        with torch.no_grad():
            for p, shard, axis in zip(self.params, self.shards, self.axes):
                if axis is not None:
                    p.copy_(_gather(shard.detach(), axis, self.group, self.n)
                            if self.group is not None else shard.detach())

    def _whole_state(self) -> Dict[nn.Parameter, Dict[str, Any]]:
        """The wrapped optimizer's state as if it held the whole parameters:
        gathered over the data ranks (collective), keyed by the parameters."""
        by_shard = dict(zip(map(id, self.shards), zip(self.params, self.axes)))
        whole = {}
        for shard, state in self.inner.optimizer.state.items():
            p, axis = by_shard[id(shard)]
            whole[p] = {f: (_gather(v, axis, self.group, self.n)
                            if axis is not None and self.group is not None
                            and torch.is_tensor(v) and v.dim() > 0 else v)
                        for f, v in state.items()}
        return whole

    def state_to_optax(self, model: nn.Module, schedule_count: int):
        return _Whole(self).state_to_optax(model, schedule_count)

    def read_optax(self, tree: Any, model: nn.Module):
        return _Whole(self).read_optax(tree, model)

    def load_optax(self, tree: Any, model: nn.Module) -> int:
        got, count, schedule_count = self.read_optax(tree, model)
        got = {f: shard_state_dict(model, by_name) for f, by_name in got.items()}
        named = {id(p): n for n, p in model.named_parameters()}
        inner = self.inner.optimizer
        inner.state.clear()
        for p, shard, axis in zip(self.params, self.shards, self.axes):
            name = named[id(p)]

            def part(t):
                t = t if axis is None else _slice(t, axis, self.index, self.n)
                return t.clone().to(shard.device)

            if isinstance(inner, torch.optim.Adam):
                if count:
                    inner.state[shard] = {"step": torch.tensor(float(count)).to(shard.device),
                                          "exp_avg": part(got["mu"][name]),
                                          "exp_avg_sq": part(got["nu"][name])}
            else:
                for f in inner.fields:
                    inner.state[shard][f].copy_(part(got[f][name]))
        if not isinstance(inner, torch.optim.Adam):
            inner.count.fill_(count)
        return schedule_count


def _Whole(zero: ZeroOptimizer):
    """An ``optim.Optimizer`` over the whole parameters whose state is the
    ZeroOptimizer's, gathered: its converters' view of it."""
    from ..optim.optimizers import Optimizer

    class Whole(Optimizer):
        def _trained(self):
            return zero.params

        def _fields(self, model):
            inner = zero.inner.optimizer
            saved, inner.state = inner.state, zero._whole_state()
            try:
                return super()._fields(model)
            finally:
                inner.state = saved

    return Whole(zero.inner.optimizer, zero.clip_norm, zero.frozen)


def split_batch(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Tuple[Dict[str, Any], bool]:
    """This data rank's slice of every array of ``batch`` whose leading
    axis is the batch's -> (the slice, True); the batch itself and False
    without a grid or where the batch does not divide. (A world of one
    slices the whole batch: its gather still runs through the backend.)"""
    n = 1 if mesh is None else mesh.shape.get("data", 1)
    arrays = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))
              and v.ndim >= 1}
    sizes = {int(v.shape[0]) for v in arrays.values()}
    if mesh is None or mesh.group("data") is None or len(sizes) != 1 \
            or next(iter(sizes)) % n:
        return batch, False
    b, i = next(iter(sizes)) // n, mesh.index("data")
    return {**batch, **{k: v[i * b:(i + 1) * b] for k, v in arrays.items()}}, True


def count_batch_path(kind: str, sliced: bool) -> None:
    """Counts one batch of ``kind`` on its path; the first that the data
    ranks run whole is logged on rank 0."""
    key = f"{kind}_{'sliced' if sliced else 'whole'}"
    BATCH_PATHS[key] += 1
    if not sliced and BATCH_PATHS[key] == 1 and is_lead():
        logger.warning(f"{kind}: a batch that does not split over the data ranks runs whole "
                       "on every data rank (its work is repeated, not shared)")


def gather_rows(mesh: Mesh, *arrays: np.ndarray, pad_value=0) -> List[np.ndarray]:
    """Each data rank's rows of each array, concatenated in rank order on
    every rank; a ragged last axis is padded with ``pad_value`` to the
    longest."""
    parts: List[Any] = [None] * mesh.shape["data"]
    dist.all_gather_object(parts, [np.asarray(a) for a in arrays], group=mesh.group("data"))
    out = []
    for j in range(len(arrays)):
        rows = [part[j] for part in parts]
        if rows[0].ndim >= 2:
            width = max(r.shape[-1] for r in rows)
            rows = [np.pad(r, [(0, 0)] * (r.ndim - 1) + [(0, width - r.shape[-1])],
                           constant_values=pad_value) for r in rows]
        out.append(np.concatenate(rows, axis=0))
    return out


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh], pad: Optional[int] = None
                ) -> Tuple[Dict[str, Any], float]:
    """This data rank's part of a global batch -> (the part, its weight):
    the slice of every array whose leading axis is the batch's (weight 1),
    or the whole batch at weight ``1 / data ranks`` where it cannot be
    split exactly (see the module docstring)."""
    n = 1 if mesh is None else mesh.shape.get("data", 1)
    if n == 1:
        return batch, 1.0
    target = batch.get("target")
    part, sliced = split_batch(batch, mesh)
    if not (sliced and pad is not None and target is not None and "ntokens" in batch
            and float((np.asarray(target) != pad).sum()) == float(batch["ntokens"])):
        count_batch_path("train", False)
        return batch, 1.0 / n
    count_batch_path("train", True)
    part["ntokens"] = float((np.asarray(part["target"]) != pad).sum())
    if "nsentences" in batch:
        part["nsentences"] = int(part["target"].shape[0])
    return part, 1.0
