"""The data-parallel sum of the gradients, in buckets that start while the
backward runs (the work of PyTorch's DDP reducer, for a model that the
criterion calls as it is, with the sum the trainer normalises itself).

- Each trained parameter's ``.grad`` is a view into its bucket's flat
  buffer (``attach``, at the start of an update), so autograd accumulates
  the micro-batches in place and the all-reduce copies nothing.
- During the last micro-batch's backward (``arm``) a parameter's
  post-accumulate hook marks it done; a bucket whose parameters are all
  done starts an asynchronous all-reduce, in bucket order, so that every
  rank issues the same collectives in the same order. Buckets run in the
  reverse order of the parameters, the order in which a backward finishes
  them.
- ``finish`` starts the buckets left (those holding a parameter the loss
  did not reach) and waits for all.

A parameter is accumulated once in a backward (the GPipe schedule and the
activation checkpoints accumulate into copies, not into the parameter); one
accumulated again after its bucket started raises, since its sum would be
wrong.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 << 20  # as DDP's default bucket_cap_mb


class GradientReducer:
    """In-place sum of ``params``' gradients over ``group``."""

    def __init__(self, params: Sequence[torch.nn.Parameter], group):
        self.group = group
        self.buckets: List[List[torch.nn.Parameter]] = []
        self.buffers: List[torch.Tensor] = []
        self.bucket_of: Dict[int, int] = {}
        current, size = [], 0
        for p in reversed(list(params)):
            nbytes = p.numel() * p.element_size()
            if current and (size + nbytes > BUCKET_BYTES or p.dtype != current[0].dtype
                            or p.device != current[0].device):
                self._add(current)
                current, size = [], 0
            current.append(p)
            size += nbytes
        if current:
            self._add(current)
        self.armed = False
        for p in params:
            p.register_post_accumulate_grad_hook(self._accumulated)

    def _add(self, params: List[torch.nn.Parameter]) -> None:
        self.bucket_of.update((id(p), len(self.buckets)) for p in params)
        self.buckets.append(params)
        self.buffers.append(torch.zeros(sum(p.numel() for p in params),
                                        dtype=params[0].dtype, device=params[0].device))

    def attach(self) -> None:
        """Zeroes the buffers and makes every ``.grad`` a view into its
        bucket's buffer."""
        for params, buf in zip(self.buckets, self.buffers):
            buf.zero_()
            offset = 0
            for p in params:
                p.grad = buf[offset:offset + p.numel()].view_as(p)
                offset += p.numel()

    def arm(self) -> None:
        """The next backward is the update's last: its accumulations start
        the buckets."""
        self.armed = True
        self.fired: set = set()
        self.waiting = [len(params) for params in self.buckets]
        self.handles = []

    def _accumulated(self, p: torch.nn.Parameter) -> None:
        if not self.armed:
            return
        b = self.bucket_of[id(p)]
        if b < len(self.handles):
            raise RuntimeError("a gradient was accumulated after its bucket's all-reduce "
                               "started")
        if id(p) in self.fired:
            return
        self.fired.add(id(p))
        self.waiting[b] -= 1
        self._start(lambda i: self.waiting[i] == 0)

    def _start(self, ready) -> None:
        while len(self.handles) < len(self.buckets) and ready(len(self.handles)):
            self.handles.append(dist.all_reduce(self.buffers[len(self.handles)],
                                                group=self.group, async_op=True))

    def finish(self) -> None:
        """Starts the buckets left and waits for every bucket's sum;
        ``started_early`` is the number that started during the backward."""
        self.started_early = len(self.handles)
        self._start(lambda i: True)
        for handle in self.handles:
            handle.wait()
        self.armed = False
