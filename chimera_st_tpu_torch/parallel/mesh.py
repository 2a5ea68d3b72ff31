"""Process grids over ``torch.distributed`` (counterpart of
chimera_st_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh; PyTorch runs one
process a card. A ``Mesh`` is the same grid made of ranks: the world's
ranks in row-major order (rank = d * model + m, as ``np.reshape`` lays the
device list out) over named axes, ``("data", "model")`` or ``("data",
"pipe")``, with a process group along each axis for this rank. A world of
one (no process group) is the one-process mesh, whose collectives are the
identity.

- ``initialize_distributed(init_method, world_size, rank, device)``: the
  process group of one rank: NCCL for ``cuda`` (the rank's card is ``rank %
  device_count``), gloo for ``cpu``. ``init_method`` is
  ``tcp://HOST:PORT`` (or a bare ``HOST:PORT``) or ``file://PATH``.
- ``spawn(fn, world_size, *args)``: ``world_size`` ranks of ``fn(rank,
  *args)`` on this host (as fairseq's ``call_main`` starts them), joined by
  a ``file://`` rendezvous in a fresh temporary directory, so that no port
  is chosen. A world larger than the visible cards raises, as the JAX
  ``make_mesh`` asserts.
- ``make_mesh(data, model)`` / ``make_pipeline_mesh(pipe, data)``: the
  grids, with the JAX functions' checks.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_lead() -> bool:
    """True in the rank that writes checkpoints and logs (rank 0)."""
    return rank() == 0


class Mesh:
    """A grid of ranks over named axes, with this rank's group along each."""

    def __init__(self, axes: Dict[str, int]):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = math.prod(axes.values())
        n = world()
        if self.size != n:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks; the world has {n}")
        self.rank = rank()
        self.distributed = dist.is_available() and dist.is_initialized()
        self._groups: Dict[str, Optional[object]] = {}
        self._ranks: Dict[str, List[int]] = {}
        for a, axis in enumerate(self.axis_names):
            for members in self._lines(a):
                # every rank creates every group, in the same order; a world
                # of one that was initialised keeps its groups (its
                # collectives still run through the backend)
                group = dist.new_group(members) if self.distributed else None
                if self.rank in members:
                    self._groups[axis], self._ranks[axis] = group, members

    def _lines(self, a: int) -> List[List[int]]:
        """The rank lists along axis ``a``, one for each position on the
        other axes."""
        dims = [self.shape[x] for x in self.axis_names]
        strides = [math.prod(dims[i + 1:]) for i in range(len(dims))]
        others = [i for i in range(len(dims)) if i != a]
        lines = []
        for flat in range(math.prod(dims[i] for i in others)):
            base, rest = 0, flat
            for i in reversed(others):
                base += (rest % dims[i]) * strides[i]
                rest //= dims[i]
            lines.append([base + j * strides[a] for j in range(dims[a])])
        return sorted(lines)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis it lacks)."""
        if axis not in self._ranks:
            return 0
        return self._ranks[axis].index(self.rank)

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None: no process group)."""
        return self._groups.get(axis)

    def ranks(self, axis: str) -> List[int]:
        return self._ranks.get(axis, [self.rank])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(data_parallel: int = -1, model_parallel: int = 1) -> Mesh:
    n = world()
    if data_parallel == -1:
        assert n % model_parallel == 0, (n, model_parallel)
        data_parallel = n // model_parallel
    assert data_parallel * model_parallel <= n, (
        f"mesh {data_parallel}x{model_parallel} needs more than {n} devices")
    return Mesh({"data": data_parallel, "model": model_parallel})


def make_pipeline_mesh(pipeline_stages: int, data_parallel: int = -1) -> Mesh:
    """(data x pipe) grid for the GPipe schedule (parallel/pipeline.py)."""
    n = world()
    assert n % pipeline_stages == 0, (
        f"{n} devices do not divide into {pipeline_stages} pipeline stages")
    if data_parallel == -1:
        data_parallel = n // pipeline_stages
    assert data_parallel * pipeline_stages <= n, (
        f"mesh {data_parallel}x{pipeline_stages} (data x pipe) needs more than {n} devices")
    return Mesh({"data": data_parallel, "pipe": pipeline_stages})


def parse_init_method(init: str) -> str:
    """``tcp://HOST:PORT`` or a bare ``HOST:PORT`` -> ``tcp://HOST:PORT``;
    ``file://PATH`` as it is; anything else raises, as the JAX CLI refuses
    it (``chimera_st_tpu/cli/options.py:325-352``)."""
    if init.startswith("file://"):
        return init
    coord = init[len("tcp://"):] if init.startswith("tcp://") else init
    host, sep, port = coord.rpartition(":")
    if "://" in coord or not sep or not host or not port.isdigit():
        raise SystemExit(
            "--distributed-init-method must be tcp://HOST:PORT or bare HOST:PORT (or "
            f"file://PATH); got {init!r}")
    return f"tcp://{coord}"


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device: str = "cuda") -> None:
    """Joins this process to the world as ``rank``: NCCL on the card
    ``rank % device_count``, or gloo on the CPU."""
    if device == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("--device cuda: no CUDA device is available")
        torch.cuda.set_device(rank % count)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=parse_init_method(init_method),
                            world_size=world_size, rank=rank)


def _spawned(local: int, fn: Callable, world_size: int, init: str, device: str,
             args: Sequence) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    initialize_distributed(init, world_size, local, device)
    try:
        fn(local, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, device: str = "cuda") -> None:
    """Runs ``fn(rank, *args)`` in ``world_size`` new processes of this host,
    each joined to the world (the host's cores shared out as their intra-op
    threads), and waits for them; a failed rank raises here."""
    if device == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"a world of {world_size} ranks needs as many cards; "
                         f"{torch.cuda.device_count()} are visible")
    root = tempfile.mkdtemp(prefix="chimera_rendezvous_")
    try:
        init = f"file://{os.path.join(root, 'rendezvous')}"
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, world_size, init, device, args), nprocs=world_size,
            join=True, start_method="spawn")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group`` (None: the identity)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src_index: int, mesh: "Mesh", axis: str) -> torch.Tensor:
    """In place: ``t`` of the rank at ``src_index`` on ``axis`` to the others."""
    group = mesh.group(axis)
    if group is not None:
        dist.broadcast(t, mesh.ranks(axis)[src_index], group=group)
    return t
