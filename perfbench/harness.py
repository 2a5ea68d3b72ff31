"""The benchmark's frame: reads ``BENCHMARK.json``, runs one cell once
through its kind (``cells/<kind>.py``, named by the traffic mix), and prints
the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name:

- ``configs/<file>.json``: the model's sizes, its source and its reference;
- ``traffic/<traffic>.json``: the mix's parameters, read by ``traffic.py``
  and by the kind it names;
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``, each set from the readings in ``PERF.md``;
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader a
  metric, ``read(run) -> number or None``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that must not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chimera_st_tpu")


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """A Python file as a module (metric readers have dots in their names)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_reader_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with its configuration, mix, limits and the
    metrics it reports."""

    def __init__(self, bench: Dict, name: str, config: Optional[Dict] = None,
                 traffic: Optional[Dict] = None, limits: Optional[Dict] = None):
        """The cell ``name`` of ``bench``; ``config``, ``traffic`` and
        ``limits`` given stand in for its files (the tests' small sizes)."""
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        self.chips = int(self.spec["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = config or load_json(ROOT / configs[self.spec["config"]]["file"])
        self.traffic = traffic or load_json(BENCH / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = limits or load_json(BENCH / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e_names)]


class Recorder:
    """Host-clock spans and counts, kept in memory. ``span`` also marks the
    region for the profiler (``record_function``) when ``annotate``."""

    def __init__(self, annotate: bool = False):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, float] = defaultdict(float)
        self.annotate = annotate

    @contextlib.contextmanager
    def span(self, name: str):
        note = contextlib.nullcontext()
        if self.annotate:
            import torch

            note = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with note:
            yield
        self.seconds[name] += time.perf_counter() - t0

    def count(self, name: str, n: float = 1) -> None:
        self.counts[name] += n

    @staticmethod
    def mark(name: str):
        """The region marked for the profiler only (the profiled slice after
        the window), not timed."""
        import torch

        return torch.profiler.record_function(name)


class Run:
    """What one run of a cell measured, for the readers and the result."""

    def __init__(self, args, cell: Cell, t_start: float, device: str = "cuda"):
        self.args, self.cell, self.t_start = args, cell, t_start
        self.device = device
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.rec = Recorder(annotate=self.trace)
        self.window: Dict[str, float] = {}
        self.work: Dict[str, float] = {"audio_s": 0.0, "flops": 0.0}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.profile: Optional[Dict[str, Any]] = None  # the traced slice
        self.checks: Dict[str, Dict[str, float]] = {}
        self.notes: List[str] = []

    def sync(self) -> None:
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()

    def read_peak(self) -> None:
        import torch

        if self.device == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated()

    def free(self) -> None:
        """Returns the program's freed blocks to the card before the
        reference runs."""
        import gc

        import torch

        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, name: str, value: float, limit: float) -> None:
        """A number that decides ``correct``, beside its limit (the number
        must not exceed it)."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def window_s(self) -> float:
        return self.window["t1"] - self.window["t0"]

    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"] for c in self.checks.values())


def drive(run: Run, kind) -> None:
    """One run of a cell of ``kind`` (a module of ``cells/``): its program
    (set-up, window, the traced slice) on data in a directory of its own
    under ``TMPDIR``, then, with the program's state freed, its check."""
    with tempfile.TemporaryDirectory(prefix="perfbench_data_",
                                     dir=os.environ.get("TMPDIR")) as tmp:
        readings = kind.program(run, Path(tmp))
        run.free()
        t0 = time.perf_counter()
        kind.check(run, **readings)
    run.notes.append(f"set-up {run.window['t0'] - run.t_start:.1f} s, window "
                     f"{run.window_s:.1f} s, check {time.perf_counter() - t0:.1f} s")


def reader(kind: str, name: str):
    return load_module(BENCH / kind / f"{name}.py")


def device_lines() -> None:
    """The card's name and power limit, on standard error."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    print(f"perfbench: card {out}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metrics_of(run: Run) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1), each from its reader; a reader that finds nothing is left out."""
    specs, kind = ((run.cell.per_layer, "metrics") if run.trace
                   else (run.cell.end_to_end, "end_to_end"))
    out = {}
    for spec in specs:
        value = reader(kind, spec["name"]).read(run)
        if value is None:
            run.notes.append(f"{spec['name']}: nothing to read")
            continue
        out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def result_line(run: Run) -> Dict[str, Any]:
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak)}
    out: Dict[str, Any] = {"correct": run.correct(), "attempted": int(run.attempted),
                           "failed": int(run.failed), "metrics": metrics_of(run),
                           "device": device}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = run.profile["breakdown"]
    out["checks"] = run.checks  # last: each compared number beside its limit
    return out


def main(args, t_start: float) -> int:
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device_lines()
    run = Run(args, cell, t_start)
    drive(run, load_module(BENCH / "cells" / f"{cell.traffic['kind']}.py"))
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules that must not be loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(run)
    for note in run.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for name, c in run.checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g}) {verdict}",
              file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
