"""On a card (skipped without one): each cell at small sizes, through the
hand-written kernels in bf16 and traced, runs to its end, and its numbers
sit under its float8 control's, which fails one of the cell's limits. Run
on the card with ``python -m pytest perfbench/tests -m card``."""

import time
from types import SimpleNamespace

import pytest

import tiny
from perfbench import harness


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_cell_on_the_card(name, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    make_cfg, traffic = tiny.CELLS[name]
    cell = harness.Cell(tiny.bench(), name, config=make_cfg(),
                        traffic=tiny.tiny_traffic(traffic, dtype="bfloat16"))
    run = harness.Run(SimpleNamespace(workload=name, seed=2 ** 31 + 11, seconds=1.0, trace=1),
                      cell, time.perf_counter())
    kind = harness.load_module(tiny.BENCH / "cells" / f"{cell.traffic['kind']}.py")
    readings = kind.program(run, tmp_path)
    assert run.profile is not None and run.profile["busy_s"] > 0
    run.free()
    got = kind.check(run, **readings)
    low = kind.control(run, **readings)
    print(name, got, low, run.profile["kernels"])
    assert any(got[k] < low[k] for k in low), (got, low)
    assert any(low[k] > cell.limits[k] for k in low), low
