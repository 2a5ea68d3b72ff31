"""The control: the plain reference in float8 e4m3 put in the program's
place fails the cell's limits, at small sizes on the CPU (the same control
at the cells' own sizes on the card is ``calibrate.py``'s, whose readings
``PERF.md`` gives)."""

import time
from types import SimpleNamespace

import pytest

import tiny
from perfbench import harness


def control_of(name, seed, tmp):
    make_cfg, traffic = tiny.CELLS[name]
    cell = harness.Cell(tiny.bench(), name, config=make_cfg(),
                        traffic=tiny.tiny_traffic(traffic))
    run = harness.Run(SimpleNamespace(workload=name, seed=seed, seconds=0.5, trace=0), cell,
                      time.perf_counter(), device="cpu")
    kind = harness.load_module(tiny.BENCH / "cells" / f"{cell.traffic['kind']}.py")
    readings = kind.program(run, tmp)
    return kind.control(run, **readings), cell.limits


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_control_fails_a_limit(name, tmp_path):
    got, limits = control_of(name, 2 ** 31 + 99, tmp_path)
    assert any(got[k] > limits[k] for k in got), (got, limits)
