"""Readings that the limits of ``correct`` are set from: for each seed, one
run of the cell's timed path (a short window at the cell's own sizes) held
against the plain reference in fp32 and against the control, the same
reference in float8 e4m3 (the precision below the configuration's bf16).

    python3 perfbench/calibrate.py --workload NAME --seeds 1,2,3 [--seconds S]
        [--control-seeds 1,2,3] [--out FILE]

One JSON line a seed: ``program``, the numbers a run compares (the
program against the fp32 reference), and for the control seeds
``control``, the same numbers of the float8 reference put in the program's
place (its updates against the fp32 reference's); for the fault seeds
``half_batch``,
the fault of half of each micro-batch left out (the mean taken over the
rest) planted in the reference put in the program's place. The
benchmark's own runs never run this. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault-seeds", default="",
                   help="seeds on which the reference reads the fault of half the batch "
                        "left out")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    kind = harness.load_module(harness.BENCH / "cells" / f"{cell.traffic['kind']}.py")
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(SimpleNamespace(workload=cell.name, seed=seed, seconds=args.seconds,
                                          trace=0), cell, t0)
        with tempfile.TemporaryDirectory(prefix="perfbench_data_",
                                         dir=os.environ.get("TMPDIR")) as tmp:
            readings = kind.program(run, Path(tmp))
            run.free()
            rec = {"workload": cell.name, "seed": seed, "attempted": run.attempted,
                   "program": kind.check(run, **readings)}
            if seed in control_seeds:
                rec["control"] = kind.control(run, **readings)
            if seed in fault_seeds:
                rec["half_batch"] = kind.fault_half(run, **readings)
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del readings, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
