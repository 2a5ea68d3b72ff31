"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout holding ``BENCHMARK.json``, ``perfbench/`` and
the program (``chimera_st_tpu_torch``), on a machine with the cards the
cell asks for. ``--trace 1`` reports the cell's per-layer metrics from a
traced run, ``--trace 0`` its end-to-end metrics. Without a CUDA card it
exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()  # the process's start, as set-up counts it

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernel library lives in ``chimera_st_tpu_torch/_build``;
    PyTorch's extension, Triton's and CUDA's JIT caches go here)."""
    cache = ROOT / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    environment()
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    sys.exit(harness.main(args, T_START))
