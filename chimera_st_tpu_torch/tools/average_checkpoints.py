"""Checkpoint averaging (counterpart of
chimera_st_tpu/tools/average_checkpoints.py, the JAX package's
``chimera-average-checkpoints``): the mean of the ``params`` trees of
several native ``.ckpt`` files, accumulated in fp64 and cast to fp32;
everything else (step, optimizer state, extra) is the last input's.

    python -m chimera_st_tpu_torch.tools.average_checkpoints \\
        --inputs ckpt/checkpoint8.ckpt ckpt/checkpoint9.ckpt ckpt/checkpoint10.ckpt \\
        --output ckpt/averaged.ckpt

Host-only (numpy); the output is the pickle both packages read."""

from __future__ import annotations

import argparse
import pickle
from typing import Any, List, Mapping

import numpy as np


def average_trees(trees: List[Any]) -> Any:
    """The element-wise mean of trees of one layout (nested dicts of
    arrays): fp64 sums in input order, divided by their count, as fp32."""
    first = trees[0]
    if isinstance(first, Mapping):
        if any(not isinstance(t, Mapping) or set(t) != set(first) for t in trees[1:]):
            raise ValueError("the checkpoints' parameter trees differ in layout")
        return {k: average_trees([t[k] for t in trees]) for k in first}
    acc = np.asarray(first, np.float64)
    for t in trees[1:]:
        acc = acc + np.asarray(t)
    return (acc / len(trees)).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser("chimera-average-checkpoints (PyTorch port)")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    payloads = []
    for path in args.inputs:
        with open(path, "rb") as f:
            payloads.append(pickle.load(f))
    out = dict(payloads[-1])
    out["params"] = average_trees([pl["params"] for pl in payloads])
    with open(args.output, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"averaged {len(payloads)} checkpoints -> {args.output}")


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
