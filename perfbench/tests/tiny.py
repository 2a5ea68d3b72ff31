"""Small sizes of the benchmark's cells, run on the CPU: the program takes
its plain kernel versions there, so the whole run (traffic, program,
reference, check) can be rehearsed without a card. Heads are 64 wide, as
the hand-written kernels take them, so the same sizes run on a card."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load(rel: str):
    return json.loads((BENCH / rel).read_text())


def tiny_chimera():
    cfg = load("configs/chimera_w2v2_base.json")
    cfg["model"].update(
        tgt_vocab_size=60, src_vocab_size=50, w2v2_embed_dim=128, w2v2_ffn_dim=64,
        w2v2_layers=2, w2v2_heads=2, w2v2_conv_spec=[[16, 10, 5], [16, 3, 2], [16, 2, 2]],
        w2v2_conv_pos=16, w2v2_conv_pos_groups=4, conv_channels=32, encoder_embed_dim=128,
        encoder_ffn_dim=64, encoder_layers=2, encoder_heads=2, interlingua_length=8,
        interlingua_layers=2, decoder_embed_dim=128, decoder_ffn_dim=64, decoder_layers=2,
        decoder_heads=2)
    return cfg


def tiny_traffic(name: str, **over):
    mix = load(f"traffic/{name}.json")
    mix.update(utterances=80, seconds={"distribution": "lognormal", "mean": 0.65, "sigma": 0.4,
                                       "min": 0.3, "max": 1.2}, talk_utterances=10)
    mix.update(max_tokens=30000, update_freq=2, num_workers=1, checked_updates=3)
    mix.update(over)
    return mix


CELLS = {"chimera-st-train": (tiny_chimera, "st_finetune")}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run_cell(name: str, seed: int = 7, dtype: str = "float32", limits=None, seconds=0.5,
             trace: int = 0):
    """Runs a small copy of cell ``name`` on the CPU -> the Run."""
    import sys

    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    make_cfg, traffic = CELLS[name]
    lim = copy.deepcopy(limits) if limits is not None else harness.load_json(
        BENCH / "limits" / f"{name}.json")
    cell = harness.Cell(bench(), name, config=make_cfg(),
                        traffic=tiny_traffic(traffic, dtype=dtype), limits=lim)
    args = SimpleNamespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    run = harness.Run(args, cell, time.perf_counter(), device="cpu")
    harness.drive(run, harness.load_module(BENCH / "cells" / f"{cell.traffic['kind']}.py"))
    return run
