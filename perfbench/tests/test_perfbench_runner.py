"""The runner without a card: it exits non-zero and prints no result."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "chimera-st-train",
                           "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")
    assert "CUDA card" in proc.stderr


def test_unknown_workload_refused():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "nope", "--seed", "1",
                           "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()
