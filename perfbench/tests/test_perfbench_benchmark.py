"""BENCHMARK.json against the contract's rules that a file can be checked
by: names, units, keys, files, readers and the time a full check takes."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def reader(kind, name):
    spec = importlib.util.spec_from_file_location("reader", ROOT / "perfbench" / kind / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(TEXT.match(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32


def test_paths_hold_the_command():
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("entry", [*BENCH["configs"], *BENCH["workloads"], *METRICS],
                         ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_and_traffic_files():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_every_metric_has_its_reader(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["per_layer"]:
        allowed |= {"layer", "moves"}
        mod = reader("metrics", metric["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (metric["layer"], metric["unit"],
                                                    metric["moves"])
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    else:
        mod = reader("end_to_end", metric["name"])
        assert mod.UNIT == metric["unit"]
        assert metric["source"] in ("host_clock", "device_trace")
        assert metric["name"] == "setup_s" or 0.01 <= metric["bound"] <= 0.25
    assert set(metric) <= allowed | ({"bound"} if metric in BENCH["end_to_end"] else set())
    assert callable(mod.read)


def test_every_cell_reports_enough():
    names = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in names:
        mine = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])]
        assert layer and all(m["moves"] in {x["name"] for x in mine} for m in layer)
    for m in METRICS:
        assert set(m.get("workloads", [])) <= names


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layers_spelled_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
