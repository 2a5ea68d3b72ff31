"""trace_busy and the breakdown on a synthetic Chrome trace."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.yardstick import trace  # noqa: E402


def write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


EVENTS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::step", "ts": 0, "dur": 30},
    {"ph": "X", "cat": "user_annotation", "name": "generation.decode", "ts": 0, "dur": 30},
    {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 16, "dur": 3},
    {"ph": "X", "cat": "kernel", "name": "void decode_attention_kernel<bf16>(int)", "ts": 0,
     "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void gemm_kernel(int)", "ts": 5, "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20, "dur": 5},
    {"ph": "i", "cat": "marker", "name": "instant", "ts": 40},
]


def test_busy_is_the_union_over_the_span(tmp_path):
    got = trace.trace_busy(write(tmp_path, EVENTS))
    # device busy [0, 15] and [20, 25]; the span [0, 30] (the instant event
    # is no complete event)
    assert got["device_busy_ms"] == pytest.approx(0.020)
    assert got["wall_ms"] == pytest.approx(0.030)
    assert got["busy_share"] == pytest.approx(2 / 3)
    assert got["device_events"] == 3


def test_no_device_events_raise(tmp_path):
    with pytest.raises(RuntimeError):
        trace.trace_busy(write(tmp_path, EVENTS[:3]))


def test_kernel_times_match_by_part_of_name():
    got = trace.kernel_times(EVENTS, ["decode_attention_kernel", "logmel_kernel"])
    assert got["decode_attention_kernel"] == (1, pytest.approx(10e-6))
    assert got["logmel_kernel"] == (0, 0.0)


def test_breakdown_names_gaps_by_the_host():
    got = trace.breakdown(EVENTS)
    ops = dict(got["device_ops"])
    assert ops["decode_attention_kernel<bf16>(int)"] == pytest.approx(10e-6)
    gaps = dict(got["idle_gaps"])
    # [15, 20]: inside aten::item; [25, 30]: only aten::step covers it
    assert gaps["generation.decode / aten::item"] == pytest.approx(5e-6)
    assert gaps["generation.decode / aten::step"] == pytest.approx(5e-6)
