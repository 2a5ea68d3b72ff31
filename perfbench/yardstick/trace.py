"""Reading a torch.profiler Chrome trace: the device's busy time, the device
time of the kernels by name, and the breakdown that the result line carries.

``trace_busy`` is copied from ``chip_smoke.py`` and frozen here: the busy
time is the union of the kernel, copy and set intervals on the device, over
the span from the trace's first event to its last. It defines the idle
share.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path: Path) -> List[dict]:
    """The complete ("X") events of a Chrome trace."""
    return [e for e in json.loads(Path(path).read_text())["traceEvents"]
            if e.get("ph") == "X" and "ts" in e]


def trace_busy(path: Path) -> dict:
    """The device's busy share in a torch.profiler Chrome trace: the union
    of the kernel, copy and set intervals over the span from the trace's
    first event to its last."""
    return busy_of(load_events(path))


def busy_of(events: Sequence[dict]) -> dict:
    """``trace_busy`` of events already loaded (complete events only)."""
    events = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                    if e.get("cat") in DEVICE_CATS)
    if not device:
        raise RuntimeError("the trace holds no device events")
    busy, end = 0.0, float("-inf")
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = (max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
            - min(float(e["ts"]) for e in events))
    return {"wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3, "busy_share": busy / wall,
            "device_events": len(device)}


def kernel_times(events: Iterable[dict], parts: Sequence[str]) -> Dict[str, Tuple[int, float]]:
    """{part: (launches, device seconds)} of the kernels whose name holds
    each part (a demangled template name starts with its return type)."""
    out = {p: [0, 0.0] for p in parts}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        for p in parts:
            if p in name:
                out[p][0] += 1
                out[p][1] += float(e.get("dur", 0)) / 1e6
    return {p: (n, s) for p, (n, s) in out.items()}


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without its leading return type, cut to
    ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def breakdown(events: Sequence[dict], top: int = 10) -> dict:
    """The device operations that took the most time (summed by name), and
    the device's idle time summed by what the host was doing: each gap
    between device intervals is named by the innermost annotation
    (``record_function``) and the innermost host operation that cover its
    middle. Seconds, as measured."""
    events = [e for e in events if e.get("ph") == "X" and "ts" in e]
    ops: Dict[str, float] = defaultdict(float)
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a = float(e["ts"])
            b = a + float(e.get("dur", 0))
            device.append((a, b))
            ops[short_name(e.get("name", "?"))] += (b - a) / 1e6
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    busy = _merged(device)
    gaps, cursor = [], t0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if t1 > cursor:
        gaps.append((cursor, t1))

    def spans(cat):
        s = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", "?"))
                   for e in events if e.get("cat") == cat)
        return s, [x[0] for x in s]

    notes, note_starts = spans("user_annotation")
    host_ops, op_starts = spans("cpu_op")

    def innermost(items, starts, t, reach=400):
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(i - 1 - reach, -1), -1):
            a, b, name = items[j]
            if b >= t and (best is None or a > best[0]):
                best = (a, name)
        return None if best is None else best[1]

    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        note = innermost(notes, note_starts, mid, reach=len(notes))
        op = innermost(host_ops, op_starts, mid)
        label = " / ".join(x for x in (note, op) if x) or "no host operation"
        idle[label] += (b - a) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
