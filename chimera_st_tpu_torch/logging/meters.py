"""Checkpointable metric accumulators (counterpart of
chimera_st_tpu/logging/meters.py, the same classes and state layout).

Every meter declares its persistent scalar fields in ``_slots``;
``MetersDict.state_dict()`` is a list of ``(priority, key, "ClassName",
{fields})`` with plain or numpy scalars, the layout a JAX checkpoint's
``extra["metrics"]`` holds, so either package reads the other's. The pickle
names no class of either package. Wall-clock time is never persisted
directly: elapsed time is folded into an offset at save, so restored meters
keep counting from where they left off.
"""

from __future__ import annotations

import bisect
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple


def _rounded(value, ndigits: Optional[int]):
    if value is None or ndigits is None:
        return value
    if hasattr(value, "item"):  # 0-d array / tensor
        value = value.item()
    try:
        return round(value, ndigits)
    except TypeError:
        return value


class Meter:
    """Base: persistent fields listed in ``_slots`` serialize generically."""

    _slots: Tuple[str, ...] = ()

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self) -> None:
        raise NotImplementedError

    def as_state(self) -> Dict[str, Any]:
        state = {name: getattr(self, name) for name in self._slots}
        state["round"] = self.round
        return state

    def from_state(self, state: Dict[str, Any]) -> None:
        self.reset()
        for name in self._slots:
            if name in state:
                setattr(self, name, state[name])
        self.round = state.get("round")

    # reference-compatible aliases (the metrics layer and checkpoints call
    # state_dict/load_state_dict on every meter)
    def state_dict(self) -> Dict[str, Any]:
        return self.as_state()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.from_state(state)

    @property
    def smoothed_value(self) -> float:
        raise NotImplementedError


class AverageMeter(Meter):
    """Weighted running mean; remembers the latest raw value."""

    _slots = ("val", "sum", "count")

    def reset(self):
        self.val: Optional[float] = None
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        if val is None:
            return
        self.val = val
        if n > 0:
            self.sum += val * n
            self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else self.val

    @property
    def smoothed_value(self) -> float:
        return _rounded(self.avg, self.round)


class SumMeter(Meter):
    """Plain accumulator."""

    _slots = ("sum",)

    def reset(self):
        self.sum = 0.0

    def update(self, val):
        if val is not None:
            self.sum += val

    @property
    def smoothed_value(self) -> float:
        return _rounded(self.sum, self.round)


class TimeMeter(Meter):
    """Events per second since reset (e.g. wps); count survives checkpoints
    as does accumulated wall time (via the offset fold in ``as_state``)."""

    _slots = ("n",)

    def __init__(self, init: float = 0.0, n: int = 0, round: Optional[int] = None):
        self.round = round
        self.reset(init=init, n=n)

    def reset(self, init: float = 0.0, n: int = 0):
        self._offset = init
        self._anchor = time.perf_counter()
        self.n = n
        self.i = 0

    def update(self, new_n=1):
        self.n += new_n
        self.i += 1

    @property
    def elapsed_time(self) -> float:
        return self._offset + (time.perf_counter() - self._anchor)

    @property
    def avg(self):
        t = self.elapsed_time
        return self.n / t if t > 0 else 0.0

    @property
    def smoothed_value(self) -> float:
        return _rounded(self.avg, self.round)

    def as_state(self):
        state = super().as_state()
        state["init"] = self.elapsed_time  # fold running time into the offset
        return state

    def from_state(self, state):
        self.reset(init=state.get("init", 0.0), n=state.get("n", 0))
        self.round = state.get("round")


class StopwatchMeter(Meter):
    """Mean duration of start()/stop() intervals, weighted by stop(n)."""

    _slots = ("sum", "n")

    def reset(self):
        self.sum = 0.0
        self.n = 0.0
        self._started_at: Optional[float] = None

    def start(self):
        self._started_at = time.perf_counter()

    def stop(self, n=1, prehook: Optional[Callable] = None):
        if self._started_at is None:
            return
        if prehook is not None:
            prehook()
        self.sum += time.perf_counter() - self._started_at
        self.n += n
        self._started_at = None

    @property
    def start_time(self):
        return self._started_at

    @property
    def elapsed_time(self) -> float:
        if self._started_at is None:
            return 0.0
        return time.perf_counter() - self._started_at

    @property
    def avg(self):
        return self.sum / self.n if self.n else self.sum

    @property
    def smoothed_value(self) -> float:
        # a stopped watch reports its mean interval; a running one, live time
        value = self.avg if self.sum > 0 else self.elapsed_time
        return _rounded(value, self.round)


_METER_TYPES = {
    cls.__name__: cls
    for cls in (AverageMeter, SumMeter, TimeMeter, StopwatchMeter)
}


class MetersDict(OrderedDict):
    """Meters keyed by name, iterated in (priority, insertion) order.

    Entries are assigned once (``add_meter``); derived entries compute their
    value from sibling meters at read time and are skipped by checkpointing.
    Keys starting with "_" are internal (hidden from get_smoothed_values).
    """

    class _DerivedMeter(Meter):
        """Read-time function of the surrounding MetersDict."""

        def __init__(self, fn: Callable[["MetersDict"], float]):
            self.fn = fn

        def reset(self):
            pass

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._order: List[Tuple[int, int, str]] = []  # (priority, seq, key)

    def add_meter(self, key: str, meter: Meter, priority: int) -> None:
        self[key] = (priority, meter)

    def __setitem__(self, key, priority_and_meter):
        if key in self:
            raise KeyError(f"meter {key!r} already registered")
        priority, meter = priority_and_meter
        bisect.insort(self._order, (priority, len(self._order), key))
        super().__setitem__(key, meter)
        for _, _, ordered_key in self._order:
            self.move_to_end(ordered_key)

    def get_smoothed_value(self, key: str) -> float:
        meter = self[key]
        if isinstance(meter, MetersDict._DerivedMeter):
            return meter.fn(self)
        return meter.smoothed_value

    def get_smoothed_values(self) -> Dict[str, float]:
        return OrderedDict(
            (key, self.get_smoothed_value(key))
            for key in self
            if not key.startswith("_")
        )

    def reset(self) -> None:
        for meter in self.values():
            meter.reset()

    def state_dict(self) -> List[Tuple[int, str, str, Dict[str, Any]]]:
        return [
            (priority, key, type(self[key]).__name__, self[key].as_state())
            for priority, _, key in self._order
            if not isinstance(self[key], MetersDict._DerivedMeter)
        ]

    def load_state_dict(self, entries) -> None:
        self.clear()
        self._order.clear()
        for priority, key, type_name, meter_state in entries:
            meter = _METER_TYPES[type_name]()
            meter.from_state(meter_state)
            self.add_meter(key, meter, priority)


def safe_round(number, ndigits):
    """Round scalars/0-d arrays; pass anything else through."""
    return _rounded(number, ndigits)
