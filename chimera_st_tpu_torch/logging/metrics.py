"""Metrics facade over a context stack (counterpart of
chimera_st_tpu/logging/metrics.py).

Training code logs flat key/value pairs (``log_scalar('loss', ...)``) without
knowing which accumulation windows are open; every open ``aggregate(...)``
window receives the write. The whole mechanism is one object holding

  * a name->MetersDict store for *named* windows (so ``get_meters('train')``
    works between openings), and
  * a stack of frames, one per open ``with aggregate(...)`` block.

The active set is *derived* by walking the stack top-down until a root
barrier: re-entrancy, exceptions, and ``new_root`` isolation all fall out of
list push/pop.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

from .meters import (
    AverageMeter,
    MetersDict,
    StopwatchMeter,
    SumMeter,
    TimeMeter,
)

DEFAULT = "default"


class _Frame:
    """One open ``aggregate(...)`` block: its meters + whether it hides parents."""

    __slots__ = ("agg", "barrier")

    def __init__(self, agg: MetersDict, barrier: bool):
        self.agg = agg
        self.barrier = barrier


class MetricsStack:
    """The whole metrics subsystem as a single value.

    Module-level functions below delegate to one process-wide instance; tests
    may instantiate their own for isolation.
    """

    def __init__(self):
        self._named: Dict[str, MetersDict] = {DEFAULT: MetersDict()}
        self._frames: List[_Frame] = []

    # -- window management -------------------------------------------------

    def clear(self) -> None:
        self._named = {DEFAULT: MetersDict()}
        self._frames = []

    @contextlib.contextmanager
    def open(self, name: Optional[str] = None, new_root: bool = False):
        """Open an accumulation window.

        Named windows reuse their MetersDict across openings (cumulative until
        ``reset_meters``); anonymous windows are fresh each time.  With
        ``new_root=True`` the window also acts as a barrier: while it is open,
        writes do not reach any window opened before it (used by nested
        validation so it doesn't pollute the training epoch's stats).
        """
        if name is None:
            agg = MetersDict()
        else:
            if name == DEFAULT:
                raise ValueError("'default' is implicit and cannot be opened")
            agg = self._named.setdefault(name, MetersDict())
        frame = _Frame(agg, new_root)
        self._frames.append(frame)
        try:
            yield agg
        finally:
            # Pop by identity: an exception in user code cannot unbalance the
            # stack beyond this frame, and nested opens of the same name are
            # each their own frame (no refcounting needed).
            for i in range(len(self._frames) - 1, -1, -1):
                if self._frames[i] is frame:
                    del self._frames[i]
                    break

    def active(self) -> List[MetersDict]:
        """Windows that receive writes right now: stack top-down to the first
        barrier, plus the implicit default window (unless barred)."""
        out: List[MetersDict] = []
        seen = set()
        barred = False
        for frame in reversed(self._frames):
            if id(frame.agg) not in seen:
                seen.add(id(frame.agg))
                out.append(frame.agg)
            if frame.barrier:
                barred = True
                break
        if not barred:
            default = self._named[DEFAULT]
            if id(default) not in seen:
                out.append(default)
        return out

    # -- writes ------------------------------------------------------------

    def _write(self, key, make_meter, priority, update):
        for agg in self.active():
            if key not in agg:
                agg.add_meter(key, make_meter(), priority)
            if update is not None:
                update(agg[key])

    def scalar(self, key, value, weight=1, priority=10, round=None):
        self._write(key, lambda: AverageMeter(round=round), priority,
                    lambda m: m.update(value, weight))

    def scalar_sum(self, key, value, priority=10, round=None):
        self._write(key, lambda: SumMeter(round=round), priority,
                    lambda m: m.update(value))

    def derived(self, key, fn, priority=20):
        self._write(key, lambda: MetersDict._DerivedMeter(fn), priority, None)

    def speed(self, key, value, priority=30, round=None):
        # A TimeMeter measures rate since its own creation; only update after
        # the first sighting (creation implies reset-to-now).
        for agg in self.active():
            if key not in agg:
                agg.add_meter(key, TimeMeter(round=round), priority)
                agg[key].reset()
            else:
                agg[key].update(value)

    def start_time(self, key, priority=40, round=None):
        self._write(key, lambda: StopwatchMeter(round=round), priority,
                    lambda m: m.start())

    def stop_time(self, key, weight=0.0, prehook=None):
        for agg in self.active():
            if key in agg:
                agg[key].stop(weight, prehook)

    def custom(self, new_meter_fn, key, *args, priority=50, **kwargs):
        self._write(key, new_meter_fn, priority,
                    lambda m: m.update(*args, **kwargs))

    # -- reads -------------------------------------------------------------

    def window(self, name: str) -> Optional[MetersDict]:
        return self._named.get(name)

    def snapshot(self) -> dict:
        return {name: agg.state_dict() for name, agg in self._named.items()}

    def restore(self, snapshot: dict) -> None:
        # Restore in place so frames already holding a named window keep
        # observing it (a checkpoint load mid-epoch must not orphan the
        # 'train' window an open aggregate() block is writing to).
        for name, agg_state in snapshot.items():
            agg = self._named.setdefault(name, MetersDict())
            agg.load_state_dict(agg_state)  # clears itself first


_stack = MetricsStack()


# -- module-level facade (the API the trainer/CLIs/criterions use) ----------

def reset() -> None:
    _stack.clear()


def aggregate(name: Optional[str] = None, new_root: bool = False):
    return _stack.open(name, new_root=new_root)


def get_active_aggregators() -> List[MetersDict]:
    return _stack.active()


def log_scalar(key: str, value: float, weight: float = 1, priority: int = 10,
               round: Optional[int] = None):
    _stack.scalar(key, value, weight, priority, round)


def log_scalar_sum(key: str, value: float, priority: int = 10,
                   round: Optional[int] = None):
    _stack.scalar_sum(key, value, priority, round)


def log_derived(key: str, fn: Callable[[MetersDict], float], priority: int = 20):
    _stack.derived(key, fn, priority)


def log_speed(key: str, value: float, priority: int = 30,
              round: Optional[int] = None):
    _stack.speed(key, value, priority, round)


def log_start_time(key: str, priority: int = 40, round: Optional[int] = None):
    _stack.start_time(key, priority, round)


def log_stop_time(key: str, weight: float = 0.0, prehook=None):
    _stack.stop_time(key, weight, prehook)


def log_custom(new_meter_fn, key: str, *args, priority: int = 50, **kwargs):
    _stack.custom(new_meter_fn, key, *args, priority=priority, **kwargs)


def reset_meter(name: str, key: str) -> None:
    meter = get_meter(name, key)
    if meter is not None:
        meter.reset()


def reset_meters(name: str) -> None:
    agg = _stack.window(name)
    if agg is not None:
        agg.reset()


def get_meter(name: str, key: str):
    agg = _stack.window(name)
    return agg.get(key, None) if agg is not None else None


def get_meters(name: str):
    return _stack.window(name)


def get_smoothed_value(name: str, key: str) -> float:
    return _stack.window(name).get_smoothed_value(key)


def get_smoothed_values(name: str) -> Dict[str, float]:
    return _stack.window(name).get_smoothed_values()


def state_dict():
    return _stack.snapshot()


def load_state_dict(snapshot):
    _stack.restore(snapshot)


def get_perplexity(loss, round=2, base=2):
    """bits-per-token -> perplexity (capability: fairseq/utils.py get_perplexity)."""
    from .meters import safe_round

    if loss is None:
        return 0.0
    try:
        return safe_round(base**loss, round)
    except OverflowError:
        return float("inf")
