"""Progress reporting (counterpart of chimera_st_tpu/logging/progress_bar.py:
the same formats, line for line).

One ``Progress`` driver composed from two kinds of plain values:

  * a **renderer** — a function ``(ctx, stats, mode, tag) -> Optional[str]``
    picked from ``_RENDERERS`` by format name; returning None emits nothing;
  * zero or more **sinks** — callables ``(stats, tag, step)`` that receive
    every log/print event (TensorBoard is just a sink, not a wrapper).

The CLI surface is ``--log-format json|simple|tqdm|none`` and
``--tensorboard-logdir``. ``tqdm`` and ``tensorboardX`` are imported only
when asked for: without ``tqdm`` the format falls back to ``simple``, without
``tensorboardX`` the sink logs a warning and writes nothing, as in the JAX
package.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from numbers import Number
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


def format_stat(stat):
    """Human-compact rendering of one stat value."""
    if isinstance(stat, bool):
        return str(stat)
    if isinstance(stat, int):
        return "{:g}".format(stat)
    if isinstance(stat, Number):
        return "{:.3f}".format(stat) if abs(stat) < 1e4 else "{:.3g}".format(stat)
    if hasattr(stat, "item"):  # 0-d numpy array or tensor
        return format_stat(stat.item())
    if hasattr(stat, "elapsed_time"):  # a running StopwatchMeter
        return "{:g}".format(round(stat.elapsed_time))
    return str(stat)


class _Ctx:
    """Iteration position shared between the driver and renderers."""

    __slots__ = ("epoch", "prefix", "i", "size", "log_interval")

    def __init__(self, epoch, prefix, log_interval):
        parts = []
        if epoch is not None:
            parts.append(f"epoch {epoch:03d}")
        if prefix:
            parts.append(prefix)
        self.epoch = epoch
        self.prefix = " | ".join(parts)
        self.i = 0
        self.size = None
        self.log_interval = log_interval


def _render_none(ctx, stats, mode, tag):
    return None


def _render_simple(ctx, stats, mode, tag):
    pairs = [(k, format_stat(v)) for k, v in stats.items()]
    if mode == "log":
        body = ", ".join(f"{k}={v}" for k, v in pairs)
        return f"{ctx.prefix}: {ctx.i + 1:5d} / {ctx.size}  {body}"
    body = " | ".join(f"{k} {v}" for k, v in pairs)
    return f"{ctx.prefix} | {body}"


def _render_json(ctx, stats, mode, tag):
    out = {}
    if ctx.epoch is not None:
        out["epoch"] = ctx.epoch
        if mode == "log" and ctx.size:
            # fractional progress through the run, e.g. 2.25 = 1/4 into epoch 3
            out["update"] = round(ctx.epoch - 1 + (ctx.i + 1) / ctx.size, 3)
    for k, v in stats.items():
        out[(f"{tag}_{k}" if tag and mode == "print" else k)] = format_stat(v)
    return json.dumps(out)


_RENDERERS: Dict[str, Callable] = {
    "none": _render_none,
    "simple": _render_simple,
    "json": _render_json,
}


class Progress:
    """Wraps an epoch iterable; forwards stats to a renderer and sinks."""

    def __init__(self, iterable, renderer, sinks=(), epoch=None, prefix=None,
                 log_interval=100, rate_limited=True):
        self._iterable = iterable
        self._renderer = renderer
        self._sinks: List[Callable] = list(sinks)
        self._rate_limited = rate_limited
        self.ctx = _Ctx(epoch, prefix, log_interval)
        self.ctx.i = getattr(iterable, "n", 0)  # resume offset mid-epoch

    def __len__(self):
        return len(self._iterable)

    def __iter__(self):
        self.ctx.size = len(self._iterable)
        start = self.ctx.i
        for i, item in enumerate(self._iterable, start=start):
            self.ctx.i = i
            yield item

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _emit(self, stats, mode, tag, step):
        for sink in self._sinks:
            sink(stats, tag, step)
        line = self._renderer(self.ctx, stats, mode, tag)
        if line is not None:
            logger.info(line)

    def log(self, stats, tag=None, step=None):
        """Mid-epoch stats; rendered only on log_interval boundaries."""
        step = step or self.ctx.i
        interval = self.ctx.log_interval
        if self._rate_limited and not (step > 0 and interval and step % interval == 0):
            for sink in self._sinks:
                sink(stats, tag, step)
            return
        self._emit(stats, "log", tag, step)

    def print(self, stats, tag=None, step=None):
        """End-of-epoch summary; always rendered."""
        self._emit(stats, "print", tag, step)

    def update_config(self, config):
        pass


class _TqdmProgress(Progress):
    """tqdm live bar; log() updates the postfix instead of printing lines."""

    def __init__(self, iterable, sinks=(), epoch=None, prefix=None):
        super().__init__(iterable, _render_simple, sinks, epoch, prefix)
        from tqdm import tqdm

        self._bar = tqdm(iterable, self.ctx.prefix, leave=False,
                         disable=not sys.stderr.isatty())

    def __iter__(self):
        self.ctx.size = len(self._iterable)
        for i, item in enumerate(self._bar):
            self.ctx.i = i
            yield item

    def log(self, stats, tag=None, step=None):
        for sink in self._sinks:
            sink(stats, tag, step or self.ctx.i)
        self._bar.set_postfix(
            {k: format_stat(v) for k, v in stats.items()}, refresh=False
        )


class TensorboardSink:
    """Writes numeric stats to per-tag SummaryWriters (tensorboardX)."""

    def __init__(self, logdir: str):
        self._logdir = logdir
        self._writers: Dict[str, object] = {}
        try:
            from tensorboardX import SummaryWriter

            self._cls = SummaryWriter
        except ImportError:
            logger.warning("tensorboardX not found; tensorboard logging disabled")
            self._cls = None

    def __call__(self, stats, tag, step):
        if self._cls is None:
            return
        key = tag or ""
        writer = self._writers.get(key)
        if writer is None:
            writer = self._writers[key] = self._cls(os.path.join(self._logdir, key))
        if step is None:
            step = stats.get("num_updates", 0)
        for name, value in stats.items():
            if name == "num_updates":
                continue
            if hasattr(value, "item"):
                value = value.item()
            if hasattr(value, "avg"):
                value = value.avg
            if isinstance(value, Number):
                writer.add_scalar(name, value, step)
        writer.flush()


def progress_bar(
    iterator,
    log_format: Optional[str] = None,
    log_interval: int = 100,
    epoch: Optional[int] = None,
    prefix: Optional[str] = None,
    tensorboard_logdir: Optional[str] = None,
    default_log_format: str = "simple",
):
    """Build the progress reporter the CLIs use (reference factory surface)."""
    fmt = log_format or default_log_format
    sinks = [TensorboardSink(tensorboard_logdir)] if tensorboard_logdir else []
    if fmt == "tqdm":
        try:
            return _TqdmProgress(iterator, sinks, epoch, prefix)
        except ImportError:
            fmt = "simple"
    if fmt not in _RENDERERS:
        raise ValueError(f"Unknown log format: {fmt}")
    return Progress(iterator, _RENDERERS[fmt], sinks, epoch, prefix, log_interval)
