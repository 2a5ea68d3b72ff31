"""Meters, the metrics facade and the progress reporter (counterpart of
chimera_st_tpu/logging/)."""

from . import meters, metrics, progress_bar

__all__ = ["metrics", "meters", "progress_bar"]
