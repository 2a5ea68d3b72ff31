"""k2_roofline.train: K2's share of its roofline in the profiled slice: the sum over its
launches of the least time each could take (yardstick/counters.py) over
their device time, matched by kernel name (device_trace)."""

from perfbench import probe

LAYER = "kernel K2"
UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run):
    return probe.roofline(run, "K2")
