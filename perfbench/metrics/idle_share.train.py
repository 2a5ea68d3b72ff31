"""idle_share.train: the share of the profiled slice in which no kernel, copy or set ran on
the device (device_trace, trace_busy)."""

LAYER = "device"
UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run):
    return None if run.profile is None else 100.0 * (1.0 - run.profile["busy_share"])
