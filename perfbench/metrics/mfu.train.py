"""mfu.train: the model operations that the window's micro-batches need (forward and
backward, unpadded lengths; yardstick/flops.py) over the window's wall time
times the bf16 dense peak, 989 TFLOP/s (device_trace: the peak; the
window's clock)."""

from perfbench.yardstick import counters

LAYER = "device"
UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run):
    return 100.0 * run.work["flops"] / (run.window_s * counters.BF16_FLOPS)
