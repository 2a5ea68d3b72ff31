"""data_wait_ms.train: the time the training loop waits for its next update's micro-batches in
the window, over the micro-batches (program_span)."""

LAYER = "data"
UNIT = "ms"
MOVES = "train_audio_s_per_s"


def read(run):
    return 1e3 * run.rec.seconds["data.wait"] / run.rec.counts["microbatches"]
