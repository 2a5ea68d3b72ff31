"""host_ms_per_microbatch.train: host time inside Trainer.train_step in the
window, over its micro-batches (program_span: the benchmark's span around
the call)."""

LAYER = "trainer"
UNIT = "ms"
MOVES = "train_audio_s_per_s"


def read(run):
    return 1e3 * run.rec.seconds["trainer.train_step"] / run.rec.counts["microbatches"]
