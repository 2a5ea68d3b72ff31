"""train_audio_s_per_s (audio_s/s, host clock): unpadded seconds of source
audio in every micro-batch of the updates dispatched in the window, over
the window's wall time, which ends at a synchronise after the last of
them."""

UNIT = "audio_s/s"


def read(run):
    return run.work["audio_s"] / run.window_s
