"""setup_s (s, host clock): from the first line of run.py to the start of the
window: imports, the kernel library from the checkout's build directory,
the data written, the weights drawn on the card, the warm-up and (training)
the checked updates."""

UNIT = "s"


def read(run):
    return run.window["t0"] - run.t_start
