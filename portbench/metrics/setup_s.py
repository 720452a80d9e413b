"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the world, the inputs drawn on the cards, the warm-up call."""


def read(run):
    return run.setup_s
