"""Seconds from the process's start to the first timed request: imports, the
CUDA context, kernel builds and loads, weights and inputs from the seed,
and the warm-up of every shape the cell uses."""


def read(window):
    return window.setup_s
