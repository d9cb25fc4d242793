"""Seconds from the harness's first line to the first timed request: imports,
starting CUDA, building or loading the kernels, making the data, and the
warm-up pass."""


def read(window):
    return window.setup_s
