"""Seconds from the harness's first line to the first timed request: imports,
starting CUDA, building or loading the kernels, making the data, and the
warm-up pass.  With several clients, up to the moment the last client's
warm-up ends and the window opens."""


def read(window):
    return window.setup_s
