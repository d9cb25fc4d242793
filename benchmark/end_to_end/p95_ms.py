"""The 95th percentile (linear interpolation) of the latency of every request
in the window, call to return, in ms.  With several clients, the requests of
every client together."""

import numpy as np


def read(window):
    return float(np.percentile([(r.end - r.start) * 1e3 for r in window.requests], 95))
