"""The least time of the traced compress requests (the object read once, the
stream written once, at the card's peak bandwidth) over the device time of
every kernel launched inside their spans, in %.  With several clients, every
traced request's least time over the kernels that start inside the union of
the overlapping request spans."""

from benchmark import roofline


def read(view):
    if view.op != "compress":
        return None
    kernels = view.device_s_in_spans("kernel")
    return 100.0 * roofline.least_seconds(view.op, view.requests, view.kind) / kernels if kernels > 0 else None
