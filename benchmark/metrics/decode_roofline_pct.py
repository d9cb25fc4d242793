"""The least time of the traced decompress requests (the stream read once,
the output written once, at the card's peak bandwidth) over the device time
of every kernel launched inside their spans, in %.  With several clients,
every traced request's least time over the kernels that start inside the
union of the overlapping request spans."""

from benchmark import decode_spans, roofline


def read(view):
    if not decode_spans.decompress_view(view):
        return None
    kernels = view.device_s_in_spans("kernel")
    return 100.0 * roofline.least_seconds(view.op, view.requests, view.kind) / kernels if kernels > 0 else None
