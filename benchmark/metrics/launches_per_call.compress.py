"""Kernel launches the host makes inside the program's `snappy.encode`
spans of a compress cell, over the number of those spans (the encoder's
device calls)."""

from benchmark import program_spans


def read(view):
    if not program_spans.compress_view(view) or not view.device:
        return None
    calls = program_spans.steps(view, "encode")
    n = program_spans.launches(view, calls)
    return n / len(calls) if n else None
