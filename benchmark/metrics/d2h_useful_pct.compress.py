"""The share of the encoder's output copied back to the host that is stream,
in %: the program's counters `compress.stream_bytes` over
`compress.d2h_bytes`, over every compress call of the run. With several
clients, the counters sum every client's calls."""

from benchmark import program_spans


def read(view):
    if not program_spans.compress_view(view):
        return None
    from snappytpu_torch import profiling

    counts = profiling.counters()
    d2h = counts.get("compress.d2h_bytes", 0)
    return 100.0 * counts.get("compress.stream_bytes", 0) / d2h if d2h else None
