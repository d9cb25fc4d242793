"""The share of `api.decompress`'s block-route device calls whose blocks the
card parsed (K2), in %: the program's counters `decompress.k2_calls` over
`decompress.device_calls`, over every decompress call of the run, the
warm-up's with them. A program without the K2 counter (one that builds every
call's tapes on the host, or a run in which no call took K2) reads nothing.
With several clients, the counters sum every client's calls."""

from benchmark import decode_spans


def read(view):
    if not decode_spans.decompress_view(view):
        return None
    from snappytpu_torch import profiling

    counts = profiling.counters()
    calls = counts.get("decompress.device_calls", 0)
    if "decompress.k2_calls" not in counts or not calls:
        return None
    return 100.0 * counts["decompress.k2_calls"] / calls
