"""The share of the encoder's device calls that ran as a CUDA graph replay,
in %: the program's counters `encode.graph_replays` over
`encode.graph_replays` + `encode.graph_captures` + `encode.eager_calls`, over
every compress call of the run, the warm-up's with them. A run without a card
reads 0: every call there is eager. A program without those counters reads
nothing.  With several clients, the counters sum every client's calls."""

from benchmark import program_spans


def read(view):
    if not program_spans.compress_view(view):
        return None
    from snappytpu_torch import profiling

    counts = profiling.counters()
    replays = counts.get("encode.graph_replays", 0)
    calls = replays + counts.get("encode.graph_captures", 0) + counts.get("encode.eager_calls", 0)
    return 100.0 * replays / calls if calls else None
