"""The share of the encoder's device calls that found its graph lock held
by another thread, in %: the program's counter `encode.graph_waits` over
`encode.graph_replays` + `encode.graph_captures` + `encode.eager_calls`,
over every compress call of the run, the warm-up's with them, summed over
the clients.  The counter exists from a call's first wait; a program that
has it records a `snappy.graph_wait` span around every graph-path call, so
a traced stretch with such spans and no count reads 0.  A program without
that span, or a run whose calls never reach the graph path (no card), reads
nothing."""

from benchmark import program_spans


def read(view):
    if not program_spans.compress_view(view) or not program_spans.steps(view, "graph_wait"):
        return None
    from snappytpu_torch import profiling

    counts = profiling.counters()
    calls = sum(counts.get(k, 0) for k in ("encode.graph_replays", "encode.graph_captures", "encode.eager_calls"))
    return 100.0 * counts.get("encode.graph_waits", 0) / calls if calls else None
