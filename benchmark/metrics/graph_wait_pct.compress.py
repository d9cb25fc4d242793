"""The share of the compress requests' host time that callers spent waiting
for the encoder's graph lock, in %: the host time of the program's
`snappy.graph_wait` spans (each inside a request span of its own thread)
over the host time of the request spans, both summed over the threads.  The
lock lets one thread at a time capture or replay a graph, so with several
clients this is what serialised replays cost the callers.  A program
without that span, or a run whose calls never reach the graph path (no
card), reads nothing."""

from benchmark import program_spans


def read(view):
    if not program_spans.compress_view(view):
        return None
    waits = program_spans.steps(view, "graph_wait")
    if not waits:
        return None
    return 100.0 * sum(s.end - s.start for s in waits) / sum(s.end - s.start for s in view.spans)
