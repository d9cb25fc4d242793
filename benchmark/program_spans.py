"""What the per-layer metrics of the program's own steps read: the spans
`snappy.<step>` that `snappytpu_torch.profiling.span` records inside
`api.compress` while a torch profiler records.  kineto writes them as user
annotations on the thread of the request that calls the program, so they
are among a TraceView's host events, on the card's clock.  A program
without them has none, and the readers read nothing (None).

With several clients, requests overlap: each step belongs to the request
span of its own thread, and a reader that sums steps' time sums it over the
threads."""

from __future__ import annotations

from .devtrace import Interval, _merge

PREFIX = "snappy."
FRAMING = ("pack", "rows", "compact", "join")  # the host's framing and copies of api.compress


def steps(view, *names: str) -> list[Interval]:
    """The program's spans `snappy.<name>` that start inside a request span
    of their own thread, by start."""
    want = {PREFIX + n for n in names}
    return sorted((h for h in view.host if h.cat == "user_annotation" and h.name in want and view.in_own_span(h)),
                  key=lambda h: h.start)


def compress_view(view) -> bool:
    """A compress cell's traced stretch with the program's request spans in it."""
    return view.op == "compress" and bool(steps(view, "compress"))


def _overlap_us(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """The summed overlap of two lists of disjoint intervals sorted by start."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s(view, spans: list[Interval]) -> float:
    """Seconds of the traced stretch in which the card ran nothing while the
    host was inside one of `spans`: with several clients, while any thread
    was inside one of them, each second counted once."""
    a, b = view.stretch
    inside = _merge([(max(s.start, a), min(s.end, b)) for s in spans if s.end > a and s.start < b])
    return (sum(e - s for s, e in inside) - _overlap_us(inside, view.busy())) * 1e-6
