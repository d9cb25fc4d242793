"""Reduce a torch.profiler trace (Chrome trace format) of a traced stretch
to what the per-layer metrics read.

The harness wraps each request in a `record_function` span named
`SPAN_PREFIX + op`, on its client's host thread.  The stretch runs from the
first span's start to the last span's end.  Device activity is every
kernel, memcpy and memset on the card; kineto puts the card's timestamps on
the host's clock, in microseconds.

With several clients the request spans of different threads overlap.  The
card's activity is then counted inside the requests where it falls inside
their union, since the card serves them all; a host event belongs to the
request span of its own thread.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from pathlib import Path

SPAN_PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 160  # names in the breakdown are cut to this many characters


@dataclass
class Interval:
    start: float  # microseconds
    end: float
    name: str
    cat: str
    thread: tuple | None = None  # (pid, tid) of the event's host thread


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


@dataclass
class TraceView:
    """One traced stretch: its request spans, the card's activity and the
    events of the request spans' host threads, with the byte counts of the
    traced requests."""

    op: str
    kind: str
    requests: list[tuple[int, int]]  # (in bytes, out bytes) of each traced request
    uncompressed: int  # uncompressed bytes of the traced requests
    spans: list[Interval]
    device: list[Interval]
    host: list[Interval]
    window: object = None  # the run's measured window (harness.Window), for the readers on the host's clock
    _union: list[tuple[float, float]] = field(init=False, repr=False)
    _own: dict = field(init=False, repr=False)  # thread -> (starts, its request spans by start)

    def __post_init__(self):
        self.spans.sort(key=lambda i: i.start)
        self._union = _merge([(s.start, s.end) for s in self.spans])
        by_thread: dict = {}
        for s in self.spans:
            by_thread.setdefault(s.thread, []).append(s)
        self._own = {t: ([s.start for s in spans], spans) for t, spans in by_thread.items()}

    @property
    def stretch(self) -> tuple[float, float]:
        return self.spans[0].start, max(s.end for s in self.spans)

    def window_s(self) -> float:
        a, b = self.stretch
        return (b - a) * 1e-6

    def busy(self) -> list[tuple[float, float]]:
        """The merged intervals in which the card ran anything, inside the stretch."""
        a, b = self.stretch
        return _merge([(max(d.start, a), min(d.end, b)) for d in self.device if d.end > a and d.start < b])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def in_spans(self, d: Interval) -> bool:
        """Whether `d` starts inside the union of the request spans."""
        i = bisect.bisect_right(self._union, (d.start, float("inf"))) - 1
        return i >= 0 and d.start <= self._union[i][1]

    def in_own_span(self, h: Interval) -> bool:
        """Whether the host event `h` starts inside a request span of its own thread."""
        starts, spans = self._own.get(h.thread, ((), ()))
        i = bisect.bisect_right(starts, h.start) - 1
        return i >= 0 and h.start <= spans[i].end

    def device_s_in_spans(self, cat: str, name_has: tuple[str, ...] = ("",)) -> float:
        """Summed device time of the activities of `cat` that start inside a
        request span (`in_spans`), whose names hold one of `name_has`."""
        return sum(d.end - d.start for d in self.device
                   if d.cat == cat and any(k in d.name for k in name_has) and self.in_spans(d)) * 1e-6

    def device_ops(self, top: int = 10) -> list[list]:
        """[name, seconds] of the device activities that took the most time in the stretch."""
        a, b = self.stretch
        total: dict[str, float] = {}
        for d in self.device:
            if d.start >= a and d.start <= b:
                total[d.name] = total.get(d.name, 0.0) + (d.end - d.start) * 1e-6
        return [[n[:NAME_CHARS], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """[host activity, seconds] of the longest spells in which the card ran
        nothing, each named by the innermost host event around its middle:
        of all the request spans' threads, the one that started last."""
        a, b = self.stretch
        edges = [a, *(t for iv in self.busy() for t in iv), b]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)), reverse=True)
        host = sorted(self.host, key=lambda h: h.start)
        starts = [h.start for h in host]
        out = []
        for length, s in gaps[:top]:
            if length <= 0:
                break
            mid = s + length / 2
            name = "(no host event)"
            for h in reversed(host[: bisect.bisect_right(starts, mid)]):
                if h.end >= mid:
                    name = h.name
                    break
            out.append([name[:NAME_CHARS], length * 1e-6])
        return out


def load(path: Path, op: str, kind: str, requests: list[tuple[int, int]], uncompressed: int) -> TraceView:
    """Read an exported Chrome trace into a TraceView."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return view(events, op, kind, requests, uncompressed)


def view(events: list[dict], op: str, kind: str, requests: list[tuple[int, int]], uncompressed: int) -> TraceView:
    span_name = SPAN_PREFIX + op
    spans, device, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = Interval(float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e.get("name", "")), str(e.get("cat", "")),
                      (e.get("pid"), e.get("tid")))
        if iv.cat == "user_annotation" and iv.name == span_name:
            spans.append(iv)
        if iv.cat in DEVICE_CATS:
            device.append(iv)
        elif iv.cat in HOST_CATS:
            host.append(iv)
    if not spans:
        raise ValueError(f"no {span_name!r} spans in the trace")
    span_threads = {s.thread for s in spans}
    return TraceView(op, kind, requests, uncompressed, spans, device, [h for h in host if h.thread in span_threads])
