"""Reduce a torch.profiler trace (Chrome trace format) of a traced stretch
to what the per-layer metrics read.

The harness wraps each request in a `record_function` span named
`SPAN_PREFIX + op`.  The stretch runs from the first span's start to the
last span's end.  Device activity is every kernel, memcpy and memset on the
card; kineto puts the card's timestamps on the host's clock, in
microseconds.
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
    host thread's events, with the byte counts of the traced requests."""

    op: str
    kind: str
    requests: list[tuple[int, int]]  # (in bytes, out bytes) of each traced request
    uncompressed: int  # uncompressed bytes of the traced requests
    spans: list[Interval]
    device: list[Interval]
    host: list[Interval]
    window: object = None  # the run's measured window (harness.Window), for the readers on the host's clock
    _starts: list[float] = field(init=False, repr=False)

    def __post_init__(self):
        self.spans.sort(key=lambda i: i.start)
        self._starts = [s.start for s in self.spans]

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
        i = bisect.bisect_right(self._starts, d.start) - 1
        return i >= 0 and d.start <= self.spans[i].end

    def device_s_in_spans(self, cat: str, name_has: tuple[str, ...] = ("",)) -> float:
        """Summed device time of the activities of `cat` that start inside a
        request span, whose names hold one of `name_has`."""
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
        nothing, each named by the innermost host event around its middle."""
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
    spans, device, host, span_threads = [], [], [], set()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = Interval(float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e.get("name", "")), str(e.get("cat", "")))
        if iv.cat == "user_annotation" and iv.name == span_name:
            spans.append(iv)
            span_threads.add((e.get("pid"), e.get("tid")))
        if iv.cat in DEVICE_CATS:
            device.append(iv)
        elif iv.cat in HOST_CATS:
            host.append((iv, (e.get("pid"), e.get("tid"))))
    if not spans:
        raise ValueError(f"no {span_name!r} spans in the trace")
    return TraceView(op, kind, requests, uncompressed, spans, device, [h for h, t in host if t in span_threads])
