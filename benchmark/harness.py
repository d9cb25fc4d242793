"""One run of one cell: set-up, the measured window, the check, the metrics.

The window is a closed loop with one client, as a codec library's caller
waits for each call: each request calls `snappytpu_torch.api.compress` or
`api.decompress` on host bytes and takes host bytes back.  The window opens
with the first request after the warm-up and closes when the first request
that ends past `seconds` returns; every request in it counts.

Every answer is judged once the window has closed, and memory stays flat
however long the window runs: the first answer for each unit is kept, and a
later one that equals it byte for byte is counted against it, so that it
takes its verdict; only one that differs is kept besides.

A traced run (`trace=True`) measures the same window, then profiles whole
passes after it until they hold `TRACED_REQUESTS` requests, each wrapped in
a `record_function` span: its numbers are the per-layer metrics, read from
the traced passes or, for those on the host's clock, from the window.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch

from . import cells, datagen, devtrace, judge, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "snappytpu")
WARM_CALLS = 3  # the warm-up makes at least this many calls, whole passes over the units
TRACED_REQUESTS = 20  # a fixed amount of traced work, whatever the speed


@dataclass
class Request:
    unit: int
    start: float
    end: float
    in_bytes: int
    out_bytes: int
    failed: bool


@dataclass
class Answers:
    """The window's answers by unit: each distinct answer with how many times it came."""

    by_unit: dict[int, list[list]] = field(default_factory=dict)  # unit -> [[bytes, count], ...]

    def add(self, unit: int, answer: bytes) -> None:
        distinct = self.by_unit.setdefault(unit, [])
        for entry in distinct:
            if entry[0] == answer:
                entry[1] += 1
                return
        distinct.append([answer, 1])

    def __iter__(self):
        """(unit, answer, count) of each distinct answer."""
        return ((u, a, c) for u, distinct in self.by_unit.items() for a, c in distinct)

    def __len__(self) -> int:
        return sum(c for _, _, c in self)


@dataclass
class Window:
    """What the end-to-end readers read."""

    op: str
    setup_s: float
    seconds: float = 0.0
    requests: list[Request] = field(default_factory=list)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_record(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run `cell` once and return its result line (a dict)."""
    from snappytpu_torch import api

    op, profile = cell.traffic["op"], cell.config["profile"]
    units = traffic.units(cell.traffic, datagen.make_objects(cell.config, seed, device))
    if op == "compress":
        inputs = units

        def call(x):
            return api.compress(x, profile, device=device)
    else:
        inputs = [api.compress(u, profile, device=device) for u in units]

        def call(x):
            return api.decompress(x, device=device)
    uncompressed = [u.size for u in units]
    del units
    for x in (inputs * WARM_CALLS)[: max(len(inputs), WARM_CALLS)]:  # warm-up: every call shape of the window, and
        call(x)  # the allocator's blocks; each call returns host bytes, so the card is idle after
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()

    window = Window(op, setup_s=time.perf_counter() - t_start)
    answers = Answers()
    passes = traffic.passes(len(inputs), seed)
    t_open = time.perf_counter()
    for order in passes:
        if _serve(call, inputs, order, uncompressed, op, window.requests, answers, until=t_open + seconds):
            break
    window.seconds = window.requests[-1].end - t_open
    traced: list[Request] = []
    if trace:  # whole passes after the window, each request in a span
        prof = _profiler(device)
        prof.start()
        while len(traced) < TRACED_REQUESTS:
            _serve(call, inputs, next(passes), uncompressed, op, traced, answers, span=devtrace.SPAN_PREFIX + op)
        prof.stop()
    gc.unfreeze()

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {found}")
    if cuda:
        torch.cuda.empty_cache()
    failed = sum(r.failed for r in window.requests + traced)
    checks = judge.judge(cell, seed, answers, inputs if op == "decompress" else None, failed, device)
    result = {
        "correct": judge.correct(checks, len(answers)),
        "attempted": len(window.requests) + len(traced),
        "failed": failed,
    }
    if trace:
        view = _read_trace(prof, op, device, traced, uncompressed)
        view.window = window
        result["metrics"] = _read(cell.per_layer, view)
        result["device"] = device_record(device, peak) | {"busy_s": view.busy_s(), "window_s": view.window_s()}
        result["breakdown"] = {"device_ops": view.device_ops(), "idle_gaps": view.idle_gaps()}
    else:
        result["metrics"] = _read(cell.end_to_end, window)
        result["device"] = device_record(device, peak)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def _serve(call, inputs, order, uncompressed, op, out: list[Request], answers: Answers, until=None, span=None) -> bool:
    """Serve the requests of one pass in `order`, appending each to `out`;
    True where one ended at or past `until`, which ends the pass there."""
    for i in order:
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(span) if span else contextlib.nullcontext():
                answer = call(inputs[i])
            failed = False
        except Exception:  # a request that raises is a failed request, not the end of the run
            if not any(r.failed for r in out):
                traceback.print_exc(file=sys.stderr)
            answer, failed = b"", True
        t1 = time.perf_counter()
        out.append(Request(int(i), t0, t1, len(inputs[i]) if op == "decompress" else uncompressed[i], len(answer), failed))
        if not failed:
            answers.add(int(i), answer)
        if until is not None and t1 >= until:
            return True
    return False


def _read_trace(prof, op, device, traced: list[Request], uncompressed: list[int]) -> devtrace.TraceView:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        kind = device_record(device, 0)["kind"]
        return devtrace.load(path, op, kind, [(r.in_bytes, r.out_bytes) for r in traced],
                             sum(uncompressed[r.unit] for r in traced))
    finally:
        os.unlink(path)


def _read(metrics, record) -> dict:
    out = {}
    for m in metrics:
        value = m.reader.read(record)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
