"""One run of one cell: set-up, the measured window, the check, the metrics.

The window is a closed loop, as a codec library's caller waits for each
call: each request calls `snappytpu_torch.api.compress` or `api.decompress`
on host bytes and takes host bytes back.  With one client (the traffic
mix's `clients` 1 or absent) the window opens with the first request after
the warm-up and closes when the first request that ends past `seconds`
returns; every request in it counts.

With `clients` N > 1, N threads each run one client over the one card, as
the task threads of one process do.  Each makes the warm-up calls itself
(so each has its own kept host buffers), then all wait at one barrier; the
window opens when it releases.  Each client stops at its first request
that ends past `seconds`, and the window closes when the last one stops;
every client's requests count.  A request that raises is a failed request;
a client thread that dies any other way fails the run, which then gives no
result.

Every answer is judged once the window has closed, and memory stays flat
however long the window runs: the first answer for each unit is kept, and a
later one that equals it byte for byte is counted against it, so that it
takes its verdict; only one that differs is kept besides.

A traced run (`trace=True`) measures the same window, then profiles whole
passes after it until they hold `TRACED_REQUESTS` requests, each wrapped in
a `record_function` span on its client's thread: its numbers are the
per-layer metrics, read from the traced passes or, for those on the host's
clock, from the window.  With N clients the same N threads serve those
passes at once, under a profiler of every thread.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import threading
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
    client: int = 0


@dataclass
class Answers:
    """The window's answers by unit: each distinct answer with how many times it came."""

    by_unit: dict[int, list[list]] = field(default_factory=dict)  # unit -> [[bytes, count], ...]

    def add(self, unit: int, answer: bytes, count: int = 1) -> None:
        distinct = self.by_unit.setdefault(unit, [])
        for entry in distinct:
            if entry[0] == answer:
                entry[1] += count
                return
        distinct.append([answer, count])

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


def _profiler(device, all_threads: bool = False):
    """A profiler of the card and of the host thread that starts it, or,
    with `all_threads`, of every host thread."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if all_threads:
        return torch.profiler.profile(activities=acts,
                                      experimental_config=torch.profiler._ExperimentalConfig(profile_all_threads=True))
    return torch.profiler.profile(activities=acts)


def _open_window(device, t_start: float) -> tuple[float, float]:
    """(set-up seconds, the window's opening time), once every warm-up call
    has returned: the peak of device memory is read from here on."""
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()
    t_open = time.perf_counter()
    return t_open - t_start, t_open


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
    # warm-up: every call shape of the window, and the allocator's blocks; each call returns host bytes, so the card
    # is idle after
    warm = (inputs * WARM_CALLS)[: max(len(inputs), WARM_CALLS)]
    n_clients = traffic.clients(cell.traffic)
    if n_clients > 1:
        window, traced, answers, prof = _serve_clients(n_clients, call, inputs, warm, uncompressed, op, seed, seconds,
                                                       trace, device, t_start)
    else:
        for x in warm:
            call(x)
        setup_s, t_open = _open_window(device, t_start)
        window = Window(op, setup_s=setup_s)
        answers = Answers()
        passes = traffic.passes(len(inputs), seed)
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

    cuda = torch.device(device).type == "cuda"
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


def _serve_clients(n: int, call, inputs, warm, uncompressed, op, seed: int, seconds: float, trace: bool, device,
                   t_start: float):
    """`n` closed-loop clients at once, each in a thread of its own:
    (window, traced requests, answers, profiler or None)."""
    window = Window(op, setup_s=0.0)
    t_open = 0.0
    requests: list[list[Request]] = [[] for _ in range(n)]
    traced: list[list[Request]] = [[] for _ in range(n)]
    answers = [Answers() for _ in range(n)]
    held, lock = 0, threading.Lock()  # traced requests so far, over the clients

    def open_window():
        nonlocal t_open
        window.setup_s, t_open = _open_window(device, t_start)

    opened = threading.Barrier(n, action=open_window)
    closed, go = threading.Barrier(n + 1), threading.Barrier(n + 1)  # the main thread starts the profiler between
    barriers, errors = (opened, closed, go), []

    def client(k: int) -> None:
        nonlocal held
        try:
            for x in warm:
                call(x)
            opened.wait()
            passes = traffic.passes(len(inputs), seed, k)
            for order in passes:
                if _serve(call, inputs, order, uncompressed, op, requests[k], answers[k], until=t_open + seconds,
                          client=k):
                    break
            if not trace:
                return
            closed.wait()
            go.wait()
            while True:  # whole passes, until the clients together hold TRACED_REQUESTS
                with lock:
                    if held >= TRACED_REQUESTS:
                        return
                before = len(traced[k])
                _serve(call, inputs, next(passes), uncompressed, op, traced[k], answers[k],
                       span=devtrace.SPAN_PREFIX + op, client=k)
                with lock:
                    held += len(traced[k]) - before
        except BaseException as e:  # noqa: BLE001 - any death of a client fails the run, below
            errors.append(e)
            for b in barriers:
                b.abort()

    threads = [threading.Thread(target=client, args=(k,), name=f"client{k}", daemon=True) for k in range(n)]
    for t in threads:
        t.start()
    prof = None
    try:
        if trace:
            closed.wait()
            started = _profiler(device, all_threads=True)
            started.start()
            prof = started
            go.wait()
    except BaseException as e:  # noqa: BLE001 - raised below, once every client has ended
        errors.append(e)
        for b in barriers:
            b.abort()
    for t in threads:
        t.join()
    if prof is not None:
        prof.stop()
    if errors:
        first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)), errors[0])
        raise RuntimeError(f"a client of {n} failed; the run gives no result") from first

    window.requests = sorted((r for rs in requests for r in rs), key=lambda r: r.start)
    window.seconds = max(r.end for r in window.requests) - t_open
    merged = answers[0]
    for other in answers[1:]:
        for unit, answer, count in other:
            merged.add(unit, answer, count)
    return window, sorted((r for rs in traced for r in rs), key=lambda r: r.start), merged, prof


def _serve(call, inputs, order, uncompressed, op, out: list[Request], answers: Answers, until=None, span=None,
           client: int = 0) -> bool:
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
        out.append(Request(int(i), t0, t1, len(inputs[i]) if op == "decompress" else uncompressed[i], len(answer), failed,
                           client))
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
