"""Tracing/profiling utilities — the counterpart of snappytpu.profiling.

Spans and counters of the served path:

  span(name)        a context manager around one step of `api.compress` or
                    `api.decompress`, named `snappy.<step>`.  It enters
                    `torch.profiler.record_function(name)` only while a
                    torch profiler is recording, and otherwise costs one
                    flag check.  The flag is torch's process-wide one, set
                    while any torch profiler records: a profiler of every
                    thread (`profile_all_threads`) records on threads whose
                    own profiler flag stays off, so the spans of each client
                    thread are in its trace too.  So tracing is on exactly
                    when someone profiles, as `device_trace` below does, and
                    kineto writes the spans into the same trace, on the same
                    clock, as the kernels and copies they enqueue.  Nothing
                    is kept besides what the profiler keeps.  The API is
                    synchronous and runs on the calling thread: a span
                    belongs to the request whose `snappy.compress` or
                    `snappy.decompress` span encloses it on that thread, and
                    that enclosing span is the request's identifier.
  count(name, n)    adds n to a counter of the process's registry: integer
                    adds on the host under one lock, so exact when several
                    threads count at once; always on.  `counters()` reads a
                    copy, `reset_counters()` empties it.  Names are
                    `<module or op>.<what>`, e.g. `concat.launches`,
                    `compress.d2h_bytes`.
  count_launch(k)   one launch of the hand kernel k (`concat`, `tier_b`):
                    `k.launches` when it runs now, `k.recorded` when a CUDA
                    graph capture records it; each replay of that graph
                    counts what it recorded as `k.graph_runs` (encode_v2).
                    So launches plus graph runs are the kernel's runs.

For the profiling tools: per-stage wall timings that synchronise the device
at each boundary (so not for the served path, whose copies they would
serialise), a phase breakdown report in the JAX module's format, a
torch.profiler trace wrapper and a warm-up-then-measure helper.  On a CPU
tensor nothing is synchronised: CPU work is already done when the call
returns, and no card is timed.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler  # its _is_profiler_enabled: true while a profiler records

_OFF = contextlib.nullcontext()
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()


def span(name: str):
    """`with span("snappy.<step>"):` records the block as a
    `record_function` span while a torch profiler records, on any thread;
    else nothing."""
    return torch.profiler.record_function(name) if _autograd_profiler._is_profiler_enabled else _OFF


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def count_launch(kernel: str) -> None:
    """Count one launch of a hand kernel, as run now or as recorded into a
    CUDA graph capture on the current stream."""
    count(f"{kernel}.recorded" if torch.cuda.is_current_stream_capturing() else f"{kernel}.launches")


def counters() -> dict[str, int]:
    """A copy of every counter counted since the last reset."""
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _counts_lock:
        _counts.clear()


def _sync(tensors) -> None:
    """Wait for the CUDA devices that hold any of `tensors` (a tensor, or a
    nested list/tuple of them); CPU tensors need no wait."""
    devices = set()
    stack = [tensors]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if t.device.type == "cuda":
                devices.add(t.device)
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates wall time per named stage, synchronising the devices of
    the given tensors at each boundary so stage costs are attributable (CUDA
    launches are asynchronous)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *sync_tensors):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        _sync(sync_tensors)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        if not self.totals:
            return "(no stages recorded)"
        width = max(len(k) for k in self.totals)
        total = sum(self.totals.values())
        lines = [f"{'stage':<{width}}  calls     ms    share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<{width}}  {self.counts[name]:>5}  {t*1000:>7.2f}  {t/total*100:>5.1f}%"
            )
        lines.append(f"{'TOTAL':<{width}}  {'':>5}  {total*1000:>7.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block, CPU and (where present) CUDA
    activities; writes a Chrome trace into log_dir and yields the profiler
    (its key_averages() sums time by kernel)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def timed(fn, *args, reps: int = 5, warmup: int = 1):
    """Warm-up-then-measure helper: returns (result, seconds_per_call), with
    the devices of the result synchronised before each clock reading."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return out, (time.perf_counter() - t0) / reps
