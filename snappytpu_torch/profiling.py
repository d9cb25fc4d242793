"""Tracing/profiling utilities — the counterpart of snappytpu.profiling.

Per-stage wall timings that synchronise the device at each boundary, a phase
breakdown report in the JAX module's format, a torch.profiler trace wrapper
and a warm-up-then-measure helper.  On a CPU tensor nothing is synchronised:
CPU work is already done when the call returns, and no card is timed.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
