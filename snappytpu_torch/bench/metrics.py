"""Metrics, timing, and CSV observability.

Reproduces the reference's results module (result.c): terminal reports of
sizes/ratio/%saved/speed (result.c:19-41) and append-only CSVs with the schema
`input_size,output_size,comp_ratio,time_taken,speed` (result.c:67-95) —
extended with `n_chips,n_hosts,phase,backend` columns so multi-chip numbers
remain directly comparable to Test_results/*.csv.  Timing uses wall clock
(the reference used clock() CPU time, result.c:10-17, acceptable only because
it was single-threaded; wall time is the honest choice for device work).
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    """start/stop wall timer, reference start_time/stop_time equivalent."""

    t0: float = 0.0
    elapsed: float = 0.0

    def start(self):
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


@dataclass
class Result:
    phase: str  # "compress" | "decompress"
    input_size: int
    output_size: int
    time_taken: float
    backend: str = "device"
    n_chips: int = 1
    n_hosts: int = 1
    extra: dict = field(default_factory=dict)

    @property
    def comp_ratio(self) -> float:
        if self.phase == "compress":
            return self.input_size / max(self.output_size, 1)
        return self.output_size / max(self.input_size, 1)

    @property
    def speed_mbps(self) -> float:
        """MB/s over *input* bytes — the reference's convention (result.c:30),
        so decompression speed is on compressed bytes."""
        return self.input_size / max(self.time_taken, 1e-12) / 1e6

    def report(self) -> str:
        saved = (1 - min(self.output_size, self.input_size) / max(self.input_size, 1)) * 100
        lines = [
            f"{self.phase}: {self.input_size} -> {self.output_size} bytes",
            f"  ratio:  {self.comp_ratio:.4f}",
            f"  saved:  {saved:.2f}%" if self.phase == "compress" else "",
            f"  time:   {self.time_taken * 1000:.3f} ms",
            f"  speed:  {self.speed_mbps:.2f} MB/s ({self.backend}, "
            f"{self.n_chips} chip(s), {self.n_hosts} host(s))",
        ]
        return "\n".join(x for x in lines if x)


CSV_FIELDS = [
    "input_size",
    "output_size",
    "comp_ratio",
    "time_taken",
    "speed",
    "n_chips",
    "n_hosts",
    "phase",
    "backend",
]


def write_result_csv(path: str, result: Result) -> None:
    """Append one row (reference write_result_* equivalent, result.c:67-95)."""
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(CSV_FIELDS)
        w.writerow(
            [
                result.input_size,
                result.output_size,
                f"{result.comp_ratio:.6f}",
                f"{result.time_taken:.6f}",
                f"{result.speed_mbps:.3f}",
                result.n_chips,
                result.n_hosts,
                result.phase,
                result.backend,
            ]
        )


def compare_files(path_a: str, path_b: str) -> int:
    """Byte-difference count, the round-trip oracle (result.c:43-65) —
    hardened: a length mismatch counts as a difference (the reference's loop
    stops at the first EOF, so a truncated-but-prefix output passed there)."""
    diff = 0
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        while True:
            a = fa.read(1 << 20)
            b = fb.read(1 << 20)
            if not a and not b:
                return diff
            if len(a) != len(b):
                return diff + abs(len(a) - len(b)) + sum(
                    x != y for x, y in zip(a, b)
                )
            diff += sum(x != y for x, y in zip(a, b))
