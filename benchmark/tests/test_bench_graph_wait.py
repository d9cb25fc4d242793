"""The readers of the encoder's graph lock under several clients,
`graph_wait_pct.compress` and `graph_waits_per_call.compress`, on a traced
stretch of two overlapping requests worked out by hand; nothing where the
program has no `snappy.graph_wait` span (a program before it, or a run
without a card) or the view is no compress view; and the
`parquet-write-fast` cells, which a dry run on the CPU serves."""

import json
import time
from pathlib import Path

import pytest

from benchmark import cells, devtrace, harness
from snappytpu_torch import profiling

ROOT = Path(__file__).resolve().parents[2]
KIND = "NVIDIA H100 80GB HBM3"
TASKS5, ONE = "parquet-write-fast.tasks5-compress", "parquet-write-fast.whole-compress"


def ev(cat, name, ts, dur, tid=1, pid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def overlapping(op="compress", program=True, waits=True):
    """Thread 1's request 0-1000 us, thread 2's 200-400 inside it: 1,200 us
    of request time over the threads.  Thread 1 waits 160-200 (40 us),
    thread 2 260-360 (100 us), each inside its `snappy.encode`; a
    `snappy.graph_wait` of thread 2 at 600-650 lies outside its own request
    and belongs to none.  So 140 us of waiting, 11.67 %."""
    events = [ev("user_annotation", devtrace.SPAN_PREFIX + op, 0, 1000, 1),
              ev("user_annotation", devtrace.SPAN_PREFIX + op, 200, 200, 2),
              ev("kernel", "k", 300, 100, 7, 0)]
    if program:
        events += [ev("user_annotation", f"snappy.{op}", 10, 980, 1), ev("user_annotation", "snappy.encode", 150, 300, 1),
                   ev("user_annotation", f"snappy.{op}", 210, 185, 2), ev("user_annotation", "snappy.encode", 250, 120, 2)]
    if program and waits:
        events += [ev("user_annotation", "snappy.graph_wait", 160, 40, 1),
                   ev("user_annotation", "snappy.graph_wait", 260, 100, 2),
                   ev("user_annotation", "snappy.graph_wait", 600, 50, 2)]
    return devtrace.view(events, op, KIND, [(2**20, 2**19)] * 2, 2 * 2**20)


def reader(name):
    return cells._reader(ROOT / "benchmark" / "metrics", name)


def test_the_share_of_request_time_spent_waiting():
    assert reader("graph_wait_pct.compress").read(overlapping()) == pytest.approx(100 * 140 / 1200)


@pytest.mark.parametrize("counts, want", [
    ({"encode.graph_waits": 3, "encode.graph_replays": 10, "encode.graph_captures": 1, "encode.eager_calls": 1}, 25.0),
    ({"encode.graph_replays": 7, "encode.graph_captures": 2, "encode.eager_calls": 1}, 0.0),  # never waited
])
def test_the_share_of_calls_that_waited(counts, want, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: counts)
    assert reader("graph_waits_per_call.compress").read(overlapping()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["graph_wait_pct.compress", "graph_waits_per_call.compress"])
@pytest.mark.parametrize("case", ["no wait spans", "no program spans", "decompress"])
def test_nothing_without_the_span_or_a_compress_view(name, case, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {"encode.graph_waits": 2, "encode.graph_replays": 8})
    v = overlapping(op="decompress" if case == "decompress" else "compress", program=case != "no program spans",
                    waits=case != "no wait spans")
    assert reader(name).read(v) is None


def test_the_cells_and_their_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    tasks5, one = cells.load(ROOT, TASKS5), cells.load(ROOT, ONE)
    assert tasks5.traffic["clients"] == 5 and one.traffic.get("clients", 1) == 1
    assert tasks5.config == one.config and tasks5.config["profile"] == "fast" and tasks5.config["reduced"] == []
    pages = json.loads((ROOT / "benchmark" / "configs" / "parquet-pages-fast.json").read_text())["objects"]
    assert tasks5.config["objects"] == pages
    for cell in (tasks5, one):
        assert {"compress_MBps", "ratio", "setup_s"} <= {m.name for m in cell.end_to_end}
        assert {"device_idle_pct.compress", "framing_ms_per_MiB.compress", "idle_in_framing_pct.compress",
                "encode_graph_replay_pct.compress", "encode_roofline_pct"} <= {m.name for m in cell.per_layer}
    waits = {"graph_wait_pct.compress", "graph_waits_per_call.compress"}
    assert waits <= {m.name for m in tasks5.per_layer} and not waits & {m.name for m in one.per_layer}
    assert {m["name"]: m["source"] for m in spec["per_layer"] if m["name"] in waits} == {
        "graph_wait_pct.compress": "program_span", "graph_waits_per_call.compress": "program_counter"}


@pytest.mark.parametrize("workload", [TASKS5, ONE])
def test_a_dry_run_of_each_cell(workload, tiny):
    """Three pages cut to 2,621 B, 0.3 s, traced: every answer correct, and
    without a card the graph readers read nothing."""
    result = harness.run_cell(tiny(workload), 2**40 + 2700, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert not {"graph_wait_pct.compress", "graph_waits_per_call.compress"} & set(result["metrics"])
