"""The reader of the encoder's graph engagement,
`encode_graph_replay_pct.compress`, on the program's counters: what it
reads of a compress view, and nothing where the program has no such
counters (the parent of the graph path) or the view is no compress view;
a run without a card reads its eager calls, 0 %."""

import json
from pathlib import Path

import pytest

from benchmark import cells, devtrace
from snappytpu_torch import profiling

ROOT = Path(__file__).resolve().parents[2]
KIND = "NVIDIA H100 80GB HBM3"
REQS = [(2**20, 2**19)]
NAME = "encode_graph_replay_pct.compress"


def ev(cat, name, ts, dur, pid=1, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def view(op="compress", program=True, device=True):
    """One request span; with the program, its `snappy.compress` and
    `snappy.encode`; with the card, a kernel."""
    events = [ev("user_annotation", devtrace.SPAN_PREFIX + op, 0, 1000)]
    if device:
        events.append(ev("kernel", "k", 100, 200, pid=0, tid=7))
    if program:
        events += [ev("user_annotation", "snappy." + op, 10, 980), ev("user_annotation", "snappy.encode", 50, 300)]
    return devtrace.view(events, op, KIND, REQS, 2**20)


def reader():
    return cells._reader(ROOT / "benchmark" / "metrics", NAME)


@pytest.mark.parametrize("counts, want", [
    ({"encode.graph_replays": 796, "encode.graph_captures": 2, "encode.eager_calls": 2}, 99.5),
    ({"encode.graph_replays": 0, "encode.eager_calls": 10}, 0.0),
    ({"encode.graph_replays": 3, "encode.graph_captures": 1, "encode.eager_calls": 0,
      "encode.graph_fallbacks": 0}, 75.0),
])
def test_the_share_of_calls_replayed(counts, want, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: counts)
    assert reader().read(view()) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no encoder counters", "no program spans", "decompress"])
def test_reads_nothing_without_the_counters_or_a_compress_view(case, monkeypatch):
    counts = {"compress.d2h_bytes": 1000} if case == "no encoder counters" else {"encode.graph_replays": 5}
    monkeypatch.setattr(profiling, "counters", lambda: counts)
    v = view(program=case != "no program spans", op="decompress" if case == "decompress" else "compress")
    assert reader().read(v) is None


def test_a_run_without_a_card_reads_its_eager_calls(monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {"encode.eager_calls": 12, "compress.d2h_bytes": 9})
    assert reader().read(view(device=False)) == 0.0


def test_read_on_the_host_clock():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [m["source"] for m in spec["per_layer"] if m["name"] == NAME] == ["host_clock"]


def test_registered_for_the_dense_cell_only():
    cell = cells.load(ROOT, "synth50-dense.whole-compress")
    assert NAME in [m.name for m in cell.per_layer]
    assert NAME not in [m.name for m in cells.load(ROOT, "synth50-fast.whole-compress").per_layer]
