"""The reader of the block route's parse on the card,
`device_parse_pct.decompress`, on the program's counters: what it reads of
a decompress view, and nothing where the program has no K2 counter (the
route that builds every call's tapes on the host), no block-route call, or
the view is no decompress view; and the program's own counters after a
decompress on the CPU device, where the tape route runs, and with the
card's route forced there."""

import json
from pathlib import Path

import pytest

from benchmark import cells, datagen, devtrace
from snappytpu_torch import api, cpu, profiling

ROOT = Path(__file__).resolve().parents[2]
KIND = "NVIDIA H100 80GB HBM3"
REQS = [(2**19, 2**20)]
NAME = "device_parse_pct.decompress"
CELLS = ["parquet-pages-fast.whole-decompress"]


def ev(cat, name, ts, dur, pid=1, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def view(op="decompress", program=True):
    """One request span; with the program, its `snappy.<op>` and a
    `snappy.decode` step inside; a kernel on the card."""
    events = [ev("user_annotation", devtrace.SPAN_PREFIX + op, 0, 1000), ev("kernel", "k", 100, 200, pid=0, tid=7)]
    if program:
        events += [ev("user_annotation", "snappy." + op, 10, 980), ev("user_annotation", "snappy.decode", 50, 300)]
    return devtrace.view(events, op, KIND, REQS, 2**20)


def reader():
    return cells._reader(ROOT / "benchmark" / "metrics", NAME)


@pytest.mark.parametrize("counts, want", [
    ({"decompress.device_calls": 1200, "decompress.blocks": 91800, "decompress.k2_calls": 1200}, 100.0),
    ({"decompress.device_calls": 4, "decompress.blocks": 130, "decompress.k2_calls": 3}, 75.0),
    ({"decompress.device_calls": 5, "decompress.k2_calls": 0, "decompress.reroutes": 1}, 0.0),
])
def test_the_share_of_calls_the_card_parsed(counts, want, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: counts)
    assert reader().read(view()) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no K2 counter", "no block-route call", "no program spans", "compress"])
def test_reads_nothing_without_the_counters_or_a_decompress_view(case, monkeypatch):
    counts = {"no K2 counter": {"decompress.device_calls": 3, "decompress.blocks": 40},
              "no block-route call": {"decompress.windowed_calls": 1, "decompress.k2_calls": 0}}.get(
        case, {"decompress.device_calls": 2, "decompress.k2_calls": 2})
    monkeypatch.setattr(profiling, "counters", lambda: counts)
    v = view(program=case != "no program spans", op="compress" if case == "compress" else "decompress")
    assert reader().read(v) is None


@pytest.mark.parametrize("on_card, want", [(False, None), (True, 100.0)])
def test_the_programs_counters_on_the_cpu_device(on_card, want, monkeypatch):
    """The tape route (a CPU device's) counts no K2 call; the card's route,
    forced on the CPU device, counts one a block-route call."""
    if not cpu.available:
        pytest.skip("the native scan and split need the port's native runtime")
    monkeypatch.setattr(api, "parses_on_card", lambda device: on_card)
    monkeypatch.setattr(api, "DEVICE_BATCH", 2)
    data = datagen.rdg(5 * 2**16 - 100, datagen._generator(3, "cpu"), "cpu").numpy().tobytes()
    stream = api.compress(data, "fast", device="cpu")
    profiling.reset_counters()
    try:
        assert api.decompress(stream, device="cpu") == data
        assert profiling.counters()["decompress.device_calls"] == 3
        assert reader().read(view()) == want
    finally:  # the registry is the process's: later runs in this worker read it
        profiling.reset_counters()


def test_read_from_the_programs_counter_for_the_decompress_cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    [entry] = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert (entry["source"], entry["layer"], entry["moves"], entry["workloads"]) == ("program_counter", "decoders",
                                                                                      "p95_ms", CELLS)
    for name in CELLS:
        assert NAME in [m.name for m in cells.load(ROOT, name).per_layer]
    for name in ("synth50-fast.whole-compress", "synth50-dense.whole-compress"):
        assert NAME not in [m.name for m in cells.load(ROOT, name).per_layer]
