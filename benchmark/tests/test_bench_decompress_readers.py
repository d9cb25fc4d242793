"""The decompress cell's per-layer readers on a small synthetic profiler trace
whose expected values are worked out by hand, what they read of other
views, and a CPU dry run of the decompress cell through the harness."""

import dataclasses
import time
from pathlib import Path

import pytest

from benchmark import cells, devtrace, harness, roofline
from snappytpu_torch import profiling

ROOT = Path(__file__).resolve().parents[2]
KIND = "NVIDIA H100 80GB HBM3"
REQS = [(2**19, 2**20), (2**19, 2**20)]  # (stream, output) bytes of each traced request
CELLS = ("parquet-pages-fast.whole-decompress",)
# the sample's configuration under the decompress mix: no cell since its runs spread too widely for a bound, but the
# harness still drives it
SAMPLE = "synth50-fast"
NEW = ("decompress_MBps.window", "device_idle_pct.decompress", "framing_ms_per_MiB.decompress",
       "idle_in_framing_pct.decompress", "copy_ms_per_MiB.decompress", "decode_roofline_pct",
       "blocks_per_call.decompress", "device_parse_pct.decompress")
DEVICE_TRACE = ("device_idle_pct.decompress", "idle_in_framing_pct.decompress", "copy_ms_per_MiB.decompress",
                "decode_roofline_pct")
STEPS = ("scan", "split", "tape", "h2d", "decode", "d2h", "compact", "join")


def ev(cat, name, ts, dur, pid=1, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def readers():
    return {n: cells._reader(ROOT / "benchmark" / "metrics", n) for n in NEW}


def _request(op, edges):
    """The program's request span `snappy.<op>` and its steps between `edges` (9 times)."""
    out = [ev("user_annotation", "snappy." + op, edges[0] - 5, edges[-1] - edges[0] + 10)]
    return out + [ev("user_annotation", "snappy." + s, a, b - a) for s, a, b in zip(STEPS, edges, edges[1:])]


def trace(op="decompress", program=True, device=True):
    """Two requests, 0-1000 and 1200-2000 us (the stretch 2000 us).

    Steps: scan 10-60, split -100, tape -300, h2d -350, decode -400, d2h
    -600, compact -700, join -990; scan 1210-1250, split -1300, tape -1400,
    h2d -1450, decode -1500, d2h -1700, compact -1800, join -1990.  Framing
    (scan, split, tape, compact, join): 290 + 390 + 190 + 290 = 1160 us.

    The card: HtoD 310-340, a kernel 360-390, DtoH 410-590; HtoD
    1460-1480, a kernel 1480-1495, DtoH 1510-1690, a memset 1750-1760 (in
    compact); a kernel 2100-2150 outside the spans.  Busy 465 us of the
    stretch; in framing only the memset, so idle in framing 1150 us."""
    span = devtrace.SPAN_PREFIX + op
    events = [ev("user_annotation", span, 0, 1000), ev("user_annotation", span, 1200, 800)]
    if program:
        events += _request(op, [10, 60, 100, 300, 350, 400, 600, 700, 990])
        events += _request(op, [1210, 1250, 1300, 1400, 1450, 1500, 1700, 1800, 1990])
        events += [ev("user_annotation", "snappy.tape", 2100, 100),  # outside the request spans
                   ev("user_annotation", "snappy.join", 0, 2000, tid=2)]  # another thread
    if device:
        events += [
            ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 310, 30, pid=0, tid=7),
            ev("kernel", "run_tape_kernel", 360, 30, pid=0, tid=7),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 410, 180, pid=0, tid=7),
            ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1460, 20, pid=0, tid=7),
            ev("kernel", "run_tape_kernel", 1480, 15, pid=0, tid=7),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1510, 180, pid=0, tid=7),
            ev("gpu_memset", "Memset (Device)", 1750, 10, pid=0, tid=7),
            ev("kernel", "k_late", 2100, 50, pid=0, tid=7),
        ]
    return events


def view(op="decompress", **kw):
    v = devtrace.view(trace(op, **kw), op, KIND, REQS, 2 * 2**20)
    v.window = harness.Window(op, setup_s=1.0, seconds=2.0, requests=[
        harness.Request(0, 0.0, 0.5, 500_000, 3_000_000, False),
        harness.Request(1, 0.5, 2.0, 500_000, 0, True)])
    return v


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {"decompress.device_calls": 2, "decompress.blocks": 153,
                                                        "decompress.k2_calls": 1, "compress.d2h_bytes": 1000})


def test_the_decompress_readers(counted):
    r, v = readers(), view()
    assert r["decompress_MBps.window"].read(v) == pytest.approx(1.5)  # 3 MB of the completed request over 2 s
    assert r["device_idle_pct.decompress"].read(v) == pytest.approx(100 * (2000 - 465) / 2000)
    assert r["framing_ms_per_MiB.decompress"].read(v) == pytest.approx(1.16 / 2)
    assert r["idle_in_framing_pct.decompress"].read(v) == pytest.approx(100 * 1150 / 2000)
    assert r["copy_ms_per_MiB.decompress"].read(v) == pytest.approx(0.41 / 2)
    least = roofline.least_seconds("decompress", REQS, KIND)
    assert r["decode_roofline_pct"].read(v) == pytest.approx(100 * least / 45e-6)
    assert r["blocks_per_call.decompress"].read(v) == pytest.approx(76.5)
    assert r["device_parse_pct.decompress"].read(v) == pytest.approx(50.0)


def test_idle_gaps_are_named_by_the_decompress_steps():
    gaps = view().idle_gaps()
    assert all(g[0] != devtrace.SPAN_PREFIX + "decompress" for g in gaps)
    assert ["snappy.tape", pytest.approx(310e-6)] in gaps  # 0-310, its middle in the first tape
    assert ["snappy.join", pytest.approx(240e-6)] in gaps  # 1760-2000, its middle in the second join


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["compress", "no program spans", "no window"])
def test_nothing_of_a_compress_view_or_without_the_program(name, case, counted):
    """A compress cell's view (with the program's compress spans and window),
    or a decompress view without the program's spans or window, reads nothing;
    the window reader needs only the window."""
    if case == "compress":
        v = view(op="compress")
    elif case == "no program spans":
        v = view(program=False)
    else:
        v = view()
        v.window = None
    want_number = (case == "no program spans" and name == "decompress_MBps.window"
                   or case == "no window" and name != "decompress_MBps.window")
    assert (readers()[name].read(v) is not None) is want_number


@pytest.mark.parametrize("name", DEVICE_TRACE)
def test_nothing_of_the_card_without_device_activity(name, counted):
    assert readers()[name].read(view(device=False)) is None


def test_the_host_clock_readers_read_a_cpu_trace(counted):
    r, v = readers(), view(device=False)
    assert r["framing_ms_per_MiB.decompress"].read(v) == pytest.approx(0.58)
    assert r["blocks_per_call.decompress"].read(v) == pytest.approx(76.5)
    assert r["decompress_MBps.window"].read(v) == pytest.approx(1.5)


def test_a_program_without_the_route_counters_reads_no_blocks_per_call(monkeypatch):
    """The parent of the counters: `decompress.host_fallbacks` alone."""
    monkeypatch.setattr(profiling, "counters", lambda: {"decompress.host_fallbacks": 0})
    assert readers()["blocks_per_call.decompress"].read(view()) is None


def test_found_by_name_for_the_decompress_cells_only():
    """New files and new entries: the harness needs no other change."""
    for name in CELLS:
        cell = cells.load(ROOT, name)
        assert cell.traffic["op"] == "decompress"
        assert [m.name for m in cell.per_layer] == list(NEW)
        assert [m.name for m in cell.end_to_end] == ["p95_ms", "setup_s"]
    for name in ("synth50-fast.whole-compress", "synth50-dense.whole-compress"):
        assert not {m.name for m in cells.load(ROOT, name).per_layer} & set(NEW)
    with pytest.raises(KeyError):
        cells.load(ROOT, SAMPLE + ".whole-decompress")


def test_the_pages_configuration():
    """64 pages of 1 MiB, the fast profile, the sample's contents."""
    pages = cells.load(ROOT, "parquet-pages-fast.whole-decompress").config
    assert list(pages["objects"]) == [f"page{i:02d}" for i in range(64)] and set(pages["objects"].values()) == {2**20}
    fast = cells.load(ROOT, SAMPLE + ".whole-compress").config
    keys = ("profile", "contents", "match_proba", "lit_proba", "block_bytes", "guarantees")
    assert {k: pages[k] for k in keys} == {k: fast[k] for k in keys}


@pytest.mark.parametrize("config", [None, SAMPLE])
def test_dry_run_of_a_decompress_cell(config):
    """The pages cell through the harness on the CPU, as it is and with the
    sample's configuration in place of its own, each object cut to 1/400 of
    its size: correct, and every reader on the host's clock reads a number;
    at this size each object is one block, so each device call holds one."""
    cell = cells.load(ROOT, CELLS[0])
    if config:
        cell = dataclasses.replace(cell, config=cells.load(ROOT, config + ".whole-compress").config)
    objects = {k: v // 400 for k, v in list(cell.config["objects"].items())[:3]}
    cell = dataclasses.replace(cell, config=cell.config | {"objects": objects})
    profiling.reset_counters()
    result = harness.run_cell(cell, 2**40 + 11, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert list(result["metrics"]) == ["decompress_MBps.window", "framing_ms_per_MiB.decompress",
                                       "blocks_per_call.decompress"]
    assert result["metrics"]["blocks_per_call.decompress"]["value"] == 1.0
    assert profiling.counters().get("decompress.host_fallbacks", 0) == 0
