"""The readers of the program's own spans (`benchmark/program_spans.py`) on a
small synthetic profiler trace whose expected values are worked out by hand."""

from pathlib import Path

import pytest

from benchmark import cells, devtrace
from snappytpu_torch import profiling

ROOT = Path(__file__).resolve().parents[2]
KIND = "NVIDIA H100 80GB HBM3"
REQS = [(2**20, 2**19), (2**20, 2**19)]

NEW = ("framing_ms_per_MiB.compress", "d2h_useful_pct.compress", "idle_in_framing_pct.compress",
       "idle_in_encode_pct.compress")
DEVICE_TRACE = ("idle_in_framing_pct.compress", "idle_in_encode_pct.compress")
STEPS = ("pack", "h2d", "encode", "d2h", "rows", "compact", "join")


def ev(cat, name, ts, dur, pid=1, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def readers():
    return {n: cells._reader(ROOT / "benchmark" / "metrics", n) for n in NEW}


def _request(t0, edges):
    """A request span at t0 and the program's steps between `edges` (8 times:
    snappy.compress runs from the first to the last)."""
    out = [ev("user_annotation", "snappy.compress", edges[0], edges[-1] - edges[0])]
    out += [ev("user_annotation", "snappy." + s, a, b - a) for s, a, b in zip(STEPS, edges, edges[1:])]
    return out


def trace(op="compress", program=True, device=True):
    """Two requests, 0-1000 and 1200-2000 us (the stretch 2000 us).

    Steps: pack 10-100, h2d -150, encode -400, d2h -600, rows -700, compact
    -800, join -990; pack 1210-1300, h2d -1350, encode -1500, d2h -1700,
    rows -1750, compact -1800, join -1990.  Framing (pack, rows, compact,
    join): 90 + 100 + 100 + 190 + 90 + 50 + 50 + 190 = 860 us.

    The card: a kernel 50-70 (in pack), HtoD 110-140, kernels 160-300 and
    350-380 (encode), DtoH 410-620 (20 us into rows), a kernel 1360-1500
    (encode), DtoH 1510-1690, a memset 1760-1770 (compact).  Busy in
    framing 20 + 20 + 10 = 50, so idle in framing 810 us; encode 250 + 150
    us with 140 + 30 + 140 busy, so idle in encode 90 us."""
    span = devtrace.SPAN_PREFIX + op
    events = [ev("user_annotation", span, 0, 1000), ev("user_annotation", span, 1200, 800)]
    if program:
        events += _request(0, [10, 100, 150, 400, 600, 700, 800, 990])
        events += _request(1200, [1210, 1300, 1350, 1500, 1700, 1750, 1800, 1990])
        events += [ev("user_annotation", "snappy.pack", 2100, 100),  # outside the request spans
                   ev("user_annotation", "snappy.join", 0, 2000, tid=2)]  # another thread
    if device:
        events += [
            ev("kernel", "k_prev", 50, 20, pid=0, tid=7),
            ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 110, 30, pid=0, tid=7),
            ev("kernel", "k_a", 160, 140, pid=0, tid=7), ev("kernel", "k_b", 350, 30, pid=0, tid=7),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 410, 210, pid=0, tid=7),
            ev("kernel", "k_a", 1360, 140, pid=0, tid=7),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1510, 180, pid=0, tid=7),
            ev("gpu_memset", "Memset (Device)", 1760, 10, pid=0, tid=7),
        ]
    return events


def view(**kw):
    op = kw.get("op", "compress")
    return devtrace.view(trace(**kw), op, KIND, REQS, 2 * 2**20)


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {"compress.d2h_bytes": 1000, "compress.stream_bytes": 540})


def test_the_program_span_readers(counted):
    r, v = readers(), view()
    assert r["framing_ms_per_MiB.compress"].read(v) == pytest.approx(0.86 / 2)
    assert r["d2h_useful_pct.compress"].read(v) == pytest.approx(54.0)
    assert r["idle_in_framing_pct.compress"].read(v) == pytest.approx(100 * 810 / 2000)
    assert r["idle_in_encode_pct.compress"].read(v) == pytest.approx(100 * 90 / 2000)


def test_idle_gaps_are_named_by_the_program_steps():
    """With the program's spans, no gap inside a request is named by the request span."""
    gaps = view().idle_gaps()
    assert all(g[0] != devtrace.SPAN_PREFIX + "compress" for g in gaps)
    assert ["snappy.join", pytest.approx(230e-6)] in gaps  # 1770-2000, its middle in the second join
    assert ["snappy.encode", pytest.approx(50e-6)] in gaps  # 300-350


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["no program spans", "decompress"])
def test_nothing_without_the_program_or_on_a_decompress_view(name, case, counted):
    v = view(program=False) if case == "no program spans" else view(op="decompress")
    assert readers()[name].read(v) is None


@pytest.mark.parametrize("name", DEVICE_TRACE)
def test_nothing_of_the_card_without_device_activity(name):
    assert readers()[name].read(view(device=False)) is None


def test_the_host_clock_readers_read_a_cpu_trace(counted):
    """A CPU trace has the program's spans and counters but no card."""
    r, v = readers(), view(device=False)
    assert r["framing_ms_per_MiB.compress"].read(v) == pytest.approx(0.43)
    assert r["d2h_useful_pct.compress"].read(v) == pytest.approx(54.0)


def test_no_copies_counted_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert readers()["d2h_useful_pct.compress"].read(view()) is None
