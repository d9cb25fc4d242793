"""Each per-layer reader on a small synthetic profiler trace."""

import json
from pathlib import Path

import pytest

from benchmark import cells, devtrace, harness, roofline

ROOT = Path(__file__).resolve().parents[2]
KIND = "NVIDIA H100 80GB HBM3"


def ev(cat, name, ts, dur, pid=1, tid=1, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def trace(op):
    """Two requests, 0-1000 us and 1200-2000 us (the stretch 2000 us): kernels
    of 100 + 300 + 200 us, copies of 50 (HtoD) + 50 (DtoH) + 25 (DtoD) us,
    a memset of 25 us, one kernel outside the spans, a device-side annotation
    that is not device work, and a host op on another thread."""
    span = devtrace.SPAN_PREFIX + op
    return [
        ev("user_annotation", span, 0, 1000), ev("user_annotation", span, 1200, 800),
        ev("cpu_op", "aten::sort", 100, 300), ev("cpu_op", "aten::to", 1250, 100),
        ev("cpu_op", "other_thread_op", 0, 2000, tid=2),
        ev("kernel", "k_sort", 150, 100, pid=0, tid=7), ev("kernel", "k_sort", 400, 300, pid=0, tid=7),
        ev("kernel", "k_move", 1500, 200, pid=0, tid=7), ev("kernel", "k_late", 2100, 50, pid=0, tid=7),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 50, pid=0, tid=7),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1800, 50, pid=0, tid=7),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1850, 25, pid=0, tid=7),
        ev("gpu_memset", "Memset (Device)", 1875, 25, pid=0, tid=7),
        ev("gpu_user_annotation", span, 0, 1000, pid=0, tid=7),
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1, "pid": 0, "tid": 7},
    ]


REQS = [(2**20, 2**19), (2**20, 2**19)]


def view(op, tmp_path=None):
    if tmp_path is None:
        return devtrace.view(trace(op), op, KIND, REQS, 2 * 2**20)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": trace(op)}))
    return devtrace.load(path, op, KIND, REQS, 2 * 2**20)


def readers():
    """Every reader under benchmark/metrics/."""
    folder = ROOT / "benchmark" / "metrics"
    return {p.stem: cells._reader(folder, p.stem) for p in sorted(folder.glob("*.py"))}


def test_the_view(tmp_path):
    v = view("compress", tmp_path)
    assert v.stretch == (0.0, 2000.0)
    assert v.window_s() == pytest.approx(2e-3)
    # busy: 10-60, 150-250, 400-700, 1500-1700, 1800-1900 = 50+100+300+200+100
    assert v.busy_s() == pytest.approx(750e-6)
    assert v.idle_pct() == pytest.approx(62.5)
    assert v.device_s_in_spans("kernel") == pytest.approx(600e-6)
    assert v.device_s_in_spans("gpu_memcpy", ("HtoD", "DtoH")) == pytest.approx(100e-6)
    assert v.device_ops()[0] == ["k_sort", pytest.approx(400e-6)]
    gaps = v.idle_gaps()
    assert gaps[0] == ["(no host event)", pytest.approx(800e-6)]  # 700-1500: between the requests
    assert ["aten::sort", pytest.approx(150e-6)] in gaps  # 250-400: inside aten::sort, inside the span
    assert ["bench.compress", pytest.approx(100e-6)] in gaps  # 1700-1800: in the span, no op inside
    assert all(g[0] != "other_thread_op" for g in gaps)


def test_compress_readers():
    r, v = readers(), view("compress")
    assert r["device_idle_pct.compress"].read(v) == pytest.approx(62.5)
    least = roofline.least_seconds("compress", REQS, KIND)
    assert r["encode_roofline_pct"].read(v) == pytest.approx(100 * least / 600e-6)
    assert r["copy_ms_per_MiB.compress"].read(v) == pytest.approx(0.1 / 2)


def test_the_window_readers():
    """The per-layer readers on the host's clock read the measured window,
    not the traced passes: 3 MB of the completed request over 2 s."""
    r, v = readers(), view("compress")
    v.window = harness.Window("compress", setup_s=1.0, seconds=2.0, requests=[
        harness.Request(0, 0.0, 0.5, 3_000_000, 1_000_000, False),
        harness.Request(0, 0.5, 2.0, 1_000_000, 0, True)])
    assert r["compress_MBps.fast"].read(v) == pytest.approx(1.5)
    assert r["p95_ms.fast"].read(v) == pytest.approx(500 + 0.95 * 1000)
    v.window.op = "decompress"
    assert r["compress_MBps.fast"].read(v) is None


def test_compress_readers_read_nothing_of_a_decompress_trace():
    r, v = readers(), view("decompress")
    assert {n: rd.read(v) for n, rd in r.items()} == dict.fromkeys(r)


def test_a_trace_without_device_activity_reads_nothing():
    """A CPU trace has no card: no share of the card is written for it."""
    events = [e for e in trace("compress") if e.get("cat") in ("user_annotation", "cpu_op")]
    v = devtrace.view(events, "compress", KIND, REQS, 2 * 2**20)
    assert {n: rd.read(v) for n, rd in readers().items()} == dict.fromkeys(readers())


def test_no_spans_is_an_error():
    with pytest.raises(ValueError):
        devtrace.view([ev("kernel", "k", 0, 1, pid=0)], "compress", KIND, REQS, 1)
