"""Several closed-loop clients at once: the traffic key `clients`, the
harness's threads on the CPU at a tiny size, and the readers on a traced
stretch whose request spans overlap, worked out by hand."""

import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import cells, devtrace, faults, harness, program_spans, traffic

ROOT = Path(__file__).resolve().parents[2]
KIND = "NVIDIA H100 80GB HBM3"
CELLS = {"compress": "synth50-dense.whole-compress", "decompress": "parquet-pages-fast.whole-decompress"}
SECONDS = 0.3


@pytest.mark.parametrize("n", range(1, traffic.MAX_CLIENTS + 1))
def test_clients_from_1_to_16_are_taken(n):
    assert traffic.clients({"op": "compress", "clients": n}) == n


@pytest.mark.parametrize("bad", [0, 17, -1, 2.0, "2", True, None])
def test_other_clients_are_refused(bad):
    with pytest.raises(ValueError):
        traffic.check({"op": "decompress", "clients": bad})


def test_one_client_where_the_key_is_absent():
    assert traffic.clients({"op": "compress", "why": "test"}) == 1


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 9])
def test_client_0_sends_the_one_clients_order(seed):
    """Client 0 draws what the harness drew before it had clients; client 1
    draws another order of the same units."""
    rng = np.random.default_rng([seed, 1])
    want = [rng.permutation(64) for _ in range(5)]
    for got in (traffic.passes(64, seed), traffic.passes(64, seed, 0)):
        assert all(np.array_equal(next(got), w) for w in want)
    other = [next(traffic.passes(64, seed, k)) for k in (1, 2)]
    assert all(sorted(o) == list(range(64)) for o in other)
    assert not np.array_equal(other[0], want[0]) and not np.array_equal(other[0], other[1])


def _cell(tiny, op, n):
    cell = tiny(CELLS[op])
    return dataclasses.replace(cell, traffic=cell.traffic | {"clients": n})


@pytest.fixture
def records(monkeypatch):
    """What the harness hands its readers: the window (`--trace 0`) or the
    traced view with the window in it (`--trace 1`)."""
    seen = []
    read = harness._read

    def keep(metrics, record):
        seen.append(record)
        return read(metrics, record)

    monkeypatch.setattr(harness, "_read", keep)
    return seen


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_dry_run_with_several_clients(op, n, trace, tiny, records):
    result = harness.run_cell(_cell(tiny, op, n), 2**40 + 26, SECONDS, bool(trace), "cpu", time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    window = records[-1].window if trace else records[-1]
    assert {r.client for r in window.requests} == set(range(n))
    assert window.seconds >= SECONDS
    assert result["attempted"] >= len(window.requests) > 0
    if trace:  # the traced passes ran on every client's thread, at least TRACED_REQUESTS of them
        view = records[-1]
        assert len({s.thread for s in view.spans}) == n
        assert len(view.spans) == len(view.requests) >= harness.TRACED_REQUESTS
    else:
        assert {"p95_ms", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_the_control_is_caught_with_two_clients(op, tiny):
    with faults.planted("control", op):
        result = harness.run_cell(_cell(tiny, op, 2), 2**40 + 27, SECONDS, False, "cpu", time.perf_counter())
    assert result["checks"]["wrong_bytes"]["value"] > 0 and result["correct"] is False


@pytest.mark.parametrize("trace", [False, True])
def test_a_client_that_dies_fails_the_run(trace, tiny, monkeypatch):
    """No result with fewer clients: the run raises, and no thread is left
    waiting for the one that died."""
    passes = traffic.passes

    def dying(n_units, seed, client=0):
        if client == 1:
            raise OSError("client 1 dies")
        return passes(n_units, seed, client)

    monkeypatch.setattr(traffic, "passes", dying)
    cell, outcome = _cell(tiny, "decompress", 3), []

    def run():
        try:
            outcome.append(harness.run_cell(cell, 2**40 + 28, SECONDS, trace, "cpu", time.perf_counter()))
        except RuntimeError as e:
            outcome.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    assert isinstance(outcome[0], RuntimeError) and isinstance(outcome[0].__cause__, OSError)
    assert not [th for th in threading.enumerate() if th.name.startswith("client")]


def ev(cat, name, ts, dur, tid=1, pid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


STEPS = ("pack", "h2d", "encode", "d2h", "rows", "compact", "join")


def _request(tid, edges):
    out = [ev("user_annotation", "snappy.compress", edges[0], edges[-1] - edges[0], tid)]
    return out + [ev("user_annotation", "snappy." + s, a, b - a, tid) for s, a, b in zip(STEPS, edges, edges[1:])]


def overlapping():
    """Two clients' requests: thread 1's 0-1000 us, thread 2's 200-400 us
    inside it (the stretch 0-1000).

    Thread 1's steps: pack 10-100, h2d -150, encode -450, d2h -700, rows
    -800, compact -900, join -990.  Thread 2's: pack 210-260, h2d -260
    (none), encode -300, d2h -340, rows -360, compact -380, join -395; and a
    `snappy.pack` of thread 2 at 600-700, outside its own request though
    inside thread 1's, which belongs to no request.  Framing (pack, rows,
    compact, join): 90 + 100 + 100 + 90 on thread 1, 50 + 20 + 20 + 15 on
    thread 2, 485 us; its union 10-100, 210-260, 340-395, 700-990, 485 us.

    The card: HtoD 110-140, a kernel 160-300, a kernel 500-600 (after
    thread 2's request has ended, inside thread 1's), DtoH 650-700, a kernel
    1100-1150 outside every request.  Kernels in the requests 140 + 100 =
    240 us, copies 30 + 50 = 80 us.  The card runs 50 us of framing's union
    (210-260), so idle in framing 435 us; encode's union 150-450 holds 140
    us of kernel, so idle in encode 160 us."""
    events = [ev("user_annotation", "bench.compress", 0, 1000, 1), ev("user_annotation", "bench.compress", 200, 200, 2)]
    events += _request(1, [10, 100, 150, 450, 700, 800, 900, 990])
    events += _request(2, [210, 260, 260, 300, 340, 360, 380, 395])
    events += [ev("user_annotation", "snappy.pack", 600, 100, 2), ev("user_annotation", "snappy.join", 1100, 50, 1)]
    events += [ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 110, 30, 7, 0),
               ev("kernel", "k_a", 160, 140, 7, 0), ev("kernel", "k_b", 500, 100, 7, 0),
               ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 650, 50, 7, 0),
               ev("kernel", "k_late", 1100, 50, 7, 0)]
    return devtrace.view(events, "compress", KIND, [(2**20, 2**19), (2**20, 2**19)], 2 * 2**20)


def test_in_spans_takes_the_union_of_overlapping_requests():
    v = overlapping()
    by_name = {d.name: d for d in v.device}
    assert v.in_spans(by_name["k_b"])  # inside thread 1's request, though after thread 2's, which started later
    assert not v.in_spans(by_name["k_late"])
    assert v.device_s_in_spans("kernel") == pytest.approx(240e-6)
    assert v.device_s_in_spans("gpu_memcpy", ("HtoD", "DtoH")) == pytest.approx(80e-6)
    assert v.window_s() == pytest.approx(1000e-6)


def test_each_step_belongs_to_its_own_threads_request():
    v = overlapping()
    framing = program_spans.steps(v, *program_spans.FRAMING)
    assert len(framing) == 8 and {s.thread for s in framing} == {(1, 1), (1, 2)}
    assert (600, 700) not in [(s.start, s.end) for s in framing]
    assert program_spans.idle_s(v, framing) == pytest.approx(435e-6)
    assert program_spans.idle_s(v, program_spans.steps(v, "encode")) == pytest.approx(160e-6)


def test_the_compress_readers_on_overlapping_requests(monkeypatch):
    from snappytpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"compress.d2h_bytes": 1000, "compress.stream_bytes": 540})
    v = overlapping()

    def read(name):
        return cells._reader(ROOT / "benchmark" / "metrics", name).read(v)

    assert read("framing_ms_per_MiB.compress") == pytest.approx(0.485 / 2)
    assert read("idle_in_framing_pct.compress") == pytest.approx(43.5)
    assert read("idle_in_encode_pct.compress") == pytest.approx(16.0)
    assert read("copy_ms_per_MiB.compress") == pytest.approx(0.08 / 2)
    assert read("device_idle_pct.compress") == pytest.approx(100 * (1000 - 320) / 1000)
