"""Several callers of the port at once, as the task threads of one process
are: `api.compress` and `api.decompress` from five threads give each caller
the answer one caller alone gets, and every stream decodes through the
benchmark's plain-torch decoder (`benchmark/reference.py`) to its input;
the spans of every caller's thread are recorded under a profiler of every
thread, and none is entered without a profiler; the counters stay exact;
`GraphCache` (with a capture faked on the CPU) runs one capture or replay
at a time and counts the calls that waited; and each thread keeps its own
compress buffers; the CUDA kernels' first use from several threads builds
them once.  On a card (marked `cuda`, skipped without one): five
writers over the benchmark's 64 pages of 1 MiB give every page the stream
one writer gives.  Run that there with
`python -m pytest --noconftest -m cuda tests/test_torch_clients.py -q -s`
(this file imports neither JAX nor the JAX package)."""

import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from benchmark import datagen, reference
from snappytpu_torch import _build, api, hostbuf, profiling
from snappytpu_torch.kernels import encode_v2 as E

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

ROOT = Path(__file__).resolve().parents[1]
CLIENTS = 5
SIZES = (70_000, 20_000, 2 * 65_536 + 5)  # two blocks, one short block, three blocks


def _page(n: int, seed: int) -> bytes:
    return datagen.rdg(n, datagen._generator(seed, "cpu"), "cpu").numpy().tobytes()


PAGES = [_page(n, 2700 + i) for i, n in enumerate(SIZES)]


def at_once(n: int, call, inputs: list, timeout: float = 300) -> list[dict[int, object]]:
    """`n` threads, released together, each calling `call` on every input in
    its own order (thread k starts at input k) with a short switch
    interval: each thread's answers by input index."""
    answers: list[dict] = [{} for _ in range(n)]
    errors: list[BaseException] = []
    start = threading.Barrier(n)

    def client(k):
        try:
            start.wait()
            for j in range(len(inputs)):
                i = (k + j) % len(inputs)
                answers[k][i] = call(inputs[i])
        except BaseException as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and errors == []
    return answers


@pytest.mark.parametrize("op", ["fast", "dense", "decompress"])
def test_five_callers_at_once_answer_as_one(op):
    """Each caller's answer equals the same call's serial answer byte for
    byte, and each stream decodes through the plain reference to its page."""
    if op == "decompress":
        streams = [api.compress(p, "fast", device="cpu") for p in PAGES]
        inputs, want = streams, PAGES

        def call(x):
            return api.decompress(x, device="cpu")
    else:
        inputs = PAGES
        want = [api.compress(p, op, device="cpu") for p in PAGES]
        streams = want

        def call(x):
            return api.compress(x, op, device="cpu")
    for answers in at_once(CLIENTS, call, inputs):
        assert [answers[i] for i in range(len(inputs))] == want
    for stream, page in zip(streams, PAGES):
        assert reference.decode(stream, "cpu").numpy().tobytes() == page


# ---- spans and counters ----


def test_spans_on_every_client_thread_under_a_profiler_of_every_thread():
    """`snappy.compress` and its steps are recorded on each client's thread,
    whose own profiler flag stays off; each thread's steps lie inside its
    own request span."""
    flags = []

    def call(x):
        flags.append(torch._C._autograd._profiler_enabled())
        return api.compress(x, "fast", device="cpu")

    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], experimental_config=config) as prof:
        at_once(3, call, PAGES[1:2])
    assert flags == [False] * 3
    by_thread: dict[int, list] = {}
    for e in prof.events():
        if e.name.startswith("snappy."):
            by_thread.setdefault(e.thread, []).append(e)
    assert len(by_thread) == 3
    for events in by_thread.values():
        tops = [e for e in events if e.name == "snappy.compress"]
        assert len(tops) == 1
        top = tops[0].time_range
        steps = {e.name for e in events if e.name != "snappy.compress"}
        assert {"snappy.pack", "snappy.h2d", "snappy.encode", "snappy.d2h", "snappy.rows", "snappy.compact",
                "snappy.join"} <= steps
        assert all(top.start <= e.time_range.start <= e.time_range.end <= top.end for e in events)


def test_no_profiler_no_span():
    assert profiling.span("snappy.x") is profiling._OFF


def test_counts_from_eight_threads_are_exact():
    profiling.reset_counters()
    per, n = 10_000, 8
    go = threading.Barrier(n)

    def work():
        go.wait()
        for _ in range(per):
            profiling.count("test.threads")
            profiling.count("test.bytes", 3)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters() == {"test.threads": n * per, "test.bytes": 3 * n * per}
    profiling.reset_counters()
    assert profiling.counters() == {}


# ---- the encoder's graph lock ----


class Serial:
    """A capture for GraphCache whose captures and replays note how many run
    at once, and take a little while so that other threads find the lock
    held."""

    def __init__(self):
        self.inside = self.most = 0
        self.keys = []

    def _enter(self):
        self.inside += 1
        self.most = max(self.most, self.inside)

    def __call__(self, key, x):
        self._enter()
        try:
            time.sleep(1e-3)
            self.keys.append(key)
        finally:
            self.inside -= 1

        def replay(x):
            self._enter()
            try:
                time.sleep(2e-4)
                return ("replay", key, x)
            finally:
                self.inside -= 1
        return replay


def _graph_counts():
    c = profiling.counters()
    return {k: c.get(k, 0) for k in ("encode.graph_replays", "encode.graph_captures", "encode.eager_calls",
                                     "encode.graph_waits")}


def test_graph_cache_runs_one_capture_or_replay_at_a_time():
    """Eight threads over two keys: never two captures or replays at once,
    each thread its own answers, and some calls counted as waits, at most
    one a call."""
    cap = Serial()
    cache = E.GraphCache(cap)
    keys, calls = [(0, 16, False), (0, 128, False)], 40
    before = _graph_counts()

    def call(i):
        return cache.run(keys[i % 2], lambda y: ("eager", y), i)

    for a in at_once(8, call, list(range(calls))):
        assert all(a[i][-1] == i for i in range(calls))
    after = _graph_counts()
    delta = {k: after[k] - before[k] for k in after}
    assert cap.most == 1 and sorted(cap.keys) == sorted(keys)
    assert delta["encode.graph_replays"] + delta["encode.graph_captures"] + delta["encode.eager_calls"] == 8 * calls
    assert 0 < delta["encode.graph_waits"] <= 8 * calls


def test_a_call_that_finds_the_lock_held_counts_one_wait():
    cache = E.GraphCache(Serial())
    key = (0, 16, False)
    cache.run(key, lambda x: x, 0)  # seen: the next call captures
    before = _graph_counts()
    got = []
    with cache._lock:
        t = threading.Thread(target=lambda: got.append(cache.run(key, lambda x: x, 1)))
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and not got  # waiting for the lock
    t.join(timeout=30)
    assert not t.is_alive() and got == [("replay", key, 1)]
    assert cache.run(key, lambda x: x, 2) == ("replay", key, 2)  # alone: no wait
    after = _graph_counts()
    assert after["encode.graph_waits"] - before["encode.graph_waits"] == 1


def test_a_graph_wait_span_inside_a_profiled_keyed_call():
    cache = E.GraphCache(Serial())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cache.run((0, 1, True), lambda x: x, 0)
        cache.run(None, lambda x: x, 0)  # no key: no lock, no span
    assert [e.name for e in prof.events() if e.name.startswith("snappy.")] == ["snappy.graph_wait"]


# ---- each thread's compress buffers ----


def test_compress_buffers_are_kept_a_thread_and_not_shared(monkeypatch):
    """A thread's compressed rows and totals land in the same memory call
    after call (pages of one size, so no buffer grows), and another
    thread's in memory of its own."""
    seen: dict[tuple, set] = {}
    take = hostbuf.take

    def noted(name, shape, dtype, **kw):
        t = take(name, shape, dtype, **kw)
        seen.setdefault((threading.get_ident(), name), set()).add(t.data_ptr())
        return t

    monkeypatch.setattr(hostbuf, "take", noted)
    pages = [PAGES[0]] * 3
    want = [api.compress(p, "fast", device="cpu") for p in pages]
    at_once(2, lambda x: api.compress(x, "fast", device="cpu"), pages)
    assert [api.compress(p, "fast", device="cpu") for p in pages] == want
    by_name: dict[str, list] = {}
    for (_, name), ptrs in seen.items():
        assert len(ptrs) == 1, name
        by_name.setdefault(name, []).append(ptrs.pop())
    assert {"api.comp", "api.totals"} <= set(by_name)
    for name in ("api.comp", "api.totals"):
        assert len(by_name[name]) == 3 == len(set(by_name[name]))  # the main thread and two clients


# ---- the first use of the CUDA kernels ----


def test_threads_that_first_use_the_kernels_together_build_once(tmp_path, monkeypatch):
    """Five threads asking for the library at once: one compiles, the others
    wait and take its file (a build's objects are named by the process, so
    two at once would overwrite each other's)."""
    so = tmp_path / "libsnappytpu_torch-test.so"
    built = []

    def compile_once(path):
        built.append(threading.get_ident())
        time.sleep(0.05)
        path.write_bytes(b"")
        return path

    monkeypatch.setattr(_build, "library_path", lambda: so)
    monkeypatch.setattr(_build, "_compile", compile_once)
    got = at_once(CLIENTS, lambda _: _build.build(), [None])
    assert len(built) == 1 and [a[0] for a in got] == [so] * CLIENTS


# ---- on a card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_five_writers_on_the_card_equal_one_writer(card):
    """The benchmark's `parquet-write-fast` pages (64 of 1 MiB, seed
    2700000001): five threads compress every page, fast, each in its own
    order, and every stream equals a lone caller's byte for byte and decodes
    through the reference to its page; the calls replay graphs."""
    config = json.loads((ROOT / "benchmark" / "configs" / "parquet-write-fast.json").read_text())
    pages = list(datagen.make_objects(config, 2_700_000_001, card).values())
    lone = [api.compress(p, "fast", device=card) for p in pages]  # the key's eager call and capture among them
    before = profiling.counters()
    answers = at_once(CLIENTS, lambda x: api.compress(x, "fast", device=card), pages)
    after = profiling.counters()
    for a in answers:
        assert [a[i] for i in range(len(pages))] == lone
    for stream, page in zip(lone, pages):
        assert torch.equal(reference.decode(stream, card).cpu(), torch.from_numpy(page))
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    print("five writers on", torch.cuda.get_device_name(card), {k: v for k, v in delta.items() if v})
    assert delta["encode.graph_replays"] == CLIENTS * len(pages)
    assert delta.get("encode.eager_calls", 0) == delta.get("encode.graph_captures", 0) == 0
