"""The port's spans and counters on the CPU: `profiling.span` inside
`api.compress`/`api.decompress` under `torch.profiler` (one request span,
its steps in order, each inside it), nothing entered without a profiler,
and the counter registry with the compress boundary's byte counts."""

import numpy as np
import pytest
import torch

from snappytpu_torch import api, cpu, profiling
from snappytpu_torch.bench import corpus
from snappytpu_torch.format import constants as C
from snappytpu_torch.format.varint import encode_varint
from snappytpu_torch.stream import framing

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

DATA = corpus.mixed(2 * C.MAX_BLOCK_SIZE + 5_000, seed=7)  # three blocks
CALL = ["h2d", "encode", "d2h", "rows", "compact"]  # one device call of compress


def _profiled(fn):
    """fn() under torch.profiler -> (its result, the snappy.* events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("snappy.")]


def _children(parent) -> list[str]:
    """The steps directly under `parent`, in order, each checked to lie inside it."""
    kids = sorted((c for c in parent.cpu_children if c.name.startswith("snappy.")), key=lambda c: c.time_range.start)
    for c in kids:
        assert parent.time_range.start <= c.time_range.start <= c.time_range.end <= parent.time_range.end, c.name
    return [c.name.removeprefix("snappy.") for c in kids]


def _one(events, name):
    found = [e for e in events if e.name == name]
    assert len(found) == 1, [e.name for e in events]
    return found[0]


def _giant_literal() -> tuple[bytes, bytes]:
    payload = corpus.random_bytes(70_000, seed=2)
    return encode_varint(len(payload)) + bytes([62 << 2]) + (len(payload) - 1).to_bytes(3, "little") + payload, payload


@pytest.mark.parametrize("profile", ["fast", "dense"])
def test_compress_steps_tile_one_request_span(profile, monkeypatch):
    """Two device calls (DEVICE_BATCH 2, three blocks): pack, each call's
    steps, join, in that order inside the one request span."""
    monkeypatch.setattr(api, "DEVICE_BATCH", 2)
    stream, events = _profiled(lambda: api.compress(DATA, profile, device="cpu"))
    assert stream == api.compress(DATA, profile, device="cpu")  # the spans change nothing
    top = _one(events, "snappy.compress")
    assert _children(top) == ["pack", *CALL, *CALL, "join"]
    assert all(e is top or e.cpu_parent is not None for e in events)


def test_decompress_steps_on_the_tape_route(monkeypatch):
    if not cpu.available:
        pytest.skip("the tape route needs the port's native runtime")
    monkeypatch.setattr(api, "DEVICE_BATCH", 2)
    stream = api.compress(DATA, "fast", device="cpu")
    out, events = _profiled(lambda: api.decompress(stream, device="cpu"))
    assert out == DATA
    call = ["tape", "h2d", "decode", "d2h", "compact"]
    assert _children(_one(events, "snappy.decompress")) == ["scan", "split", *call, *call, "join"]


def test_decompress_steps_on_the_block_route(monkeypatch):
    """Without the native runtime: the split in Python, K2's copies and launch."""
    monkeypatch.setattr(cpu, "available", False)
    stream = api.compress(DATA, "fast", device="cpu")
    out, events = _profiled(lambda: api.decompress(stream, device="cpu"))
    assert out == DATA
    call = ["h2d", "decode", "d2h", "compact"]
    assert _children(_one(events, "snappy.decompress")) == ["split", "split", *call, "join"]


def test_decompress_steps_on_the_card_route(monkeypatch):
    """The native scan and split, then K2 (a CUDA device's route, forced on
    the CPU device): no `tape` step."""
    if not cpu.available:
        pytest.skip("the native scan and split need the port's native runtime")
    monkeypatch.setattr(api, "DEVICE_BATCH", 2)
    monkeypatch.setattr(api, "parses_on_card", lambda device: True)
    stream = api.compress(DATA, "fast", device="cpu")
    out, events = _profiled(lambda: api.decompress(stream, device="cpu"))
    assert out == DATA
    call = ["h2d", "decode", "d2h", "compact"]
    assert _children(_one(events, "snappy.decompress")) == ["scan", "split", *call, *call, "join"]


def test_windowed_and_host_decode_spans():
    """An unaligned stream goes through `windowed` with its own steps; a
    giant literal through `windowed`, refused, then `host_decode`."""
    data = corpus.mixed(100_000, seed=4)
    tail = np.frombuffer(api.compress(data[3:], "fast", device="cpu"), np.uint8)
    _, start = framing.read_preamble(tail)
    unaligned = encode_varint(len(data)) + bytes([2 << 2]) + data[:3] + tail[start:].tobytes()
    out, events = _profiled(lambda: api.decompress(unaligned, device="cpu"))
    assert out == data
    windowed = _one(events, "snappy.windowed")
    assert "windowed" in _children(_one(events, "snappy.decompress"))
    assert _children(windowed) == ["split", "split", "h2d", "decode", "d2h", "compact", "join"]

    giant, payload = _giant_literal()
    profiling.reset_counters()
    out, events = _profiled(lambda: api.decompress(giant, device="cpu"))
    assert out == payload
    assert _children(_one(events, "snappy.decompress"))[-2:] == ["windowed", "host_decode"]
    assert profiling.counters() == {"decompress.host_fallbacks": 1}


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    stream = api.compress(DATA, "dense", device="cpu")
    assert api.decompress(stream, device="cpu") == DATA
    giant, payload = _giant_literal()
    assert api.decompress(giant, device="cpu") == payload
    with profiling.span("snappy.x"):
        pass


@pytest.mark.parametrize("batch", [2, 128])
def test_compress_counts_the_bytes_copied_back(batch, monkeypatch):
    """B blocks come back as B padded rows and B int32 totals; the stream is
    the totals' sum after its varint."""
    monkeypatch.setattr(api, "DEVICE_BATCH", batch)
    before = profiling.counters()
    stream = api.compress(DATA, "fast", device="cpu")
    after = profiling.counters()
    B = -(-len(DATA) // C.MAX_BLOCK_SIZE)
    assert after["compress.d2h_bytes"] - before.get("compress.d2h_bytes", 0) == B * C.MAX_COMPRESSED_BLOCK_SIZE + 4 * B
    stream_bytes = len(stream) - len(encode_varint(len(DATA)))
    assert after["compress.stream_bytes"] - before.get("compress.stream_bytes", 0) == stream_bytes


def test_reset_counters_and_counters_is_a_copy():
    profiling.count("test.a")
    profiling.count("test.a", 4)
    got = profiling.counters()
    assert got["test.a"] == 5
    got["test.a"] = 0
    assert profiling.counters()["test.a"] == 5
    profiling.reset_counters()
    assert profiling.counters() == {}
    profiling.count("test.b", 2)
    assert profiling.counters() == {"test.b": 2}
    profiling.reset_counters()


def test_a_span_nests_and_closes_on_an_exception():
    def fn():
        with profiling.span("snappy.outer"):
            with profiling.span("snappy.inner"):
                torch.ones(4).add_(1)
            with pytest.raises(ZeroDivisionError):
                with profiling.span("snappy.raises"):
                    1 / 0

    _, events = _profiled(fn)
    outer = _one(events, "snappy.outer")
    assert _children(outer) == ["inner", "raises"]
    assert not torch._C._autograd._profiler_enabled()
