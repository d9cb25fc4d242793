"""The port's user API (device="cpu") against snappytpu.api: identical
streams for both profiles, round trips, and the decode ladder's verdicts."""

import functools
import glob
import os

import numpy as np
import pytest
import torch

from snappytpu import api as jax_api
from snappytpu.bench import corpus
from snappytpu.format.varint import encode_varint
from snappytpu.stream import framing
from snappytpu_torch import api, cpu
from snappytpu_torch.format import constants as C
from snappytpu_torch.model.decode import CorruptError  # the port's own: api raises it

DATA = {
    "mixed100k": corpus.mixed(100_000, seed=3),
    "text_5": b"hello",
    "runs_70k": corpus.low_entropy(70_000, seed=9),
}


@functools.cache
def _compressed(name, profile):
    return api.compress(DATA[name], profile, device="cpu")


@pytest.mark.parametrize("profile", ["dense", "fast"])
@pytest.mark.parametrize("name", sorted(DATA))
def test_compress_equals_jax(name, profile):
    assert _compressed(name, profile) == jax_api.compress(DATA[name], profile)


@pytest.mark.parametrize("profile", ["dense", "fast"])
@pytest.mark.parametrize("name", sorted(DATA))
def test_round_trip(name, profile):
    assert api.decompress(_compressed(name, profile), device="cpu") == DATA[name]


def test_empty():
    assert api.compress(b"", device="cpu") == encode_varint(0)
    assert api.decompress(encode_varint(0), device="cpu") == b""
    with pytest.raises(CorruptError):
        api.decompress(encode_varint(0) + b"\x00", device="cpu")


def test_golden_streams_decode():
    golden = os.path.join(os.path.dirname(__file__), "golden")
    for path in sorted(glob.glob(os.path.join(golden, "*.snappy"))):
        with open(path, "rb") as f:
            comp = f.read()
        with open(path[: -len(".snappy")] + ".raw", "rb") as f:
            assert api.decompress(comp, device="cpu") == f.read(), path


def test_corrupt_stream_raises():
    # block-splittable, but the copy reaches before the start of its block
    stream = encode_varint(8) + bytes([3 << 2]) + b"abcd" + bytes([(3 << 2) | 2, 9, 0])
    with pytest.raises(CorruptError):
        api.decompress(stream, device="cpu")


def test_unaligned_valid_stream_needs_the_windowed_decoder(monkeypatch):
    """A short literal phase-shifts an encoded tail so that its ops straddle
    the 64 KiB output grid (as in tests/test_fuzz_decode.py): the stream
    decodes to its data through the windowed decoder K4 (plain version)."""
    data = corpus.mixed(100_000, seed=4)
    shift = 7
    tail = np.frombuffer(api.compress(data[shift:], "fast", device="cpu"), np.uint8)
    _, start = framing.read_preamble(tail)
    stream = encode_varint(len(data)) + bytes([(shift - 1) << 2]) + data[:shift] + tail[start:].tobytes()
    calls = []
    real = api.decode_stream_vm
    monkeypatch.setattr(api, "decode_stream_vm", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    monkeypatch.setattr(api, "host_fallbacks", 0)
    assert api.decompress(stream, device="cpu") == data == jax_api.decompress(stream)
    assert calls == [2] and api.host_fallbacks == 0


def test_giant_literal_goes_to_the_host_decoder(monkeypatch):
    """A single op wider than a window: the JAX package's own route (the
    native sequential decoder, or the model decoder without it)."""
    payload = corpus.random_bytes(70_000, seed=2)
    n = len(payload) - 1
    stream = encode_varint(len(payload)) + bytes([62 << 2]) + n.to_bytes(3, "little") + payload
    monkeypatch.setattr(api, "host_fallbacks", 0)
    assert api.decompress(stream, device="cpu") == payload
    assert api.host_fallbacks == 1


def test_capacity_poison_raises(monkeypatch):
    def poisoned(blocks, lens, profile="dense"):
        comp, totals = real(blocks, lens, profile)
        totals[0] = -1
        return comp, totals

    real = api.encode_blocks
    monkeypatch.setattr(api, "encode_blocks", poisoned)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        api.compress(DATA["text_5"], device="cpu")


def test_encode_rows_batches_and_names_poisoned_blocks(monkeypatch):
    """api.encode_rows, the one batched encode of the api, the manifests'
    default encoder and (through launch/fetch_batches) the mesh: calls of at
    most 128 blocks in block order; a poisoned total raises CapacityError,
    which is the RuntimeError of the JAX api and the ValueError of its mesh,
    naming the block as first + its index."""
    calls = []

    def fake(b, n, profile="dense"):
        calls.append((b.shape[0], int(n[0]), profile))
        comp = torch.zeros((b.shape[0], C.MAX_COMPRESSED_BLOCK_SIZE), dtype=torch.uint8)
        comp[:, 0] = (n % 251).to(torch.uint8)
        return comp, torch.where(n == 290, -1, n)

    monkeypatch.setattr(api, "encode_blocks", fake)
    lens = np.arange(300, dtype=np.int32)
    comp, totals = api.encode_rows(np.zeros((280, 8), np.uint8), lens[:280], "fast", device="cpu")
    assert calls == [(128, 0, "fast"), (128, 128, "fast"), (24, 256, "fast")]
    np.testing.assert_array_equal(totals, lens[:280])
    np.testing.assert_array_equal(comp[:, 0], lens[:280] % 251)
    with pytest.raises(api.CapacityError, match=r"block\(s\) \[1290\] exceeded") as e:
        api.encode_rows(np.zeros((300, 8), np.uint8), lens, device="cpu", first=1000)
    assert isinstance(e.value, RuntimeError) and isinstance(e.value, ValueError)


def test_routes_without_the_native_runtime(monkeypatch):
    """Without the port's native runtime (snappytpu_torch.cpu) the block
    route is K2 and the host fallback the model decoder, as in the JAX
    package; the windowed route is unchanged."""

    def refused(*a, **k):
        raise AssertionError("the native runtime was used while unavailable")

    blocks = []
    real = api.decode_blocks
    monkeypatch.setattr(cpu, "available", False)
    monkeypatch.setattr(api, "decode_blocks_tape", refused)
    monkeypatch.setattr(api, "decode_blocks", lambda *a: blocks.append(a[0].shape[0]) or real(*a))
    for name in ("compact", "decompress", "scan_ops", "split_rows"):
        monkeypatch.setattr(cpu, name, refused)
    stream = _compressed("mixed100k", "fast")
    assert api.decompress(stream, device="cpu") == DATA["mixed100k"]
    assert blocks == [2]
    data = corpus.mixed(100_000, seed=4)
    tail = np.frombuffer(api.compress(data[3:], "fast", device="cpu"), np.uint8)
    _, start = framing.read_preamble(tail)
    unaligned = encode_varint(len(data)) + bytes([2 << 2]) + data[:3] + tail[start:].tobytes()
    assert api.decompress(unaligned, device="cpu") == data
    payload = corpus.random_bytes(70_000, seed=2)
    giant = encode_varint(len(payload)) + bytes([62 << 2]) + (len(payload) - 1).to_bytes(3, "little") + payload
    assert api.decompress(giant, device="cpu") == payload
