"""Parquet-style page reads through the port's `api.decompress` (device
"cpu"): pages of zstd's synthetic sample from both profiles and from the
native C codec, held against the JAX package's decoder; and, held against
the benchmark's plain-torch decoder (`benchmark/reference.py`, which
imports nothing of the program) since the JAX package rejects them, valid
streams whose copies reach back across the 64 KiB grid (which the block
route cannot decode alone and hands to the windowed route), their
malformed mutations, and the route's counters; on each block route: K5 on
host tapes, K2 after the Python split, and K2 after the native split (the
route of a CUDA device)."""

import functools

import numpy as np
import pytest
import torch

from benchmark import datagen, reference
from snappytpu import api as jax_api
from snappytpu_torch import api, cpu, profiling
from snappytpu_torch.format import constants as C
from snappytpu_torch.format.varint import encode_varint
from snappytpu_torch.kernels import decode_tape
from snappytpu_torch.model.decode import CorruptError

BS = C.MAX_BLOCK_SIZE
KiB = 1024

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side


@functools.cache
def page(n: int, seed: int = 7) -> bytes:
    """n bytes of `rdg` at compressibility 50 %, as the benchmark's pages."""
    return datagen.rdg(n, datagen._generator(seed, "cpu"), "cpu").numpy().tobytes()


@functools.cache
def port_stream(n: int, profile: str) -> bytes:
    return api.compress(page(n), profile, device="cpu")


def ops_of(stream: bytes) -> bytes:
    _, head = reference.read_preamble(stream)
    return stream[head:]


def literal(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    extra = (n.bit_length() + 7) // 8
    return bytes([(59 + extra) << 2]) + n.to_bytes(extra, "little") + data


def copy(length: int, offset: int, kind: int) -> bytes:
    if kind == 1:
        return bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF])
    return bytes([kind | ((length - 1) << 2)]) + offset.to_bytes(2 if kind == 2 else 4, "little")


def cross_grid(kind: int, offset: int, length: int, head_blocks: int = 1, tail: int = BS // 2):
    """(stream, output): `head_blocks` whole blocks of the port's fast stream,
    then a copy opening the next block and reaching `offset` back, across the
    grid, then literals, so that every op still ends inside its block."""
    head = page(head_blocks * BS)
    rest = page(BS - length + tail, seed=11)
    out = bytearray(head)
    for _ in range(length):
        out.append(out[-offset] if 0 < offset <= len(out) else 0)  # a malformed copy's bytes are never read
    out += rest
    body = ops_of(port_stream(head_blocks * BS, "fast")) + copy(length, offset, kind)
    cuts = [0, *range(BS - length, len(rest), BS), len(rest)]  # literals that end at the grid
    body += b"".join(literal(rest[a:b]) for a, b in zip(cuts, cuts[1:]))
    return encode_varint(len(out)) + body, bytes(out)


def reference_decode(stream: bytes):
    try:
        return bytes(reference.decode(stream, "cpu").numpy())
    except reference.Rejected:
        return None


def port_decode(stream: bytes):
    try:
        return api.decompress(stream, device="cpu")
    except CorruptError:
        return None


def counted(fn):
    """(fn(), the decompress counters it moved)."""
    profiling.reset_counters()
    out = fn()
    return out, {k: v for k, v in profiling.counters().items() if k.startswith("decompress.")}


@pytest.fixture(params=["tape", "K2", "native+K2"])
def route(request, monkeypatch):
    """The block route: K5 on host tapes (native runtime), K2 without the
    native runtime, or the native scan and split, then K2 (a CUDA device's
    route, forced here on the CPU device)."""
    if request.param != "K2" and not cpu.available:
        pytest.skip("the native scan and split need the port's native runtime")
    if request.param == "K2":
        monkeypatch.setattr(cpu, "available", False)
    if request.param == "native+K2":
        monkeypatch.setattr(api, "parses_on_card", lambda device: True)
    return request.param


def k2_calls(route: str, calls: int) -> dict:
    """The counter of the block-route calls K2 parsed, where `route` parses with K2."""
    return {} if route == "tape" else {"decompress.k2_calls": calls}


@pytest.mark.parametrize("profile", ["fast", "dense"])
@pytest.mark.parametrize("size", [64 * KiB, 256 * KiB, 1024 * KiB])
def test_port_pages_equal_the_jax_package(size, profile):
    stream = port_stream(size, profile)
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == jax_api.decompress(stream) == page(size)
    assert counts == {"decompress.device_calls": 1, "decompress.blocks": size // BS}


@pytest.mark.parametrize("profile", ["fast", "dense"])
def test_a_page_on_every_block_route_equals_the_jax_package(profile, route):
    stream = port_stream(1024 * KiB, profile)
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == jax_api.decompress(stream) == page(1024 * KiB)
    assert counts == {"decompress.device_calls": 1, "decompress.blocks": 16, **k2_calls(route, 1)}


def test_a_block_whose_tape_overflows(route, monkeypatch):
    """A last block of 24,000 one-byte literals needs more records than
    TAPE_MAX: build_tapes says -9, and K5's route hands that block to
    K2; the K2 routes parse it with the rest."""
    tail = page(24_000, seed=13)
    stream = (encode_varint(BS + len(tail)) + ops_of(port_stream(BS, "fast"))
              + b"".join(literal(bytes([x])) for x in tail))
    if route != "K2":  # build_tapes is the native runtime's
        rows = np.zeros((1, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)
        rows[0, : 2 * len(tail)] = np.frombuffer(stream[-2 * len(tail):], np.uint8)
        lens = np.array([2 * len(tail)], np.int32), np.array([len(tail)], np.int32)
        assert decode_tape.build_tapes(rows, *lens)[1].tolist() == [-9]
    fallbacks = []
    real = decode_tape.decode_blocks_vm
    monkeypatch.setattr(decode_tape, "decode_blocks_vm", lambda *a: fallbacks.append(a[0].shape[0]) or real(*a))
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == reference_decode(stream) == page(BS) + tail
    assert fallbacks == ([1] if route == "tape" else [])
    assert counts == {"decompress.device_calls": 1, "decompress.blocks": 2, **k2_calls(route, 1)}


@pytest.mark.parametrize("size", [64 * KiB, 256 * KiB + 5, 1024 * KiB])
def test_pages_of_the_native_codec_equal_the_jax_package(size):
    """Another writer's pages: the native C codec's streams."""
    if not cpu.available:
        pytest.skip("the native C codec is the port's native runtime")
    data = page(size, seed=23)
    stream = cpu.compress(data)
    assert port_decode(stream) == jax_api.decompress(stream) == data


@pytest.mark.parametrize("kind,offset,length", [
    (1, 1, 4),          # one byte back, the smallest reach over the grid
    (1, 2047, 11),      # the farthest 2-byte copy
    (2, 40_000, 64),
    (2, 65_535, 33),    # the farthest 3-byte copy, into block 0's first bytes
    (3, 65_536, 17),    # a 5-byte copy reaching to block 0's first byte
])
def test_a_copy_across_the_grid_decodes_through_the_windowed_route(kind, offset, length, route):
    stream, want = cross_grid(kind, offset, length)
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == reference_decode(stream) == want
    assert counts == {"decompress.device_calls": 1, "decompress.blocks": 3, "decompress.reroutes": 1,
                      "decompress.windowed_calls": 1, **k2_calls(route, 1)}


def test_a_copy_across_the_grid_in_a_later_device_call(monkeypatch):
    """The bad block in the second call of 2 blocks: the whole stream is
    decoded again, once, whatever the first call decoded."""
    monkeypatch.setattr(api, "DEVICE_BATCH", 2)
    stream, want = cross_grid(2, 500, 40, head_blocks=2)
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == reference_decode(stream) == want
    assert counts == {"decompress.device_calls": 2, "decompress.blocks": 4, "decompress.reroutes": 1,
                      "decompress.windowed_calls": 1}


MALFORMED = {
    "before_the_start": lambda: cross_grid(3, BS + 1, 8),  # reaches one byte before the output's first
    "offset_0": lambda: cross_grid(2, 0, 8),
    "far_before_the_start": lambda: cross_grid(3, 1 << 30, 8),
}


@pytest.mark.parametrize("fault", sorted(MALFORMED))
def test_malformed_cross_grid_streams_are_rejected(fault, route):
    """Rerouted, refused by the windowed route, and rejected by the host
    decoder with CorruptError, as the reference rejects them."""
    stream, _ = MALFORMED[fault]()
    assert reference_decode(stream) is None
    profiling.reset_counters()
    with pytest.raises(CorruptError):
        api.decompress(stream, device="cpu")
    counts = profiling.counters()
    assert counts["decompress.reroutes"] == counts["decompress.host_fallbacks"] == 1


@pytest.mark.parametrize("seed", range(6))
def test_mutated_pages_agree_with_the_reference(seed):
    """A byte of a page's stream changed: both reject it, or both decode it alike."""
    rng = np.random.default_rng(100 + seed)
    stream = bytearray(port_stream(256 * KiB, "fast"))
    k = int(rng.integers(3, len(stream)))
    stream[k] ^= int(rng.integers(1, 256))
    assert port_decode(bytes(stream)) == reference_decode(bytes(stream))


def test_an_unaligned_page_counts_only_the_windowed_call():
    """Ops straddling the grid from the start: the windowed route, no block call."""
    data = page(200_000)
    tail = api.compress(data[3:], "fast", device="cpu")
    stream = encode_varint(len(data)) + literal(data[:3]) + ops_of(tail)
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == reference_decode(stream) == data
    assert counts == {"decompress.windowed_calls": 1}


def test_a_giant_literal_counts_only_the_host_fallback():
    data = page(70_000)
    stream = encode_varint(len(data)) + literal(data)
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == reference_decode(stream) == data
    assert counts == {"decompress.host_fallbacks": 1}


def test_blocks_per_call_over_many_calls(monkeypatch, route):
    """Calls of at most DEVICE_BATCH blocks: 5 blocks in calls of 2 count 3 calls and 5 blocks."""
    monkeypatch.setattr(api, "DEVICE_BATCH", 2)
    stream = port_stream(5 * BS - 100, "fast")
    got, counts = counted(lambda: api.decompress(stream, device="cpu"))
    assert got == page(5 * BS - 100)
    assert counts == {"decompress.device_calls": 3, "decompress.blocks": 5, **k2_calls(route, 3)}

