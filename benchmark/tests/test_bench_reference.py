"""The reference decoder against a plain loop decoder and the port's API."""

import random

import numpy as np
import pytest
import torch

from benchmark import datagen, reference
from snappytpu_torch import api
from snappytpu_torch.model.decode import CorruptError
from snappytpu_torch.cpu import NativeError


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decode_loop(data: bytes) -> bytes:
    """The plain sequential decoder, one op at a time."""
    n, i = reference.read_preamble(data)
    out = bytearray()
    while i < len(data):
        tag, kind = data[i], data[i] & 3
        if kind == 0:
            length = tag >> 2
            if length < 60:
                length, i = length + 1, i + 1
            else:
                nb = length - 59
                if i + 1 + nb > len(data):
                    raise reference.Rejected("truncated literal length")
                length, i = int.from_bytes(data[i + 1 : i + 1 + nb], "little") + 1, i + 1 + nb
            if i + length > len(data):
                raise reference.Rejected("truncated literal")
            out += data[i : i + length]
            i += length
            continue
        size = (2, 3, 5)[kind - 1]
        if i + size > len(data):
            raise reference.Rejected("truncated copy")
        if kind == 1:
            length, offset = ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | data[i + 1]
        else:
            length, offset = (tag >> 2) + 1, int.from_bytes(data[i + 1 : i + size], "little")
        i += size
        if offset == 0 or offset > len(out):
            raise reference.Rejected("bad offset")
        for _ in range(length):
            out.append(out[-offset])
    if len(out) != n:
        raise reference.Rejected("length")
    return bytes(out)


def literal(data: bytes, extra: int | None = None) -> bytes:
    n = len(data) - 1
    if extra is None:
        extra = 0 if n < 60 else (n.bit_length() + 7) // 8
    if extra == 0:
        return bytes([n << 2]) + data
    return bytes([(59 + extra) << 2]) + n.to_bytes(extra, "little") + data


def copy(length: int, offset: int, kind: int) -> bytes:
    if kind == 1:
        return bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF])
    return bytes([kind | ((length - 1) << 2)]) + offset.to_bytes(2 if kind == 2 else 4, "little")


def random_stream(rng: random.Random, ops: int) -> tuple[bytes, bytes]:
    """(stream, its output) of random literals (every length form) and
    copies (every kind, overlapping ones among them)."""
    out, body = bytearray(), bytearray()
    for _ in range(ops):
        if not out or rng.random() < 0.35:
            n = rng.choice([1, 5, 59, 60, 61, 300, 70000])
            data = bytes(rng.randrange(256) for _ in range(n)) if n < 1000 else bytes(rng.randrange(4) for _ in range(n))
            body += literal(data, rng.choice([None, None, 3, 4]) if n > 60 else None)
            out += data
            continue
        kind = rng.choice([1, 2, 3])
        length = rng.randint(4, 11) if kind == 1 else rng.randint(1, 64)
        offset = rng.randint(1, min(len(out), (2047, 65535, 70000)[kind - 1]))
        body += copy(length, offset, kind)
        for _ in range(length):
            out.append(out[-offset])
    return varint(len(out)) + bytes(body), bytes(out)


@pytest.mark.parametrize("seed", range(8))
def test_random_streams_against_the_loop_decoder(seed):
    stream, want = random_stream(random.Random(seed), 60)
    assert decode_loop(stream) == want
    assert bytes(reference.decode(stream, "cpu").numpy()) == want


def test_empty_stream():
    assert reference.decode(b"\x00", "cpu").numel() == 0
    with pytest.raises(reference.Rejected):
        reference.decode(b"\x00\x00", "cpu")


BAD = {
    "truncated": lambda s: s[:-1],
    "trailing": lambda s: s + b"\x00a",
    "short_preamble": lambda s: varint(reference.read_preamble(s)[0] - 1) + s[reference.read_preamble(s)[1]:],
    "long_preamble": lambda s: varint(reference.read_preamble(s)[0] + 1) + s[reference.read_preamble(s)[1]:],
    "offset_0": lambda s: s + copy(4, 0, 2),
    "offset_too_far": lambda s: s + copy(4, 1 << 30, 3),
    "varint_6_bytes": lambda s: b"\x80\x80\x80\x80\x80\x01" + s[1:],
}


@pytest.mark.parametrize("fault", sorted(BAD))
def test_malformed_streams_are_rejected(fault):
    stream, _ = random_stream(random.Random(99), 20)
    bad = BAD[fault](stream)
    if fault in ("offset_0", "offset_too_far"):  # appended ops: the preamble has to count them
        n, head = reference.read_preamble(stream)
        bad = varint(n + 4) + bad[head:]
    with pytest.raises(reference.Rejected):
        decode_loop(bad)
    with pytest.raises(reference.Rejected):
        reference.decode(bad, "cpu")


@pytest.mark.parametrize("match_proba,profile", [(0.5, "fast"), (0.5, "dense"), (0.9, "fast"), (0.1, "dense")])
def test_agrees_with_the_port_on_its_streams(match_proba, profile):
    g = datagen._generator(5, "cpu")
    data = datagen.rdg(100_000, g, "cpu", match_proba).numpy()
    stream = api.compress(data, profile, device="cpu")
    got = reference.decode(stream, "cpu")
    assert torch.equal(got, torch.from_numpy(data))
    assert bytes(got.numpy()) == api.decompress(stream, device="cpu") == decode_loop(stream)


@pytest.mark.parametrize("seed", range(6))
def test_agrees_with_the_port_on_mutated_streams(seed):
    """A byte of a port stream changed: both reject it, or both decode it alike."""
    rng = np.random.default_rng(seed)
    g = datagen._generator(seed, "cpu")
    data = datagen.rdg(150_000, g, "cpu").numpy()
    stream = bytearray(api.compress(data, "fast", device="cpu"))
    k = int(rng.integers(3, len(stream)))
    stream[k] ^= int(rng.integers(1, 256))
    try:
        theirs = api.decompress(bytes(stream), device="cpu")
    except (CorruptError, NativeError):
        theirs = None
    try:
        ours = bytes(reference.decode(bytes(stream), "cpu").numpy())
    except reference.Rejected:
        ours = None
    assert ours == theirs
