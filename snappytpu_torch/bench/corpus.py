"""Deterministic test/bench corpora.

Mirrors the reference's fixture design (snappy_test.c:8-13: empty, constant
bytes, incompressible random, English-like text, binary image) plus its
500 B..1 MB size sweep (snappy_test.c:7, :93-104).  The reference's fixture
files are not checked in anywhere (snappy_test.c:85-87), so we generate
equivalents deterministically.  The port's copy of snappytpu/bench/corpus.py,
byte for byte in every generator; the loaders of the reference checkout's
files (silesia_standin, reference_files) are left out, as the port has no
use for them.
"""

from __future__ import annotations

import numpy as np

_WORDS = (
    "the quick brown fox jumps over a lazy dog while compression ratios "
    "improve with repeated phrases and structured markup like <html> <body> "
    "<div class=main> because back references capture redundancy in text "
    "streams processed block by block on tensor processing units "
).split()


def constant(size: int, byte: int = 0xFF) -> bytes:
    return bytes([byte]) * size


def random_bytes(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def text(size: int, seed: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    while total < size:
        w = _WORDS[int(rng.integers(0, len(_WORDS)))]
        parts.append(w)
        total += len(w) + 1
    return (" ".join(parts)).encode()[:size]


def structured_binary(size: int, seed: int = 2) -> bytes:
    """Record-like binary: repeated 64-byte records with noisy fields —
    stands in for the reference's immagine.tiff fixture."""
    rng = np.random.default_rng(seed)
    record = rng.integers(0, 256, 64, dtype=np.uint8)
    n_rec = size // 64 + 1
    recs = np.tile(record, n_rec)
    noise_idx = rng.integers(0, recs.size, max(recs.size // 37, 1))
    recs[noise_idx] = rng.integers(0, 256, noise_idx.size, dtype=np.uint8)
    return recs.tobytes()[:size]


def low_entropy(size: int, seed: int = 3) -> bytes:
    """Long runs of few symbols — stresses overlapping-copy decode."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < size:
        out += bytes([int(rng.integers(0, 4))]) * int(rng.integers(1, 512))
    return bytes(out[:size])


def mixed(size: int, seed: int = 4) -> bytes:
    """Interleaved text/binary/low-entropy segments — the 10 GB synthetic
    corpus shape from BASELINE.json config 5, at any size."""
    rng = np.random.default_rng(seed)
    gens = [text, structured_binary, low_entropy, random_bytes]
    out = bytearray()
    i = 0
    while len(out) < size:
        g = gens[int(rng.integers(0, len(gens)))]
        out += g(int(rng.integers(4096, 65536)), seed=seed + i)
        i += 1
    return bytes(out[:size])


def edge_case_corpus() -> dict[str, bytes]:
    """The reference's snappy_test fixture set, regenerated."""
    return {
        "empty": b"",
        "one_byte": b"A",
        "three_bytes": b"abc",
        "32k_ff": constant(32 * 1024, 0xFF),
        "ff_ff_ff": constant(3, 0xFF),
        "32k_random": random_bytes(32 * 1024),
        "alice_like_text": text(150 * 1024),
        "binary_image_like": structured_binary(96 * 1024),
        "low_entropy_runs": low_entropy(80 * 1024),
        "block_boundary_64k": text(65536),
        "block_boundary_64k_plus_1": text(65537),
        "block_boundary_64k_minus_1": text(65535),
        "two_blocks_mixed": mixed(130 * 1024),
    }


def size_sweep(seed: int = 0) -> dict[str, bytes]:
    """The reference's 500 B .. 1 MB size grid (snappy_test.c:7)."""
    sizes = [500, 1000, 5000, 10000, 50000, 100000, 500000, 1000000]
    return {f"mixed_{s}": mixed(s, seed=seed + s) for s in sizes}
