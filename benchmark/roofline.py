"""The yardstick of the rooflines: the bytes a request needs moved, and the
card's peak bandwidth.

The work of a request depends only on its own bytes, never on how the
program does it, so that fusing, swapping or removing a kernel leaves the
yardstick where it was: its input read once and its output written once,
that is, for compress the object read and the stream written, and for
decompress the stream read and the object written.

The least time is that work over the card's peak HBM bandwidth (NVIDIA's
data sheet, H100 SXM5 80 GB: 3.35 TB/s at the full 700 W power limit).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = {"H100": 3.35e12}


def peak_bytes_per_s(kind: str) -> float:
    """The peak HBM bandwidth of the card named `kind`."""
    for key, peak in PEAK_BYTES_PER_S.items():
        if key in kind:
            return peak
    raise KeyError(f"no peak bandwidth known for {kind!r}")


def request_bytes(op: str, in_bytes: int, out_bytes: int) -> int:
    """Bytes a request of `op` needs moved at the least."""
    if op not in ("compress", "decompress"):
        raise ValueError(f"unknown op {op!r}")
    return in_bytes + out_bytes


def least_seconds(op: str, requests, kind: str) -> float:
    """The least time the card could take for `requests` ((in, out) byte pairs)."""
    return sum(request_bytes(op, i, o) for i, o in requests) / peak_bytes_per_s(kind)
