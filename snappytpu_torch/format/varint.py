"""Base-128 varint (LEB128-style) preamble codec.

Every Snappy stream starts with the total uncompressed length encoded 7 bits at
a time, least-significant group first, MSB of each byte = continuation flag.
The reference implements this in its src/varint.c:12-58 (with a
signed-char mask quirk that works by sign extension, and a 2 GiB accumulator
overflow); here the intent is written explicitly and the full 64-bit range is
supported and validated.
"""

from __future__ import annotations


_MAX_VARINT64_LEN = 10


def encode_varint(n: int) -> bytes:
    """Encode a non-negative integer as a base-128 varint."""
    if n < 0:
        raise ValueError("varint cannot encode negative values")
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def decode_varint(buf, pos: int = 0) -> tuple[int, int]:
    """Decode a varint from buf starting at pos.

    Returns (value, next_pos).  Raises ValueError on truncated or overlong
    (>10 byte) input.
    """
    result = 0
    shift = 0
    p = pos
    n = len(buf)
    while True:
        if p >= n:
            raise ValueError("truncated varint")
        if p - pos >= _MAX_VARINT64_LEN:
            raise ValueError("varint too long")
        b = int(buf[p])  # int() guards against numpy uint8 shift overflow
        result |= (b & 0x7F) << shift
        p += 1
        if not (b & 0x80):
            return result, p
        shift += 7


def varint_len(n: int) -> int:
    """Encoded length in bytes of n as a varint."""
    if n < 0:
        raise ValueError("varint cannot encode negative values")
    length = 1
    while n >= 0x80:
        n >>= 7
        length += 1
    return length
