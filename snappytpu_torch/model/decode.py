"""Numpy model decoder — sequential executable spec of the Snappy element
stream, accepting anything the reference decoder accepts
(its src/snappy_decompression.c:290-333), including COPY4 ops that
no <=64 KiB-block encoder emits, and overlapping copies (offset < length)
with byte-forward replication semantics (snappy_decompression.c:273-280).

Unlike the reference, malformed input is *rejected deterministically*
(the reference's one plausibility check is dead code,
snappy_decompression.c:262): bad offsets, truncated ops, and length overruns
raise CorruptError instead of reading garbage.
"""

from __future__ import annotations

import numpy as np

from ..format import constants as C
from ..format.varint import decode_varint


class CorruptError(ValueError):
    """Raised on malformed Snappy input."""


def parse_op(comp: np.ndarray, p: int):
    """Parse one op at byte offset p.

    Returns (kind, out_len, payload, next_p) where payload is the literal
    source offset for literals and the copy offset for copies.
    """
    n = comp.shape[0]
    tag = int(comp[p])
    kind = tag & 3
    if kind == C.TAG_LITERAL:
        code = tag >> 2
        if code < C.LITERAL_CODE_1BYTE:
            length = code + 1
            hdr = 1
        else:
            nbytes = code - C.LITERAL_CODE_1BYTE + 1  # 1..4 extra bytes
            if p + nbytes >= n:
                raise CorruptError("truncated literal length")
            length = int.from_bytes(comp[p + 1 : p + 1 + nbytes].tobytes(), "little") + 1
            hdr = 1 + nbytes
        if p + hdr + length > n:
            raise CorruptError("literal overruns input")
        return ("lit", length, p + hdr, p + hdr + length)
    if kind == C.TAG_COPY1:
        if p + 1 >= n:
            raise CorruptError("truncated copy1")
        length = ((tag >> 2) & 0x7) + 4
        offset = ((tag >> 5) << 8) | int(comp[p + 1])
        return ("copy", length, offset, p + 2)
    if kind == C.TAG_COPY2:
        if p + 2 >= n:
            raise CorruptError("truncated copy2")
        length = (tag >> 2) + 1
        offset = int.from_bytes(comp[p + 1 : p + 3].tobytes(), "little")
        return ("copy", length, offset, p + 3)
    # COPY4
    if p + 4 >= n:
        raise CorruptError("truncated copy4")
    length = (tag >> 2) + 1
    offset = int.from_bytes(comp[p + 1 : p + 5].tobytes(), "little")
    return ("copy", length, offset, p + 5)


def decode_ops(comp: np.ndarray, out_len: int) -> np.ndarray:
    """Decode an element stream (no preamble) to exactly out_len bytes."""
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    out = np.zeros(out_len, dtype=np.uint8)
    p = 0
    w = 0  # write cursor
    n = comp.shape[0]
    while w < out_len:
        if p >= n:
            raise CorruptError("stream ended before output complete")
        kind, length, payload, p = parse_op(comp, p)
        if w + length > out_len:
            raise CorruptError("op overruns declared output length")
        if kind == "lit":
            out[w : w + length] = comp[payload : payload + length]
        else:
            offset = payload
            if offset == 0 or offset > w:
                raise CorruptError("copy offset out of range")
            # byte-forward copy: overlapping ranges replicate
            for j in range(length):
                out[w + j] = out[w + j - offset]
        w += length
    if p != n:
        raise CorruptError("trailing garbage after output complete")
    return out


def decompress(data: bytes | np.ndarray) -> bytes:
    """Full stream decode: varint preamble + ops."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    if arr.size == 0:
        # the reference emits a zero-byte stream for empty input (its varint
        # writer emits nothing for n=0, varint.c:12-20); accept it as empty
        return b""
    out_len, start = decode_varint(arr)
    return decode_ops(arr[start:], out_len).tobytes()
