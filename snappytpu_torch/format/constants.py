"""Snappy wire-format constants — the single source of truth.

This module defines the raw Snappy block format as implemented by the reference
C codec (see its src/snappy_compression.c:95-165 for tag emission and
src/snappy_decompression.c:290-333 for tag dispatch) and by
google/snappy's public format description.  Every other layer (numpy model codec,
JAX/Pallas kernels, C++ host codec, tests) imports these constants instead of
re-deriving magic numbers.

Format summary (element stream, after the varint preamble):

  tag byte low 2 bits select the op:
    00  LITERAL:  len-1 in the upper 6 bits if len <= 60; codes 60/61/62/63
        mean 1/2/3/4 little-endian extra bytes holding len-1.
    01  COPY1:    len 4..11 (len-4 in bits 2..4), 11-bit offset (bits 5..7 of
        the tag are offset bits 8..10; one extra byte holds offset bits 0..7).
    10  COPY2:    len 1..64 (len-1 in upper 6 bits), 2-byte LE offset.
    11  COPY4:    len 1..64 (len-1 in upper 6 bits), 4-byte LE offset.
        (Never emitted by encoders with <=64 KiB blocks; decoders accept it —
        reference: snappy_compression.c:141, snappy_decompression.c:323-327.)
"""

# --- op tags (low 2 bits of the tag byte) ------------------------------------
TAG_LITERAL = 0
TAG_COPY1 = 1
TAG_COPY2 = 2
TAG_COPY4 = 3

# --- literal encoding ---------------------------------------------------------
# Inline literal lengths are 1..61 encoded as len-1 in 6 bits (0..60);
# codes 60..63 instead announce 1..4 extra length bytes.
LITERAL_MAX_INLINE_LEN = 60  # len <= 60 -> single tag byte
LITERAL_CODE_1BYTE = 60
LITERAL_CODE_2BYTE = 61
LITERAL_CODE_3BYTE = 62
LITERAL_CODE_4BYTE = 63

# --- copy encoding ------------------------------------------------------------
MIN_MATCH_LEN = 4          # shortest emittable copy
MAX_COPY_LEN = 64          # longest single copy op; longer matches are split
COPY1_MIN_LEN = 4
COPY1_MAX_LEN = 11
COPY1_MAX_OFFSET = 1 << 11  # 2048: offset must fit in 11 bits
COPY2_MAX_OFFSET = 1 << 16  # 65536: offset must fit in 16 bits

# --- block structure ----------------------------------------------------------
# The unit of independent (parallel) work.  Matches never cross a block
# boundary and all per-block state resets between blocks
# (reference: snappy_compression.c:9, :419-425), which is the property the TPU
# build exploits for data parallelism.
MAX_BLOCK_SIZE = 65536

# Worst-case compressed size of one block as produced by *our* encoders:
# a single all-literal run costs 3 header bytes + 65536 payload bytes; greedy
# parses with copies are never larger than literal coverage + per-op headers.
# We keep a generous, lane-aligned margin (the reference used 66551,
# snappy_compression.c:190).
MAX_COMPRESSED_BLOCK_SIZE = MAX_BLOCK_SIZE + 8192  # 73728, multiple of 512

# Longest varint preamble we accept (5 bytes covers uint32 lengths; the
# reference's decoder silently overflows past 2 GiB — varint.c:32-38 — we
# instead support the full range and validate).
MAX_PREAMBLE_LEN = 5


def literal_header_len(run_len: int) -> int:
    """Bytes of literal header (tag + extra length bytes) for a run of run_len."""
    if run_len <= LITERAL_MAX_INLINE_LEN:
        return 1
    n = run_len - 1
    if n < (1 << 8):
        return 2
    if n < (1 << 16):
        return 3
    if n < (1 << 24):
        return 4
    return 5


def copy_op_len(length: int, offset: int) -> int:
    """Encoded size in bytes of a single copy op."""
    if COPY1_MIN_LEN <= length <= COPY1_MAX_LEN and offset < COPY1_MAX_OFFSET:
        return 2
    return 3  # COPY2; COPY4 (5 bytes) is never emitted for <=64 KiB blocks
